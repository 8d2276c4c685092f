"""The port's multi-cluster services and ingress, and the admission of the
autoscaling and networking kinds, against the JAX package on the CPU.

- The scenarios of ``tests/test_mcs.py`` and
  ``tests/test_mci_quota_scale.py::TestMultiClusterIngress``, and a
  teardown scenario (the exports, services and ingresses deleted with the
  Works they dispatched), run on both planes through ``run_both``
  (``tests/test_torch_controlplane.py``): after every settle the two planes'
  states (the collected EndpointSlices among the templates, the mcs- and
  mci- Works, every member's Services, EndpointSlices and Ingresses, and the
  ServiceExports, MultiClusterServices and MultiClusterIngresses) must be
  equal, and each scenario's own checks hold on both.
- The FederatedHPA, CronFederatedHPA, MultiClusterService and
  MultiClusterIngress cases of ``tests/test_webhook_extra.py`` and
  ``tests/test_webhook_full_set.py`` through both packages' default
  admission chains: the same refusal with the same message, or the same
  admitted object.
- ``chip_smoke.run_plane``'s networking wave and its teardown on config 4
  at 300 templates x 40 clusters, on both planes through ``run_both``.

Tolerance: exact equality."""

import dataclasses
import itertools
import types
import uuid

import pytest

import chip_smoke
from test_torch_autoscaling import config4_plane
from test_torch_controlplane import (  # noqa: F401 (fixture)
    PKGS,
    _one_torch_thread,
    mod,
    run_both,
)

SLICE_GVK = "discovery.k8s.io/v1/EndpointSlice"
INGRESS_GVK = "networking.k8s.io/v1/Ingress"


def networking(p):
    return mod(p.pkg, "api.networking")


def endpoint_slice(p, name, service, addresses):
    return p.core.Resource(
        api_version="discovery.k8s.io/v1", kind="EndpointSlice",
        meta=p.core.ObjectMeta(name=name, namespace="default",
                               labels={"kubernetes.io/service-name": service}),
        spec={"endpoints": [{"addresses": [a]} for a in addresses]})


def service(p, name, cluster_ip="10.0.0.5"):
    return p.core.Resource(api_version="v1", kind="Service",
                           meta=p.core.ObjectMeta(name=name, namespace="default"),
                           spec={"ports": [{"port": 80}], "clusterIP": cluster_ip})


def mcs(p, name, providers, consumers):
    n = networking(p)
    return n.MultiClusterService(
        meta=p.core.ObjectMeta(name=name, namespace="default"),
        spec=n.MultiClusterServiceSpec(
            provider_clusters=[n.ExposureRange(cluster_names=list(providers))],
            consumer_clusters=[n.ExposureRange(cluster_names=list(consumers))]))


def mci(p, name, backends):
    n = networking(p)
    return n.MultiClusterIngress(
        meta=p.core.ObjectMeta(name=name, namespace="default"),
        spec=n.MultiClusterIngressSpec(rules=[{
            "host": f"{name}.example.com",
            "http": {"paths": [{"path": f"/{b}", "pathType": "Prefix",
                                "backend": {"service": {"name": b}}} for b in backends]}}]))


# --------------------------------------------------------------------------
# tests/test_mcs.py, TestMultiClusterIngress
# --------------------------------------------------------------------------


def slices_collected(p, record):
    cp = p.make_plane(3)
    m1 = cp.members.get("member1")
    m1.apply(service(p, "web"))
    m1.apply(endpoint_slice(p, "web-abc", "web", ["10.1.0.1", "10.1.0.2"]))
    cp.store.apply(networking(p).ServiceExport(
        meta=p.core.ObjectMeta(name="web", namespace="default")))
    cp.settle()
    record(cp)
    collected = cp.store.get("Resource", "default/member1-web-abc")
    assert collected.meta.labels["endpointslice.karmada.io/source-cluster"] == "member1"


def derived_service_dispatched(p, record):
    cp = p.make_plane(3)
    m1 = cp.members.get("member1")
    m1.apply(service(p, "web"))
    m1.apply(endpoint_slice(p, "web-abc", "web", ["10.1.0.1"]))
    cp.store.apply(mcs(p, "web", ["member1"], ["member2"]))
    cp.settle()
    record(cp)
    m2 = cp.members.get("member2")
    derived = m2.get("v1/Service", "default", "derived-web")
    assert derived.spec["ports"] == [{"port": 80}]
    assert m2.get(SLICE_GVK, "default", "member1-web-abc").spec["endpoints"] == [
        {"addresses": ["10.1.0.1"]}]
    assert cp.members.get("member3").get("v1/Service", "default", "derived-web") is None
    assert mod(p.pkg, "controllers.mcs").derived_service_name("web") == "derived-web"


def ingress_dispatched(p, record):
    cp = p.make_plane(3)
    svc = p.core.Resource(api_version="v1", kind="Service",
                          meta=p.core.ObjectMeta(name="web", namespace="default"),
                          spec={"ports": [{"port": 80}]})
    cp.members.get("member1").apply(svc)
    n = networking(p)
    cp.store.apply(n.MultiClusterIngress(
        meta=p.core.ObjectMeta(name="web-ingress", namespace="default"),
        spec=n.MultiClusterIngressSpec(rules=[{
            "host": "web.example.com",
            "http": {"paths": [{"path": "/", "backend": {"service": {"name": "web"}}}]}}])))
    cp.settle()
    record(cp)
    assert cp.members.get("member1").get(INGRESS_GVK, "default", "web-ingress") is not None
    assert cp.members.get("member2").get(INGRESS_GVK, "default", "web-ingress") is None
    assert cp.store.get("MultiClusterIngress", "default/web-ingress").status["clusters"] == [
        "member1"]


def services_ingress_and_teardown(p, record):
    """Two services exported from two providers each, a MultiClusterService
    for each with named consumers, one ingress over both; a slice moves, an
    unreachable provider's slices stay where they were; then everything is
    deleted with the Works the MCS and MCI controllers dispatched (they own
    none: deleting their objects leaves the Works, as in the JAX package)."""
    cp = p.make_plane(5)
    for name, providers, consumers in (("web", ("member1", "member2"), ("member3", "member4")),
                                       ("api", ("member2", "member5"), ("member1", "member3"))):
        for k, c in enumerate(providers):
            m = cp.members.get(c)
            m.apply(service(p, name, f"10.0.{k}.5"))
            m.apply(endpoint_slice(p, f"{name}-{c}", name, [f"10.{k}.0.1", f"10.{k}.0.2"]))
        cp.store.apply(networking(p).ServiceExport(
            meta=p.core.ObjectMeta(name=name, namespace="default")))
        cp.store.apply(mcs(p, name, providers, consumers))
    cp.store.apply(mci(p, "front", ["web", "api"]))
    cp.settle()
    record(cp)
    front = cp.store.get("MultiClusterIngress", "default/front").status["clusters"]
    assert front == ["member1", "member2", "member3", "member4", "member5"]
    assert cp.members.get("member3").get(SLICE_GVK, "default", "member2-api-member2") is not None
    # a provider's slice changes; another provider goes unreachable
    m1 = cp.members.get("member1")
    m1.apply(endpoint_slice(p, "web-member1", "web", ["10.9.9.9"]))
    cp.members.get("member5").reachable = False
    cp.settle()
    record(cp)
    assert cp.members.get("member4").get(SLICE_GVK, "default", "member1-web-member1").spec[
        "endpoints"] == [{"addresses": ["10.9.9.9"]}]
    cp.members.get("member5").reachable = True
    for kind, key in (("ServiceExport", "default/web"), ("ServiceExport", "default/api"),
                      ("MultiClusterService", "default/web"),
                      ("MultiClusterService", "default/api"),
                      ("MultiClusterIngress", "default/front")):
        cp.store.delete(kind, key)
    cp.settle()
    record(cp)
    left = [w.meta.namespaced_name for w in cp.store.list("Work")
            if w.meta.name.startswith(("mcs-", "mci-"))]
    assert left
    assert not [r for r in cp.store.list("Resource") if r.kind == "EndpointSlice"]
    for key in left:
        cp.store.delete("Work", key)
    cp.settle()
    record(cp)
    for name in cp.members.names():
        member = cp.members.get(name)
        assert member.list(INGRESS_GVK) == []
        assert not [s for s in member.list("v1/Service") if s.meta.name.startswith("derived-")]


SCENARIOS = {
    "TestServiceExport-slices-collected": slices_collected,
    "TestMultiClusterService-derived-service": derived_service_dispatched,
    "TestMultiClusterIngress-dispatched": ingress_dispatched,
    "services-ingress-teardown": services_ingress_and_teardown,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_networking_scenario_equals_jax_plane(name, monkeypatch):
    run_both(SCENARIOS[name], monkeypatch)


# --------------------------------------------------------------------------
# admission: tests/test_webhook_extra.py, tests/test_webhook_full_set.py
# --------------------------------------------------------------------------


def _hpa(pkg, **spec):
    a, core = mod(pkg, "api.autoscaling"), mod(pkg, "api.core")
    spec.setdefault("scale_target_ref", a.ScaleTargetRef(name="web"))
    return a.FederatedHPA(meta=core.ObjectMeta(name="h", namespace="default"),
                          spec=a.FederatedHPASpec(**spec))


def _cron(pkg, *rules):
    a, core = mod(pkg, "api.autoscaling"), mod(pkg, "api.core")
    return a.CronFederatedHPA(meta=core.ObjectMeta(name="c", namespace="default"),
                              spec=a.CronFederatedHPASpec(rules=[
                                  a.CronFederatedHPARule(**r) for r in rules]))


def _mcs(pkg, types_=None):
    n, core = mod(pkg, "api.networking"), mod(pkg, "api.core")
    spec = n.MultiClusterServiceSpec() if types_ is None else n.MultiClusterServiceSpec(
        types=types_)
    return n.MultiClusterService(meta=core.ObjectMeta(name="m", namespace="default"), spec=spec)


def _mci(pkg, path, path_type="Prefix", backend="web"):
    n, core = mod(pkg, "api.networking"), mod(pkg, "api.core")
    entry = {"path": path, "backend": {"service": {"name": backend}}}
    if path_type is not None:
        entry["pathType"] = path_type
    return n.MultiClusterIngress(meta=core.ObjectMeta(name="i", namespace="default"),
                                 spec=n.MultiClusterIngressSpec(rules=[
                                     {"http": {"paths": [entry]}}]))


#: case -> (kind, a function that makes the object in a package)
ADMISSION_CASES = {
    "hpa-bounds": ("FederatedHPA", lambda pkg: _hpa(pkg, min_replicas=5, max_replicas=2)),
    "hpa-utilization-range": ("FederatedHPA", lambda pkg: _hpa(pkg, metrics=[
        mod(pkg, "api.autoscaling").MetricSpec(target_average_utilization=250)])),
    "hpa-explicit-zero": ("FederatedHPA", lambda pkg: _hpa(pkg, min_replicas=0, max_replicas=5)),
    "hpa-no-target-name": ("FederatedHPA", lambda pkg: _hpa(
        pkg, scale_target_ref=mod(pkg, "api.autoscaling").ScaleTargetRef(name=""))),
    "hpa-defaults-unset-fields": ("FederatedHPA", lambda pkg: _hpa(
        pkg, min_replicas=None, stabilization_window_seconds=None)),
    "cron-schedule": ("CronFederatedHPA", lambda pkg: _cron(
        pkg, {"name": "r", "schedule": "not a cron", "target_replicas": 1})),
    "cron-schedule-field-range": ("CronFederatedHPA", lambda pkg: _cron(
        pkg, {"name": "r", "schedule": "0 24 * * *", "target_replicas": 1})),
    "cron-rule-needs-target": ("CronFederatedHPA", lambda pkg: _cron(
        pkg, {"name": "r", "schedule": "0 9 * * *"})),
    "cron-unique-rule-names": ("CronFederatedHPA", lambda pkg: _cron(
        pkg, {"name": "r", "schedule": "0 9 * * *", "target_replicas": 1},
        {"name": "r", "schedule": "0 10 * * *", "target_replicas": 2})),
    "cron-valid": ("CronFederatedHPA", lambda pkg: _cron(
        pkg, {"name": "r", "schedule": "*/15 8-18 * * 1-5", "target_min_replicas": 2})),
    "mcs-types": ("MultiClusterService", lambda pkg: _mcs(pkg, ["Teleport"])),
    "mcs-permanent-id": ("MultiClusterService", lambda pkg: _mcs(pkg)),
    "mci-valid-rules": ("MultiClusterIngress", lambda pkg: _mci(pkg, "/api")),
    "mci-bad-path-type": ("MultiClusterIngress", lambda pkg: _mci(pkg, "/x", "Regex")),
    "mci-relative-path": ("MultiClusterIngress", lambda pkg: _mci(pkg, "x")),
    "mci-default-path-type": ("MultiClusterIngress", lambda pkg: _mci(pkg, "x", None)),
    "mci-backend-required": ("MultiClusterIngress", lambda pkg: _mci(pkg, "/x", backend="")),
}


@pytest.mark.parametrize("case", list(ADMISSION_CASES))
def test_admission_equals_jax(case, monkeypatch):
    """One admission case through both packages' default chains (the
    permanent IDs drawn from one counter a package): the same refusal and
    message, or the same admitted object."""
    kind, build = ADMISSION_CASES[case]
    outcomes = []
    for pkg in PKGS:
        counter = itertools.count(1)
        monkeypatch.setattr(mod(pkg, "webhook.chain"), "uuid", types.SimpleNamespace(
            uuid4=lambda: uuid.UUID(int=next(counter))))
        webhook = mod(pkg, "webhook")
        obj = build(pkg)
        try:
            webhook.default_admission_chain().admit(kind, obj)
            outcomes.append(("admitted", dict(obj.meta.labels), dataclasses.asdict(obj.spec)))
        except webhook.ValidationError as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[1] == outcomes[0]


# --------------------------------------------------------------------------
# chip_smoke.run_plane's networking waves on both planes
# --------------------------------------------------------------------------


def config4_networking_waves(p, record):
    """``chip_smoke.plane_autoscale_waves``' networking wave and its teardown
    on config 4 at 300 x 40 (``network_picks``, seed 13): 6 services
    exported from 2-4 of their binding's clusters to 4 named consumers, 3
    ingresses over them; then everything deleted with its Works."""
    cp = config4_plane(p)
    rbs = chip_smoke.sorted_bindings(cp.store)
    names = sorted(cp.members.names())
    providers, consumers, ings = chip_smoke.network_picks(rbs, names, 6, 3, 4)
    chip_smoke.network_objects(p.pkg, cp, providers, consumers, ings)
    cp.settle()
    record(cp)
    assert chip_smoke.network_check(cp, providers, consumers, ings) == (0, 0)
    chip_smoke.network_teardown(cp, providers, ings)
    cp.settle()
    record(cp)
    assert not [o for n in names for o in cp.members.get(n).list()
                if o.kind in ("Service", "EndpointSlice", "Ingress")]


def test_config4_networking_waves_equal_jax_plane(monkeypatch):
    run_both(config4_networking_waves, monkeypatch)
