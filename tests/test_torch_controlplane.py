"""The port's control plane against the JAX plane on the CPU.

``karmada_tpu_torch.controlplane.ControlPlane(device="cpu")`` and
``karmada_tpu.controlplane.ControlPlane`` take the same objects under one
injected clock, the admission chain's ``uuid.uuid4`` (the permanent IDs it
stamps) replaced by one counter for each run. After every settle the two
planes' states are compared: every ResourceBinding and
ClusterResourceBinding (labels, generation, ``spec.clusters``, conditions,
aggregated status, the observed affinity, graceful-eviction tasks, RequiredBy
snapshots, the reschedule trigger and last schedule time), every Work (name,
namespace, labels, its manifests through ``work_manifests``, its template
reference, flags, conditions and manifest statuses), every member's objects
(gvk, namespace, name, labels, annotations, spec, status), the templates
(labels, spec, status), the Clusters (labels, annotations, taints, status),
the policies' permanent IDs, the Leases, the WorkloadRebalancers' and the
FederatedResourceQuotas' status, and the FederatedHPAs, CronFederatedHPAs,
ServiceExports, MultiClusterServices and MultiClusterIngresses (labels,
spec and status). Condition times, uids and creation stamps
come from the wall clock and per-package counters and are left out.
Tolerance: exact equality.

The scenarios are those of ``tests/test_e2e_propagation.py`` that the
propagation path covers, each run on both planes with the same checks; then
BASELINE config 4 at 60 clusters and 400 templates (``chip_smoke.
plane_objects``: at least ``fleet_threshold`` bindings, so the fleet route
runs) through join, cold, status, scale and delete waves and the failover,
eviction drain, descheduler and recovery waves, in both render modes; then
a CPU rehearsal of ``chip_smoke.run_plane``. The failover, extras and Pull
scenarios are in ``test_torch_failover.py``, ``test_torch_plane_extras.py``
and ``test_torch_pull.py``, on ``run_both`` from here."""

import copy
import dataclasses
import importlib
import itertools
import types
import uuid

import pytest
import torch

import karmada_tpu
import karmada_tpu.controlplane  # noqa: F401
import karmada_tpu_torch
import karmada_tpu_torch.controlplane  # noqa: F401

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)
DELTA_ENV = "KARMADA_TPU_BUS_TEMPLATE_DELTA"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


class Clock:
    """One injected clock for both packages' planes."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


class Pkg:
    """One package's modules, by the names the scenarios use."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.api = mod(pkg, "api")
        self.core = mod(pkg, "api.core")
        self.pol = mod(pkg, "api.policy")
        self.b = mod(pkg, "utils.builders")
        self.features = mod(pkg, "utils.features")
        self.webhook = mod(pkg, "webhook")
        self.prop = mod(pkg, "controllers.propagation")
        self.om = mod(pkg, "controllers.overridemanager")
        self.clock = Clock()

    @property
    def torch(self) -> bool:
        return self.pkg is karmada_tpu_torch

    def plane(self, **kw):
        if self.torch:
            kw["device"] = "cpu"
        return mod(self.pkg, "controlplane").ControlPlane(clock=self.clock, **kw)

    def scheduler(self, cp, name):
        kw = {"device": "cpu"} if self.torch else {}
        return mod(self.pkg, "controllers.scheduler_controller").SchedulerController(
            cp.store, cp.runtime, scheduler_name=name, clock=self.clock, **kw)

    def make_plane(self, n_clusters=3, **cluster_kw):
        cp = self.plane()
        for i in range(1, n_clusters + 1):
            cp.join_cluster(self.b.new_cluster(f"member{i}", cpu="100", memory="200Gi",
                                               **cluster_kw))
        cp.settle()
        return cp

    def deployment_policy(self, placement, name="nginx-policy", ns="default"):
        return self.pol.PropagationPolicy(
            meta=self.core.ObjectMeta(name=name, namespace=ns),
            spec=self.pol.PropagationSpec(
                resource_selectors=[self.pol.ResourceSelector(api_version="apps/v1",
                                                              kind="Deployment")],
                placement=placement,
            ),
        )

    def cpp(self, name, placement, priority=0, preemption="Never"):
        p = self.pol.ClusterPropagationPolicy(
            meta=self.core.ObjectMeta(name=name),
            spec=self.pol.PropagationSpec(
                resource_selectors=[self.pol.ResourceSelector(api_version="apps/v1",
                                                              kind="Deployment")],
                placement=placement,
            ),
        )
        p.spec.priority = priority
        p.spec.preemption = preemption
        return p

    def image_override(self, name, registry, target=None, cluster_scoped=False):
        cls = self.pol.ClusterOverridePolicy if cluster_scoped else self.pol.OverridePolicy
        return cls(
            meta=self.core.ObjectMeta(name=name, namespace="" if cluster_scoped else "default"),
            spec=self.pol.OverrideSpec(
                resource_selectors=[self.pol.ResourceSelector(api_version="apps/v1",
                                                              kind="Deployment")],
                override_rules=[self.pol.RuleWithCluster(
                    target_cluster=target,
                    overriders=self.pol.Overriders(image_overrider=[self.pol.ImageOverrider(
                        component="Registry", operator="replace", value=registry)]),
                )],
            ),
        )


# --------------------------------------------------------------------------
# the compared state
# --------------------------------------------------------------------------


def _cond(c) -> tuple:
    return (c.type, bool(c.status), c.reason, c.message)


def _obj(r) -> tuple:
    m = r.meta
    return (r.api_version, r.kind, m.namespace, m.name, dict(m.labels), dict(m.annotations),
            m.generation, r.spec, r.status)


def _task(t) -> tuple:
    return (t.from_cluster, t.replicas, t.reason, t.message, t.producer, t.purge_mode,
            t.grace_period_seconds, t.suppress_deletion, t.creation_timestamp,
            dict(t.preserved_label_state), list(t.clusters_before_failover))


def _plain(x):
    """A dataclass as a dict (each package has its own classes)."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def state(p: Pkg, cp) -> dict:
    store = cp.store
    by_key = lambda o: o.meta.namespaced_name  # noqa: E731
    out = {"bindings": [], "works": [], "members": {}}
    for kind in ("ResourceBinding", "ClusterResourceBinding"):
        for rb in sorted(store.list(kind), key=by_key):
            out["bindings"].append((
                kind, rb.meta.namespaced_name, dict(rb.meta.labels), rb.meta.generation,
                [(tc.name, tc.replicas) for tc in rb.spec.clusters], rb.spec.replicas,
                rb.spec.scheduler_name, rb.spec.priority,
                [_cond(c) for c in rb.status.conditions],
                [(i.cluster_name, i.status, i.applied, i.health, i.applied_message)
                 for i in rb.status.aggregated_status],
                rb.status.scheduler_observed_affinity_name,
                rb.status.scheduler_observed_generation,
                [_task(t) for t in rb.spec.graceful_eviction_tasks],
                [(s.namespace, s.name, [(tc.name, tc.replicas) for tc in s.clusters])
                 for s in rb.spec.required_by],
                rb.spec.reschedule_triggered_at, rb.status.last_scheduled_time,
            ))
    for w in sorted(store.list("Work"), key=by_key):
        ref = w.spec.workload_template
        out["works"].append((
            w.meta.namespaced_name, dict(w.meta.labels),
            [_obj(m) for m in p.prop.work_manifests(store, w)],
            None if ref is None else (ref.digest, ref.api_version, ref.kind, ref.namespace,
                                      ref.name, ref.patch),
            w.spec.suspend_dispatching, w.spec.preserve_resources_on_deletion,
            w.spec.conflict_resolution,
            [_cond(c) for c in w.status.conditions],
            [(ms.identifier.gvk, ms.identifier.namespaced_key, ms.status, ms.health)
             for ms in w.status.manifest_statuses],
        ))
    for name in sorted(cp.members.names()):
        member = cp.members.get(name)
        # an unreachable member's client refuses to list; its state is read
        # as it stands
        objs = sorted(member._resources.values(), key=lambda o: (
            o.api_version, o.kind, o.meta.namespace, o.meta.name))
        out["members"][name] = [_obj(o) + (o.meta.resource_version,) for o in objs]
    out["templates"] = [
        (t.meta.namespaced_name, t.api_version, t.kind, dict(t.meta.labels), t.meta.generation,
         t.spec, t.status)
        for t in sorted(store.list("Resource"), key=by_key)]
    out["clusters"] = [
        (c.name, dict(c.meta.labels), dict(c.meta.annotations),
         [(t.key, t.value, t.effect) for t in c.spec.taints], len(c.spec.resource_models),
         [_cond(x) for x in c.status.conditions], c.status.resource_summary.allocatable,
         c.status.resource_summary.allocated, c.status.api_enablements,
         c.status.kubernetes_version)
        for c in sorted(store.list("Cluster"), key=lambda c: c.name)]
    out["policies"] = [
        (kind, pol.meta.namespaced_name, dict(pol.meta.annotations))
        for kind in ("PropagationPolicy", "ClusterPropagationPolicy", "OverridePolicy",
                     "ClusterOverridePolicy")
        for pol in sorted(store.list(kind), key=by_key)]
    out["workload_templates"] = sorted(t.meta.name for t in store.list("WorkloadTemplate"))
    out["leases"] = [(ls.meta.name, ls.renew_time, ls.holder_identity)
                     for ls in sorted(store.list("Lease"), key=by_key)]
    out["rebalancers"] = [
        (r.meta.namespaced_name, [(t.kind, t.namespace, t.name) for t in r.spec.workloads],
         r.status.observed_workloads, r.status.observed_generation, r.status.finish_time)
        for r in sorted(store.list("WorkloadRebalancer"), key=by_key)]
    out["quotas"] = [(q.meta.namespaced_name, q.status.overall, q.status.overall_used)
                     for q in sorted(store.list("FederatedResourceQuota"), key=by_key)]
    # the autoscalers and the networking kinds, spec and status as plain
    # dicts (each package has its own dataclasses): FederatedHPA,
    # CronFederatedHPA (execution histories included), ServiceExport,
    # MultiClusterService and MultiClusterIngress; the members' Services,
    # EndpointSlices and Ingresses are among their objects above
    out["autoscaling_networking"] = [
        (kind, o.meta.namespaced_name, dict(o.meta.labels), o.meta.generation,
         _plain(getattr(o, "spec", None)), _plain(getattr(o, "status", None)))
        for kind in ("FederatedHPA", "CronFederatedHPA", "ServiceExport",
                     "MultiClusterService", "MultiClusterIngress")
        for o in sorted(store.list(kind), key=by_key)]
    # a copy: the plane goes on mutating the live dicts recorded here
    return copy.deepcopy(out)


def run_both(scenario, monkeypatch) -> list:
    """``scenario(Pkg, record)`` on the JAX plane, then on the port's; each
    run's admission chain draws its permanent IDs from the same counter.
    Returns the port's recorded states after holding them equal to the JAX
    plane's."""
    runs = []
    for pkg in PKGS:
        counter = itertools.count(1)
        monkeypatch.setattr(mod(pkg, "webhook.chain"), "uuid", types.SimpleNamespace(
            uuid4=lambda: uuid.UUID(int=next(counter))))
        p = Pkg(pkg)
        recorded = []
        scenario(p, lambda cp: recorded.append(state(p, cp)))
        runs.append(recorded)
    jax_states, port_states = runs
    assert len(jax_states) == len(port_states) > 0
    for i, (want, got) in enumerate(zip(jax_states, port_states)):
        for part in want:
            assert got[part] == want[part], f"state {i}: {part} differs"
    return port_states


@pytest.fixture
def gates():
    """Set a feature gate in both packages; restored after the test."""
    saved = []

    def set_(name, value):
        for pkg in PKGS:
            fg = mod(pkg, "utils.features").feature_gate
            saved.append((fg, name, fg.enabled(name)))
            fg.set(name, value)

    yield set_
    for fg, name, value in reversed(saved):
        fg.set(name, value)


# --------------------------------------------------------------------------
# scenarios (tests/test_e2e_propagation.py)
# --------------------------------------------------------------------------


def member_obj(cp, cluster, name, gvk="apps/v1/Deployment"):
    return cp.members.get(cluster).get(gvk, "default", name)


def image(cp, cluster, name="app"):
    return member_obj(cp, cluster, name).spec["template"]["spec"]["containers"][0]["image"]


def only_binding(cp):
    (rb,) = cp.store.list("ResourceBinding")
    return rb


def placed(rb) -> dict:
    return {tc.name: tc.replicas for tc in rb.spec.clusters}


def quickstart_duplicated(p, record):
    cp = p.make_plane(3)
    record(cp)
    cp.store.apply(p.b.new_deployment("nginx", replicas=2))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement()))
    cp.settle()
    record(cp)
    rb = cp.store.get("ResourceBinding", "default/nginx-deployment")
    assert placed(rb) == {"member1": 2, "member2": 2, "member3": 2}
    for name in ("member1", "member2", "member3"):
        assert member_obj(cp, name, "nginx").spec["replicas"] == 2


def quickstart_static_weight(p, record):
    cp = p.make_plane(3)
    cp.store.apply(p.b.new_deployment("web", replicas=10))
    cp.store.apply(p.deployment_policy(
        p.b.static_weight_placement({"member1": 2, "member2": 1, "member3": 1})))
    cp.settle()
    record(cp)
    rb = cp.store.get("ResourceBinding", "default/web-deployment")
    assert placed(rb) == {"member1": 6, "member2": 2, "member3": 2}
    assert member_obj(cp, "member1", "web").spec["replicas"] == 6


def quickstart_status_aggregation(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("api", replicas=4))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement()))
    cp.settle()
    record(cp)
    rb = cp.store.get("ResourceBinding", "default/api-deployment")
    assert sum(placed(rb).values()) == 4
    for name, reps in placed(rb).items():
        cp.members.get(name).set_workload_status(
            "apps/v1/Deployment", "default", "api",
            {"replicas": reps, "readyReplicas": reps, "updatedReplicas": reps})
    cp.settle()
    record(cp)
    assert cp.store.get("Resource", "default/api").status.get("readyReplicas") == 4
    rb = cp.store.get("ResourceBinding", "default/api-deployment")
    assert all(i.health == "Healthy" for i in rb.status.aggregated_status)


def overrides_image(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("app", replicas=1, image="docker.io/nginx:1.25"))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement()))
    cp.store.apply(p.image_override("registry-override", "registry.eu.example.com",
                                    p.pol.ClusterAffinity(cluster_names=["member2"])))
    cp.settle()
    record(cp)
    assert image(cp, "member1") == "docker.io/nginx:1.25"
    assert image(cp, "member2") == "registry.eu.example.com/nginx:1.25"


def overrides_cluster_label_edit(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("app", replicas=1, image="docker.io/nginx:1.25"))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement()))
    cp.store.apply(p.image_override(
        "edge-override", "edge.example.com",
        p.pol.ClusterAffinity(label_selector=p.pol.LabelSelector(match_labels={"tier": "edge"}))))
    cp.settle()
    record(cp)
    assert image(cp, "member1") == "docker.io/nginx:1.25"
    cluster = cp.store.get("Cluster", "member1")
    cluster.meta.labels["tier"] = "edge"
    cp.store.apply(cluster)
    cp.settle()
    record(cp)
    assert image(cp, "member1") == "edge.example.com/nginx:1.25"
    assert image(cp, "member2") == "docker.io/nginx:1.25"


def _lazy(p, placement, name="lazy-policy"):
    pol = p.deployment_policy(placement, name=name)
    pol.spec.activation_preference = "Lazy"
    return pol


def lazy_defers(p, record):
    cp = p.make_plane(3)
    cp.store.apply(p.b.new_deployment("web", replicas=6))
    cp.store.apply(_lazy(p, p.b.static_weight_placement({"member1": 1, "member2": 1})))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1", "member2"}
    cp.store.apply(_lazy(p, p.b.static_weight_placement({"member3": 1})))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1", "member2"}
    cp.store.apply(p.b.new_deployment("web", replicas=6, image="nginx:2"))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member3"}


def lazy_immediate(p, record):
    cp = p.make_plane(3)
    cp.store.apply(p.b.new_deployment("web", replicas=6))
    cp.store.apply(p.deployment_policy(p.b.static_weight_placement({"member1": 1})))
    cp.settle()
    record(cp)
    cp.store.apply(p.deployment_policy(p.b.static_weight_placement({"member2": 1})))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member2"}


def lazy_webhook_rejects(p, record):
    cp = p.make_plane(1)
    bad = p.deployment_policy(p.b.duplicated_placement())
    bad.spec.activation_preference = "Eventually"
    with pytest.raises(p.webhook.ValidationError, match="invalid activationPreference"):
        cp.store.apply(bad)
    record(cp)


def _claimed_by_low(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    low = p.deployment_policy(p.b.static_weight_placement({"member1": 1}), name="low")
    low.spec.priority = 1
    cp.store.apply(low)
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1"}
    return cp


def _high(p, preemption):
    high = p.deployment_policy(p.b.static_weight_placement({"member2": 1}), name="high")
    high.spec.priority = 10
    high.spec.preemption = preemption
    return high


def preemption_always(p, record):
    cp = _claimed_by_low(p, record)
    cp.store.apply(_high(p, "Always"))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member2"}
    labels = cp.store.get("Resource", "default/web").meta.labels
    assert labels.get("propagationpolicy.karmada.io/name") == "high"


def preemption_never(p, record):
    cp = _claimed_by_low(p, record)
    cp.store.apply(_high(p, "Never"))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1"}


def preemption_gate_off(p, record):
    cp = _claimed_by_low(p, record)
    cp.store.apply(_high(p, "Always"))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1"}


def ordered_affinities(p, record):
    cp = p.make_plane(3)
    placement = p.pol.Placement(cluster_affinities=[
        p.pol.ClusterAffinityTerm(affinity_name="primary", cluster_names=["absent-cluster"]),
        p.pol.ClusterAffinityTerm(affinity_name="backup", cluster_names=["member2"]),
    ])
    cp.store.apply(p.b.new_deployment("web", replicas=2))
    cp.store.apply(p.deployment_policy(placement))
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    assert set(placed(rb)) == {"member2"}
    assert rb.status.scheduler_observed_affinity_name == "backup"


def _field_selector(p, record, operator, want):
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("m-east", region="us-east1"))
    cp.join_cluster(p.b.new_cluster("m-west", region="us-west1"))
    cp.settle()
    placement = p.pol.Placement(cluster_affinity=p.pol.ClusterAffinity(
        field_selector=p.pol.FieldSelector(match_expressions=[
            p.pol.LabelSelectorRequirement(key="region", operator=operator,
                                           values=["us-east1"])])))
    cp.store.apply(p.b.new_deployment("web", replicas=2))
    cp.store.apply(p.deployment_policy(placement))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {want}


def field_selector_in(p, record):
    _field_selector(p, record, "In", "m-east")


def field_selector_notin(p, record):
    _field_selector(p, record, "NotIn", "m-west")


def cop_all_clusters(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("app", replicas=1, image="docker.io/nginx:1.25"))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement()))
    cp.store.apply(p.image_override("global-registry", "mirror.example.com",
                                    cluster_scoped=True))
    cp.settle()
    record(cp)
    for m in ("member1", "member2"):
        assert image(cp, m) == "mirror.example.com/nginx:1.25"


def cop_namespaced_wins(p, record):
    cp = p.make_plane(1)
    cp.store.apply(p.b.new_deployment("app", replicas=1, image="docker.io/nginx:1.25"))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement()))
    cp.store.apply(p.image_override("global-registry", "mirror.example.com",
                                    cluster_scoped=True))
    cp.store.apply(p.image_override("ns-registry", "team.example.com"))
    cp.settle()
    record(cp)
    assert image(cp, "member1") == "team.example.com/nginx:1.25"


def per_cluster_suspension(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("app", replicas=2))
    pol = p.deployment_policy(p.b.duplicated_placement())
    pol.spec.suspend_dispatching_on_clusters = ["member2"]
    cp.store.apply(pol)
    cp.settle()
    record(cp)
    assert member_obj(cp, "member1", "app") is not None
    assert member_obj(cp, "member2", "app") is None
    pol.spec.suspend_dispatching_on_clusters = None
    cp.store.apply(pol)
    cp.settle()
    record(cp)
    assert member_obj(cp, "member2", "app") is not None


def _configmap_plane(p, record, data, field_overrider):
    cp = p.make_plane(1)
    cp.store.apply(p.core.Resource(
        api_version="v1", kind="ConfigMap",
        meta=p.core.ObjectMeta(name="db-config", namespace="default"),
        spec={"data": data},
    ))
    selectors = [p.pol.ResourceSelector(api_version="v1", kind="ConfigMap")]
    cp.store.apply(p.pol.PropagationPolicy(
        meta=p.core.ObjectMeta(name="cm-policy", namespace="default"),
        spec=p.pol.PropagationSpec(resource_selectors=selectors,
                                   placement=p.b.duplicated_placement()),
    ))
    cp.store.apply(p.pol.OverridePolicy(
        meta=p.core.ObjectMeta(name="cm-override", namespace="default"),
        spec=p.pol.OverrideSpec(resource_selectors=selectors, override_rules=[
            p.pol.RuleWithCluster(overriders=p.pol.Overriders(
                field_overrider=[field_overrider]))]),
    ))
    cp.settle()
    record(cp)
    return member_obj(cp, "member1", "db-config", "v1/ConfigMap").spec["data"]


def field_overrider_yaml(p, record):
    import yaml

    data = _configmap_plane(p, record, {"db.yaml": "host: db.local\nport: 5432\n"},
                            p.pol.FieldOverrider(
                                field_path="/spec/data/db.yaml",
                                yaml=[p.pol.FieldPatchOperation(
                                    sub_path="/host", operator="replace",
                                    value="db.member1.local")]))
    assert yaml.safe_load(data["db.yaml"]) == {"host": "db.member1.local", "port": 5432}


def field_overrider_json(p, record):
    import json

    data = _configmap_plane(p, record, {"cfg.json": '{"replicas": 1}'},
                            p.pol.FieldOverrider(
                                field_path="/spec/data/cfg.json",
                                json=[p.pol.FieldPatchOperation(
                                    sub_path="/debug", operator="add", value=True)]))
    assert json.loads(data["cfg.json"]) == {"replicas": 1, "debug": True}


def field_overrider_webhook_rejects(p, record):
    cp = p.make_plane(1)
    bad = p.pol.OverridePolicy(
        meta=p.core.ObjectMeta(name="bad", namespace="default"),
        spec=p.pol.OverrideSpec(
            resource_selectors=[p.pol.ResourceSelector(api_version="v1", kind="ConfigMap")],
            override_rules=[p.pol.RuleWithCluster(overriders=p.pol.Overriders(
                field_overrider=[p.pol.FieldOverrider(
                    field_path="/spec/data/x",
                    json=[p.pol.FieldPatchOperation(sub_path="/a")],
                    yaml=[p.pol.FieldPatchOperation(sub_path="/b")],
                )]))]),
    )
    with pytest.raises(p.webhook.ValidationError, match="either json or yaml"):
        cp.store.apply(bad)
    record(cp)


def scheduler_name_foreign(p, record):
    cp = p.make_plane(2)
    pol = p.deployment_policy(p.b.dynamic_weight_placement())
    pol.spec.scheduler_name = "my-custom-scheduler"
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(pol)
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    assert rb.spec.scheduler_name == "my-custom-scheduler" and rb.spec.clusters == []


def scheduler_name_second_instance(p, record):
    cp = p.make_plane(2)
    p.scheduler(cp, "my-custom-scheduler")
    pol = p.deployment_policy(p.b.dynamic_weight_placement())
    pol.spec.scheduler_name = "my-custom-scheduler"
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(pol)
    cp.settle()
    record(cp)
    assert sum(placed(only_binding(cp)).values()) == 4


def _porting(p, record, conflict_resolution):
    cp = p.make_plane(2)
    cp.members.get("member1").apply(p.b.new_deployment("web", replicas=9))
    record(cp)
    cp.store.apply(p.b.new_deployment("web", replicas=2))
    pol = p.deployment_policy(p.b.duplicated_placement())
    if conflict_resolution:
        pol.spec.conflict_resolution = conflict_resolution
    cp.store.apply(pol)
    cp.settle()
    record(cp)
    applied = {i.cluster_name: i.applied for i in only_binding(cp).status.aggregated_status}
    return cp, applied


def porting_abort(p, record):
    cp, applied = _porting(p, record, None)
    assert applied.get("member2") is True and applied.get("member1") is False
    assert member_obj(cp, "member1", "web").spec["replicas"] == 9


def porting_overwrite(p, record):
    cp, applied = _porting(p, record, "Overwrite")
    assert applied.get("member1") is True
    assert member_obj(cp, "member1", "web").spec["replicas"] == 2


def cpp_binds_namespaced(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(p.cpp("cpp", p.b.static_weight_placement({"member1": 1})))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1"}
    labels = cp.store.get("Resource", "default/web").meta.labels
    assert labels.get("clusterpropagationpolicy.karmada.io/name") == "cpp"


def pp_outranks_cpp(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(p.cpp("cpp", p.b.static_weight_placement({"member1": 1})))
    cp.store.apply(p.deployment_policy(p.b.static_weight_placement({"member2": 1})))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member2"}
    labels = cp.store.get("Resource", "default/web").meta.labels
    assert labels.get("propagationpolicy.karmada.io/name") == "nginx-policy"


def lazy_gate_race(p, record):
    cp = p.make_plane(3)
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(_lazy(p, p.b.static_weight_placement({"member1": 1}), name="lazy"))
    cp.settle()
    record(cp)
    cp.store.apply(p.b.new_deployment("web", replicas=8))
    cp.store.apply(_lazy(p, p.b.static_weight_placement({"member2": 1}), name="lazy"))
    cp.settle()
    record(cp)
    assert only_binding(cp).spec.replicas == 8


def cpp_preemption_gate(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(p.cpp("a", p.b.static_weight_placement({"member1": 1})))
    cp.settle()
    record(cp)
    cp.store.apply(p.cpp("b", p.b.static_weight_placement({"member2": 1}), priority=10))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"member1"}
    labels = cp.store.get("Resource", "default/web").meta.labels
    assert labels.get("clusterpropagationpolicy.karmada.io/name") == "a"


def spread_constraint_policy(p, record):
    cp = p.plane()
    for i in range(1, 9):
        cp.join_cluster(p.b.new_cluster(f"m{i}", cpu="100", memory="200Gi",
                                        region=f"r{(i - 1) // 2}"))
    cp.settle()
    placement = p.b.dynamic_weight_placement(spread_constraints=[
        p.pol.SpreadConstraint(spread_by_field="region", min_groups=2, max_groups=3),
        p.pol.SpreadConstraint(spread_by_field="cluster", min_groups=2, max_groups=4),
    ])
    cp.store.apply(p.b.new_deployment("spread-app", replicas=8))
    cp.store.apply(p.deployment_policy(placement))
    cp.settle()
    record(cp)
    got = placed(cp.store.get("ResourceBinding", "default/spread-app-deployment"))
    assert sum(got.values()) == 8 and 2 <= len(got) <= 4
    assert 2 <= len({cp.store.get("Cluster", n).spec.region for n in got}) <= 3
    for name, reps in got.items():
        assert member_obj(cp, name, "spread-app").spec["replicas"] == reps


SCENARIOS = {
    "TestQuickstart-duplicated": quickstart_duplicated,
    "TestQuickstart-static-weight": quickstart_static_weight,
    "TestQuickstart-status-aggregation": quickstart_status_aggregation,
    "TestOverrides-image": overrides_image,
    "TestOverrides-cluster-label-edit": overrides_cluster_label_edit,
    "TestLazyActivationPolicy-defers": lazy_defers,
    "TestLazyActivationPolicy-immediate": lazy_immediate,
    "TestLazyActivationPolicy-webhook-rejects": lazy_webhook_rejects,
    "TestPolicyPreemption-gate-off": preemption_gate_off,
    "TestOrderedClusterAffinities": ordered_affinities,
    "TestFieldSelectorAffinity-in": field_selector_in,
    "TestFieldSelectorAffinity-notin": field_selector_notin,
    "TestClusterOverridePolicy-all-clusters": cop_all_clusters,
    "TestClusterOverridePolicy-namespaced-wins": cop_namespaced_wins,
    "TestPerClusterSuspension": per_cluster_suspension,
    "TestFieldOverrider-yaml": field_overrider_yaml,
    "TestFieldOverrider-json": field_overrider_json,
    "TestFieldOverrider-webhook-rejects": field_overrider_webhook_rejects,
    "TestSchedulerNameFilter-foreign": scheduler_name_foreign,
    "TestSchedulerNameFilter-second-instance": scheduler_name_second_instance,
    "TestPortingWorkloads-abort": porting_abort,
    "TestPortingWorkloads-overwrite": porting_overwrite,
    "TestClusterPropagationPolicy-cpp-binds": cpp_binds_namespaced,
    "TestClusterPropagationPolicy-pp-outranks": pp_outranks_cpp,
    "TestLazyGateRaces": lazy_gate_race,
    "TestCppPreemptionGate": cpp_preemption_gate,
    "TestSpreadConstraintPolicy": spread_constraint_policy,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_jax_plane(name, monkeypatch):
    run_both(SCENARIOS[name], monkeypatch)


@pytest.mark.parametrize("scenario", [preemption_always, preemption_never],
                         ids=["always", "never"])
def test_policy_preemption_gate_on_equals_jax_plane(scenario, monkeypatch, gates):
    """TestPolicyPreemption with the PropagationPolicyPreemption gate on in
    both packages: only a policy that declares preemption Always takes the
    claim."""
    gates(mod(karmada_tpu_torch, "utils.features").POLICY_PREEMPTION, True)
    run_both(scenario, monkeypatch)


@pytest.mark.parametrize("delta", ["1", "0"])
def test_quickstart_render_modes_equal_jax_plane(delta, monkeypatch):
    """The quickstart's status round in both Work render modes: template
    delta Works (a reference and a replica patch) and full objects."""
    monkeypatch.setenv(DELTA_ENV, delta)
    states = run_both(quickstart_status_aggregation, monkeypatch)
    refs = [w[3] for w in states[-1]["works"] if w[0].endswith("default.api-deployment")]
    assert refs and all((r is not None) == (delta == "1") for r in refs)


def test_field_overrider_no_ops_equal_jax():
    """TestFieldOverriderNoOps: empty operation lists leave the embedded
    document's format as it was, in both packages."""
    out = []
    for pkg in PKGS:
        p = Pkg(pkg)
        obj = p.core.Resource(api_version="v1", kind="ConfigMap",
                              meta=p.core.ObjectMeta(name="c", namespace="default"),
                              spec={"data": {"cfg.json": '{"a": 1}'}})
        p.om.apply_overriders(obj, p.pol.Overriders(field_overrider=[
            p.pol.FieldOverrider(field_path="/spec/data/cfg.json")]))
        out.append(obj.spec)
    assert out[0] == out[1] == {"data": {"cfg.json": '{"a": 1}'}}


# --------------------------------------------------------------------------
# config 4 through the plane, both render modes
# --------------------------------------------------------------------------

CONFIG4_CLUSTERS, CONFIG4_TEMPLATES, CONFIG4_SCALE = 60, 400, 40
CONFIG4_KILL, CONFIG4_DESCHEDULE = 3, 40


def config4_waves(p, record):
    """chip_smoke.run_plane's waves at a small size: join, cold wave, status
    round, a scale wave (seed 99) and a delete wave; then its failover path
    (``plane_failover_waves``): 3 clusters killed through the package's own
    chaos seam (seed 7), the eviction drain, a descheduler round over 40
    bindings (seed 11) and the recovery. The Failover gate is the caller's
    to set."""
    objs = chip_smoke.plane_objects(p.pkg, CONFIG4_TEMPLATES, CONFIG4_CLUSTERS)
    cp = p.plane(enable_descheduler=True)
    cp.descheduler.active = False
    for cl, m in zip(objs["clusters"], objs["members"]):
        cp.join_cluster(cl, m)
    cp.settle()
    record(cp)
    cp.store.apply(objs["policy"])
    cp.store.apply(objs["override"])
    for d in objs["deployments"]:
        cp.store.apply(d)
    cp.settle()
    record(cp)
    engine = cp.scheduler._engine
    assert engine._fleet is not None
    assert not engine.snapshot.model_pack.has_models.any()
    chip_smoke.report_ready(cp)
    cp.settle()
    record(cp)
    scaled, deleted = chip_smoke.plane_picks(CONFIG4_TEMPLATES, CONFIG4_SCALE, CONFIG4_SCALE)
    for i, r in scaled.items():
        t = cp.store.get("Resource", f"default/d{i}")
        t.spec["replicas"] = r
        t.meta.generation += 1
        cp.store.apply(t)
    cp.settle()
    record(cp)
    for i in deleted:
        cp.store.delete("Resource", f"default/d{i}")
    cp.settle()
    record(cp)
    faults = mod(p.pkg, "utils.faultinject")
    names = sorted(c.name for c in cp.store.list("Cluster"))
    killed = chip_smoke.plane_kills(names, CONFIG4_KILL, {
        tc.name for rb in cp.store.list("ResourceBinding") for tc in rb.spec.clusters})
    try:
        faults.arm(chip_smoke.kill_spec(killed), seed=7)
        p.clock.now += 60
        cp.settle()
        record(cp)
        chip_smoke.report_ready(cp, skip=set(killed))
        cp.settle()
        record(cp)
        rbs = chip_smoke.sorted_bindings(cp.store)
        picks = chip_smoke.plane_deschedule_picks(rbs, set(names) - set(killed),
                                                  CONFIG4_DESCHEDULE)
        chip_smoke.mark_unschedulable(cp, picks, since=p.clock.now)
        p.clock.now += 120
        cp.descheduler.active = True
        cp.descheduler.deschedule_once()
        cp.descheduler.active = False
        cp.settle()
        record(cp)
        faults.disarm()
        p.clock.now += 60
        cp.settle()
        record(cp)
    finally:
        faults.disarm()


@pytest.mark.parametrize("delta", ["1", "0"])
def test_config4_plane_equals_jax_plane(delta, monkeypatch, gates):
    monkeypatch.setenv(DELTA_ENV, delta)
    gates(mod(karmada_tpu_torch, "utils.features").FAILOVER, True)
    states = run_both(config4_waves, monkeypatch)
    cold = states[1]
    assert len(cold["bindings"]) == CONFIG4_TEMPLATES
    n_works = sum(len(b[4]) for b in cold["bindings"])
    deployments = [w for w in cold["works"] if w[0].rsplit("/", 1)[1] != "unified-auth"]
    assert len(deployments) == n_works > CONFIG4_TEMPLATES
    # template-delta Works hold a reference, except on the override's
    # region, whose Works render full objects
    refs = [w[3] is not None for w in deployments]
    assert (any(refs) and not all(refs)) if delta == "1" else not any(refs)
    mirrored = sum(w[2][0][7]["template"]["spec"]["containers"][0]["image"]
                   .startswith(chip_smoke.PLANE_REGISTRY) for w in deployments)
    assert 0 < mirrored < n_works
    assert all(t[6].get("readyReplicas") == t[5]["replicas"] for t in states[2]["templates"])
    assert len(states[4]["bindings"]) == CONFIG4_TEMPLATES - CONFIG4_SCALE
    # failover: the killed clusters tainted and left by every binding, some
    # displaced ones still holding their eviction tasks; the drain empties
    # them; the descheduler moves its 40; the recovery clears the taints
    killed = {c[0] for c in states[5]["clusters"]
              if ("cluster.karmada.io/not-ready", "", "NoExecute") in c[3]}
    assert len(killed) == CONFIG4_KILL
    assert not any(killed & {n for n, _ in b[4]} for b in states[5]["bindings"])
    assert any(b[12] for b in states[5]["bindings"])
    assert not any(b[12] for b in states[6]["bindings"])
    moved = sum(a[4] != b[4] for a, b in zip(states[6]["bindings"], states[7]["bindings"]))
    assert 0 < moved <= CONFIG4_DESCHEDULE
    assert not any(("cluster.karmada.io/not-ready", "", "NoExecute") in c[3]
                   for c in states[8]["clusters"])


PLANE_WAVES = ("join", "cold", "status", "scale", "delete", "failover", "drain",
               "deschedule", "recovery", "autoscale up", "autoscale hold", "autoscale down",
               "cron", "networking", "networking teardown", "resume", "resume drift round",
               "interpret configure", "interpret", "interpret status", "interpret scale",
               "interpret registry", "pull")


def test_plane_phase_rehearsal(capsys):
    """chip_smoke's plane phase at a small size on the CPU, its failover
    path, its autoscaling, networking, resume and interpret waves and its
    Pull plane included: every wave's check raises on any difference."""
    gate = mod(karmada_tpu_torch, "utils.features")
    was = gate.feature_gate.enabled(gate.FAILOVER)
    out = chip_smoke.run_plane(torch.device("cpu"), "cpu", templates=500, clusters=60,
                               scale=40, delete=40, kill=3, deschedule=40,
                               autoscale=(30, 10, 10), autoscale_down=10, cron=30,
                               services=5, ingresses=2, clonesets=60, custom=20, hooked=5,
                               custom_scale=10)
    assert gate.feature_gate.enabled(gate.FAILOVER) == was
    assert mod(karmada_tpu_torch, "utils.faultinject").injector() is None
    assert set(out["waves"]) == set(PLANE_WAVES)
    assert sum(out["waves"]["failover"]["passes"]) > 0
    assert out["waves"]["deschedule"]["passes"] == [40]
    assert out["waves"]["autoscale up"]["passes"] == [40]
    assert out["waves"]["autoscale down"]["passes"] == [10]
    assert out["waves"]["cron"]["passes"] == [30]
    assert out["waves"]["interpret"]["passes"] == [85]
    assert out["waves"]["interpret scale"]["passes"] == [10]
    printed = capsys.readouterr().out
    for wave in PLANE_WAVES:
        assert f"# plane {wave}:" in printed
    assert "500 ok / 0 bad" in printed
    assert "problems off the recipe (placement, replicas, requests) 0;" in printed


def _recipe_problem(p, **changes):
    sched = importlib.import_module(f"{p.__name__}.scheduler")
    q = importlib.import_module(f"{p.__name__}.utils.quantity")
    fields = dict(key="default/d3-deployment", placement=chip_smoke.config4_placement(p),
                  replicas=4, requests=q.parse_resource_list({"cpu": "250m", "memory": "512Mi"}),
                  gvk="apps/v1/Deployment")
    fields.update(changes)
    return sched.BindingProblem(**fields)


@pytest.mark.parametrize("change", ["none", "placement", "replicas", "requests", "gvk",
                                    "missing"])
def test_plane_recipe_check_counts_each_lost_field(change):
    """The plane phase's recipe check counts a problem whose placement,
    replicas, requests or gvk left the recipe on its way to the engine, or
    that was never built."""
    p = karmada_tpu_torch
    api = importlib.import_module("karmada_tpu_torch.api")
    placement = chip_smoke.config4_placement(p)
    placement.spread_constraints[0].max_groups = 3
    prob = {
        "none": _recipe_problem(p),
        "placement": _recipe_problem(p, placement=placement),
        "replicas": _recipe_problem(p, replicas=5),
        "requests": _recipe_problem(p, requests={"cpu": 250}),
        "gvk": _recipe_problem(p, gvk="apps/v1/StatefulSet"),
        "missing": None,
    }[change]
    rb = api.ResourceBinding(meta=api.ObjectMeta(name="d3-deployment", namespace="default"))
    bad = chip_smoke.plane_recipe_check(p, [rb], [prob], {"default/d3-deployment": 4})
    assert bad == (change != "none")
