"""The port's autoscaling against the JAX package on the CPU.

FederatedHPA and CronFederatedHPA (``controllers/autoscaling.py``), the
replica calculator (``controllers/replica_calculator.py``), the cron matcher
(``utils/cron.py``) and the metrics adapter (``metricsadapter/``):

- the scenarios of ``tests/test_autoscaling.py``,
  ``tests/test_quota_plane.py::TestHpaSurgePath`` and the FederatedHPA case
  of ``tests/test_metricsadapter.py`` run on both planes through ``run_both``
  (``tests/test_torch_controlplane.py``) under one injected clock; after
  every settle the two planes' states (bindings, Works, member objects,
  templates, and the FederatedHPAs' and CronFederatedHPAs' spec and status,
  execution histories included) must be equal, and each scenario's own
  checks hold on both;
- the calculator cases of ``tests/test_replica_calculator.py`` run on both
  packages' calculators with the same inputs: the same outputs, or the same
  ``MetricsError`` with the same message;
- the adapter cases of ``tests/test_metricsadapter.py`` query both
  packages' adapters over the same member series: the same samples;
- the cron matcher on both packages over a grid of schedules and times;
- ``chip_smoke.run_plane``'s autoscale up, hold, down and cron waves on
  config 4 at 300 templates x 40 clusters, on both planes through
  ``run_both``.

Tolerance: exact equality."""

import calendar
import dataclasses
import importlib

import pytest

import chip_smoke
from test_torch_controlplane import (  # noqa: F401 (fixture)
    PKGS,
    _one_torch_thread,
    mod,
    run_both,
)


def autoscaling(p):
    return mod(p.pkg, "api.autoscaling")


def make_plane(p, members=2, replicas=4):
    """``tests/test_autoscaling.py``'s plane: ``members`` members, the
    Deployment ``web`` at ``replicas`` and a dynamic-weight policy,
    settled."""
    cp = p.make_plane(members)
    cp.store.apply(p.b.new_deployment("web", replicas=replicas))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.settle()
    return cp


def make_hpa(p, min_r=1, max_r=10, target_util=50, window=0, name="web"):
    a = autoscaling(p)
    return a.FederatedHPA(
        meta=p.core.ObjectMeta(name=f"{name}-hpa", namespace="default"),
        spec=a.FederatedHPASpec(
            scale_target_ref=a.ScaleTargetRef(kind="Deployment", name=name),
            min_replicas=min_r, max_replicas=max_r,
            metrics=[a.MetricSpec(resource_name="cpu", target_average_utilization=target_util)],
            stabilization_window_seconds=window,
        ),
    )


def binding(cp, name="web"):
    return cp.store.get("ResourceBinding", f"default/{name}-deployment")


def replicas(cp, name="web"):
    return cp.store.get("Resource", f"default/{name}").spec["replicas"]


def aggregate_samples(cp, util, name="web"):
    for tc in binding(cp, name).spec.clusters:
        cp.members.get(tc.name).pod_metrics[f"default/{name}"] = {
            "pods": tc.replicas, "ready_pods": tc.replicas, "cpu_utilization": util}


# --------------------------------------------------------------------------
# tests/test_autoscaling.py
# --------------------------------------------------------------------------


def scale_up_on_high_utilization(p, record):
    cp = make_plane(p)
    aggregate_samples(cp, 100.0)
    cp.store.apply(make_hpa(p, target_util=50))
    cp.settle()
    record(cp)
    assert replicas(cp) == 8
    assert sum(tc.replicas for tc in binding(cp).spec.clusters) == 8


def scale_down_respects_window(p, record):
    cp = make_plane(p)
    aggregate_samples(cp, 10.0)
    cp.store.apply(make_hpa(p, target_util=50, window=300))
    cp.settle()
    record(cp)
    assert replicas(cp) == 4
    p.clock.now += 400
    cp.settle()
    record(cp)
    assert replicas(cp) == 1


def per_pod_scale_up(p, record):
    cp = make_plane(p)
    for tc in binding(cp).spec.clusters:
        cp.members.get(tc.name).workload_pods["default/web"] = [
            {"name": f"{tc.name}-p{i}", "request": 100, "value": 150}
            for i in range(tc.replicas)]
    cp.store.apply(make_hpa(p, target_util=50, max_r=20))
    cp.settle()
    record(cp)
    assert replicas(cp) == 12


def per_pod_unready_holds(p, record):
    cp = make_plane(p)
    left = 4
    for tc in binding(cp).spec.clusters:
        samples = []
        for i in range(tc.replicas):
            if left == 1:
                samples.append({"name": f"{tc.name}-p{i}", "request": 100, "ready": False})
            else:
                samples.append({"name": f"{tc.name}-p{i}", "request": 100, "value": 150})
            left -= 1
        cp.members.get(tc.name).workload_pods["default/web"] = samples
    cp.store.apply(make_hpa(p, target_util=100, max_r=20))
    cp.settle()
    record(cp)
    assert replicas(cp) == 5


def object_metric_scale(p, record):
    a = autoscaling(p)
    cp = make_plane(p)
    first = binding(cp).spec.clusters[0].name
    cp.members.get(first).custom_metric_series.append({
        "resource": "services", "namespaced": True, "namespace": "default",
        "object": "web-svc", "metric": "queue_length", "value": 30.0})
    hpa = make_hpa(p, max_r=20)
    hpa.spec.metrics = [a.MetricSpec(type="Object", metric_name="queue_length",
                                     target_value=10.0,
                                     described_object=a.ScaleTargetRef(kind="Service",
                                                                       name="web-svc"))]
    cp.store.apply(hpa)
    cp.settle()
    record(cp)
    assert replicas(cp) == 12


def max_replicas_clamp(p, record):
    cp = make_plane(p)
    aggregate_samples(cp, 500.0)
    cp.store.apply(make_hpa(p, max_r=6))
    cp.settle()
    record(cp)
    assert replicas(cp) == 6


def external_metric_scale(p, record):
    """The External flavour through the plane's adapter (the one the
    FederatedHPA controller shares): a total target over a selector-filtered
    series set."""
    a = autoscaling(p)
    cp = make_plane(p)
    cp.members.get("member1").external_metric_series.extend([
        {"namespace": "default", "metric": "queue_depth", "value": 45, "labels": {"q": "a"}},
        {"namespace": "default", "metric": "queue_depth", "value": 500, "labels": {"q": "b"}}])
    hpa = make_hpa(p, max_r=20)
    hpa.spec.metrics = [a.MetricSpec(type="External", metric_name="queue_depth",
                                     metric_selector={"q": "a"}, target_value=5.0)]
    cp.store.apply(hpa)
    cp.settle()
    record(cp)
    assert replicas(cp) == 9
    assert cp.federated_hpa._metrics_adapter is cp.metrics_adapter


def _morning(p, cp, rules, name="nightly", target="web"):
    a = autoscaling(p)
    cp.store.apply(a.CronFederatedHPA(
        meta=p.core.ObjectMeta(name=name, namespace="default"),
        spec=a.CronFederatedHPASpec(
            scale_target_ref=a.ScaleTargetRef(kind=rules[0][0], name=target),
            rules=[a.CronFederatedHPARule(name=n, schedule=s, **kw)
                   for _, n, s, kw in rules])))


def cron_scales_workload(p, record):
    p.clock.now = float(calendar.timegm((2026, 1, 1, 8, 59, 30, 0, 0, 0)))
    cp = make_plane(p)
    _morning(p, cp, [("Deployment", "morning-scale", "0 9 * * *", {"target_replicas": 12})])
    cp.settle()
    record(cp)
    assert replicas(cp) == 4
    p.clock.now += 40
    cp.settle()
    record(cp)
    assert replicas(cp) == 12
    hist = cp.store.get("CronFederatedHPA", "default/nightly").status.execution_histories
    assert [h.applied_replicas for h in hist] == [12]
    # another settle in the same minute fires nothing
    p.clock.now += 10
    cp.settle()
    record(cp)
    assert len(cp.store.get("CronFederatedHPA", "default/nightly").status
               .execution_histories) == 1


def cron_bounds_federated_hpa(p, record):
    """A rule on a FederatedHPA moves its bounds; the HPA then clamps the
    workload to the new floor. A suspended rule and a rule on a missing
    target leave their histories as the JAX controller does."""
    p.clock.now = float(calendar.timegm((2026, 1, 1, 8, 59, 30, 0, 0, 0)))
    cp = make_plane(p)
    aggregate_samples(cp, 50.0)
    cp.store.apply(make_hpa(p, min_r=1, max_r=20))
    _morning(p, cp, [
        ("FederatedHPA", "floor", "0 9 * * *", {"target_min_replicas": 7,
                                                "target_max_replicas": 15}),
        ("FederatedHPA", "off", "0 9 * * *", {"target_min_replicas": 2, "suspend": True})],
        target="web-hpa")
    _morning(p, cp, [("Deployment", "gone", "0 9 * * *", {"target_replicas": 3})],
             name="orphan", target="absent")
    cp.settle()
    record(cp)
    p.clock.now += 40
    cp.settle()
    record(cp)
    hpa = cp.store.get("FederatedHPA", "default/web-hpa")
    assert (hpa.spec.min_replicas, hpa.spec.max_replicas) == (7, 15)
    assert replicas(cp) == 7
    hist = cp.store.get("CronFederatedHPA", "default/orphan").status.execution_histories
    assert [(h.applied_replicas, h.message) for h in hist] == [
        (None, "target workload not found")]


SCENARIOS = {
    "TestFederatedHPA-scale-up": scale_up_on_high_utilization,
    "TestFederatedHPA-scale-down-window": scale_down_respects_window,
    "TestFederatedHPA-per-pod-scale-up": per_pod_scale_up,
    "TestFederatedHPA-per-pod-unready": per_pod_unready_holds,
    "TestFederatedHPA-object-metric": object_metric_scale,
    "TestFederatedHPA-max-clamp": max_replicas_clamp,
    "TestFederatedHPA-external-metric": external_metric_scale,
    "TestCron-scales-workload": cron_scales_workload,
    "TestCron-bounds-federated-hpa": cron_bounds_federated_hpa,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_autoscaling_scenario_equals_jax_plane(name, monkeypatch):
    run_both(SCENARIOS[name], monkeypatch)


CRON_SCHEDULES = ("* * * * *", "0 0 * * *", "30 * * * *", "*/15 * * * *", "0 0 1 1 *",
                  "0 0 2 1 *", "0 0 * * 4", "0 9 * * *", "5-10/2 8-9 * 1,6 0-2",
                  "59 23 31 12 *", "0 12 * * 0", "*/7 */5 1-15 */2 1-5")


def test_cron_matcher_equals_jax():
    """Both packages' ``cron_matches`` over every schedule above at every
    17th minute of 2026 (UTC), and both refuse a malformed schedule."""
    start = calendar.timegm((2026, 1, 1, 0, 0, 0, 0, 0, 0))
    stamps = [start + 60 * 17 * k for k in range(0, 365 * 24 * 60 // 17, 7)]
    got = []
    for pkg in PKGS:
        cron = mod(pkg, "utils.cron")
        got.append([[cron.cron_matches(s, ts) for ts in stamps] for s in CRON_SCHEDULES])
        with pytest.raises(ValueError, match="invalid cron schedule"):
            cron.cron_matches("0 9 * *", start)
    assert got[0] == got[1]
    assert sum(map(sum, got[1])) > 0


# --------------------------------------------------------------------------
# tests/test_quota_plane.py::TestHpaSurgePath
# --------------------------------------------------------------------------


def _surge_plane(p, ns="default"):
    cp = p.plane()
    for i in range(4):
        cp.join_cluster(p.b.new_cluster(f"m{i}", cpu="4000", memory="8000Gi", pods=100000))
    cp.settle()
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="pol", ns=ns))
    return cp


def _surge_cron(p, cp, i, ns, target):
    a = autoscaling(p)
    cp.store.apply(a.CronFederatedHPA(
        meta=p.core.ObjectMeta(name=f"cron{i}", namespace=ns),
        spec=a.CronFederatedHPASpec(
            scale_target_ref=a.ScaleTargetRef(kind="Deployment", name=f"s{i}"),
            rules=[a.CronFederatedHPARule(name="surge", schedule="0 9 * * *",
                                          target_replicas=target)])))


def cron_surge_batched(p, record):
    p.clock.now = float(calendar.timegm((2026, 1, 1, 8, 59, 30, 0, 0, 0)))
    cp = _surge_plane(p)
    n = 40
    for i in range(n):
        cp.store.apply(p.b.new_deployment(f"s{i}", replicas=2, cpu="100m"))
    for i in range(n):
        _surge_cron(p, cp, i, "default", 10)
    cp.settle()
    record(cp)
    before = {i: {tc.name: tc.replicas for tc in binding(cp, f"s{i}").spec.clusters}
              for i in range(n)}
    assert all(sum(b.values()) == 2 for b in before.values())
    solves0 = cp.scheduler._engine.solve_batches
    p.clock.now += 40
    cp.settle()
    record(cp)
    assert cp.scheduler._engine.solve_batches - solves0 <= 4
    for i in range(n):
        after = {tc.name: tc.replicas for tc in binding(cp, f"s{i}").spec.clusters}
        assert sum(after.values()) == 10
        assert all(after.get(c, 0) >= r for c, r in before[i].items())


def calculator_drives_scale_up(p, record):
    cp = make_plane(p)
    before = {tc.name: tc.replicas for tc in binding(cp).spec.clusters}
    for tc in binding(cp).spec.clusters:
        cp.members.get(tc.name).workload_pods["default/web"] = [
            {"name": f"{tc.name}-p{j}", "request": 500, "value": 450}
            for j in range(tc.replicas)]
    cp.store.apply(make_hpa(p, max_r=16, target_util=45))
    p.clock.now += 30
    cp.settle()
    record(cp)
    after = {tc.name: tc.replicas for tc in binding(cp).spec.clusters}
    assert sum(after.values()) == 8
    assert all(after.get(c, 0) >= r for c, r in before.items())


def surge_respects_quota(p, record):
    p.clock.now = float(calendar.timegm((2026, 1, 1, 8, 59, 30, 0, 0, 0)))
    cp = _surge_plane(p, ns="teamA")
    cp.store.apply(p.pol.FederatedResourceQuota(
        meta=p.core.ObjectMeta(name="q", namespace="teamA"),
        spec=p.pol.FederatedResourceQuotaSpec(overall={"cpu": 24000})))
    for i in range(8):
        cp.store.apply(p.b.new_deployment(f"s{i}", namespace="teamA", replicas=2, cpu="1"))
        _surge_cron(p, cp, i, "teamA", 4)
    cp.settle()
    record(cp)
    assert cp.store.get("FederatedResourceQuota", "teamA/q").status.overall_used == {
        "cpu": 16000}
    p.clock.now += 40
    cp.settle()
    record(cp)
    scaled = denied = 0
    for i in range(8):
        rb = cp.store.get("ResourceBinding", f"teamA/s{i}-deployment")
        total = sum(tc.replicas for tc in rb.spec.clusters)
        cond = next(c for c in rb.status.conditions if c.type == "Scheduled")
        if total == 4:
            scaled += 1
            assert cond.status
        else:
            assert total == 2 and cond.reason == "QuotaExceeded"
            denied += 1
    assert (scaled, denied) == (4, 4)
    assert cp.store.get("FederatedResourceQuota", "teamA/q").status.overall_used == {
        "cpu": 24000}


SURGE_SCENARIOS = {
    "cron-surge-batched": cron_surge_batched,
    "calculator-drives-scale-up": calculator_drives_scale_up,
    "surge-respects-quota": surge_respects_quota,
}


@pytest.mark.parametrize("name", list(SURGE_SCENARIOS))
def test_hpa_surge_path_equals_jax_plane(name, monkeypatch):
    run_both(SURGE_SCENARIOS[name], monkeypatch)


# --------------------------------------------------------------------------
# tests/test_replica_calculator.py
# --------------------------------------------------------------------------


def _pod(rc, name, request=100, value=None, **kw):
    return rc.PodSample(name=name, request=request, value=value, **kw)


def _unready(rc, name, request=100, value=None):
    return rc.PodSample(name=name, request=request, value=value, ready=False,
                        start_age=1e9, transition_age=1e9)


def _pods(rc, *specs):
    """Pods from ``(name, request, value)`` triples; ``"u:"`` marks an
    unready pod."""
    out = []
    for name, request, value in specs:
        if name.startswith("u:"):
            out.append(_unready(rc, name[2:], request, value))
        else:
            out.append(_pod(rc, name, request, value))
    return out


def _calc(rc):
    return rc.ReplicaCalculator(tolerance=0.1)


def _four(value, request=100):
    return [(f"pod{i}", request, value) for i in range(1, 5)]


def _grouped(g) -> tuple:
    return (g.ready_count, sorted(g.unready), sorted(g.missing), sorted(g.ignored))


#: each case: rc (a package's replica_calculator module) -> result
CALCULATOR_CASES = {
    # GetResourceReplicas (replica_calculator_test.go:114-281)
    "resource-scale-up": lambda rc: _calc(rc).get_resource_replicas(
        2, 50, "cpu", _pods(rc, ("pod1", 100, 150), ("pod2", 100, 150))),
    "resource-scale-down": lambda rc: _calc(rc).get_resource_replicas(
        4, 50, "cpu", _pods(rc, *_four(50))),
    "resource-tolerance": lambda rc: _calc(rc).get_resource_replicas(
        2, 50, "cpu", _pods(rc, ("pod1", 100, 52), ("pod2", 100, 48))),
    "resource-unready": lambda rc: _calc(rc).get_resource_replicas(
        3, 50, "cpu", _pods(rc, ("pod1", 100, 150), ("pod2", 100, 150), ("u:pod3", 100, None))),
    "resource-calibration": lambda rc: _calc(rc).get_resource_replicas(
        2, 50, "cpu", _pods(rc, ("pod1", 100, 150), ("pod2", 100, 150)), 0.5),
    "resource-no-pods": lambda rc: _calc(rc).get_resource_replicas(2, 50, "cpu", []),
    "resource-no-metrics": lambda rc: _calc(rc).get_resource_replicas(
        2, 50, "cpu", _pods(rc, ("pod1", 100, None), ("pod2", 100, None))),
    "resource-missing-request": lambda rc: _calc(rc).get_resource_replicas(
        2, 50, "cpu", _pods(rc, ("pod1", 100, 150), ("pod2", None, 150))),
    # GetRawResourceReplicas (:284-455)
    "raw-scale-up": lambda rc: _calc(rc).get_raw_resource_replicas(
        2, 100, "cpu", _pods(rc, ("pod1", 100, 150), ("pod2", 100, 150)), 1.0),
    "raw-scale-down": lambda rc: _calc(rc).get_raw_resource_replicas(
        4, 100, "cpu", _pods(rc, *_four(50)), 1.0),
    "raw-no-change": lambda rc: _calc(rc).get_raw_resource_replicas(
        2, 100, "cpu", _pods(rc, ("pod1", 100, 100), ("pod2", 100, 100)), 1.0),
    "raw-calibration": lambda rc: _calc(rc).get_raw_resource_replicas(
        2, 100, "cpu", _pods(rc, ("pod1", 100, 150), ("pod2", 100, 150)), 0.8),
    # GetMetricReplicas (:457-628)
    "metric-scale-up": lambda rc: _calc(rc).get_metric_replicas(
        2, 10, {"pod1": 15, "pod2": 15}, _pods(rc, ("pod1", 100, None), ("pod2", 100, None)),
        1.0),
    "metric-scale-down": lambda rc: _calc(rc).get_metric_replicas(
        4, 20, {f"pod{i}": 10 for i in range(1, 5)}, _pods(rc, *_four(None)), 1.0),
    "metric-no-change": lambda rc: _calc(rc).get_metric_replicas(
        2, 15, {"pod1": 15, "pod2": 15}, _pods(rc, ("pod1", 100, None), ("pod2", 100, None)),
        1.0),
    "metric-calibration": lambda rc: _calc(rc).get_metric_replicas(
        2, 10, {"pod1": 15, "pod2": 15}, _pods(rc, ("pod1", 100, None), ("pod2", 100, None)),
        0.8),
    # calcPlainMetricReplicas grouping (:630-815)
    "plain-unready-holds": lambda rc: _calc(rc).get_metric_replicas(
        3, 10, {"pod1": 15, "pod2": 15},
        _pods(rc, ("pod1", 100, None), ("pod2", 100, None), ("u:pod3", 100, None))),
    "plain-missing-scale-down": lambda rc: _calc(rc).get_metric_replicas(
        3, 10, {"pod1": 5, "pod2": 5},
        _pods(rc, ("pod1", 100, None), ("pod2", 100, None), ("pod3", 100, None))),
    "plain-no-ready-metrics": lambda rc: _calc(rc).get_metric_replicas(
        2, 10, {}, _pods(rc, ("u:pod1", 100, None), ("u:pod2", 100, None))),
    "plain-no-pods": lambda rc: _calc(rc).get_metric_replicas(2, 10, {}, []),
    "group-phases": lambda rc: _grouped(rc.group_pods(
        [_pod(rc, "ok", value=10), rc.PodSample(name="failed", phase="Failed", value=10),
         rc.PodSample(name="deleted", deleted=True, value=10),
         rc.PodSample(name="pending", phase="Pending"), _pod(rc, "missing")],
        {"ok": 10, "failed": 10, "deleted": 10}, "", 300, 30)),
    "group-cpu-initialization": lambda rc: _grouped(rc.group_pods(
        [rc.PodSample(name="warm", start_age=100, transition_age=90, sample_age=10,
                      window=60, value=10),
         rc.PodSample(name="cold", start_age=100, transition_age=30, sample_age=10,
                      window=60, value=10)],
        {"warm": 10, "cold": 10}, "cpu", 300, 30)),
    "group-cpu-never-ready": lambda rc: _grouped(rc.group_pods(
        [rc.PodSample(name="never", ready=False, start_age=1000, transition_age=990, value=10),
         rc.PodSample(name="flap", ready=False, start_age=1000, transition_age=100, value=10)],
        {"never": 10, "flap": 10}, "cpu", 300, 30)),
    # Object metrics (:829-1010)
    "object-scale-up": lambda rc: _calc(rc).get_object_metric_replicas(
        2, 10, 30, _pods(rc, ("pod1", 100, None), ("pod2", 100, None))),
    "object-tolerance": lambda rc: _calc(rc).get_object_metric_replicas(
        2, 10, 10, _pods(rc, ("pod1", 100, None), ("pod2", 100, None))),
    "object-scale-to-zero": lambda rc: _calc(rc).get_object_metric_replicas(0, 10, 30, []),
    "object-per-pod": lambda rc: _calc(rc).get_object_per_pod_metric_replicas(2, 10, 30),
    "object-per-pod-calibration": lambda rc: _calc(rc).get_object_per_pod_metric_replicas(
        2, 10, 30, 0.5),
    "object-per-pod-tolerance": lambda rc: _calc(rc).get_object_per_pod_metric_replicas(
        3, 10, 30),
    # direction-change guard (replica_calculator.go:130-140)
    "direction-change-guard": lambda rc: _calc(rc).get_metric_replicas(
        4, 10, {"pod1": 9, "pod2": 9}, _pods(rc, *_four(None))),
    # utilization helpers (metrics/utilization_test.go:67-140)
    "utilization-base": lambda rc: rc.resource_utilization_ratio(
        {"pod1": 300, "pod2": 500}, {"pod1": 500, "pod2": 500}, 50),
    "utilization-extraneous-metrics": lambda rc: rc.resource_utilization_ratio(
        {"pod1": 250, "ghost": 9999}, {"pod1": 500}, 50),
    "utilization-extra-request": lambda rc: rc.resource_utilization_ratio(
        {"pod1": 250}, {"pod1": 500, "unsampled": 500}, 50),
    "utilization-no-requests": lambda rc: rc.resource_utilization_ratio({"pod1": 100}, {}, 50),
    "metric-usage-ratio": lambda rc: rc.metric_usage_ratio({"pod1": 15, "pod2": 15}, 10),
}


def _outcome(fn, rc):
    try:
        return ("ok", fn(rc))
    except rc.MetricsError as e:
        return ("MetricsError", str(e))


@pytest.mark.parametrize("case", list(CALCULATOR_CASES))
def test_replica_calculator_equals_jax(case):
    """One case of ``tests/test_replica_calculator.py`` on both packages'
    calculators: the same result tuple, or the same ``MetricsError``."""
    fn = CALCULATOR_CASES[case]
    jax_rc, port_rc = (mod(pkg, "controllers.replica_calculator") for pkg in PKGS)
    want, got = _outcome(fn, jax_rc), _outcome(fn, port_rc)
    assert got == want
    assert issubclass(port_rc.MetricsError, ValueError)


# --------------------------------------------------------------------------
# tests/test_metricsadapter.py
# --------------------------------------------------------------------------


def _members(pkg, n=3):
    member = mod(pkg, "utils.member")
    reg = member.MemberClientRegistry()
    for i in range(1, n + 1):
        reg.register(member.MemberCluster(f"member{i}"))
    return reg


def _seed_resource(reg):
    reg.get("member1").pod_metrics_detail["default/web-1"] = {
        "cpu": 250, "memory": 1 << 28, "labels": {"app": "web"}}
    reg.get("member2").pod_metrics_detail["default/web-1"] = {"cpu": 400, "labels": {"app": "web"}}
    reg.get("member2").pod_metrics_detail["default/db-1"] = {"cpu": 900, "labels": {"app": "db"}}
    reg.get("member1").node_metrics["n1"] = {"cpu": 4000, "labels": {"pool": "gpu"}}
    reg.get("member3").node_metrics["n9"] = {"cpu": 1000, "labels": {"pool": "cpu"}}
    reg.get("member1").pod_metrics["default/web"] = {"pods": 3, "cpu_utilization": 80.0}
    reg.get("member3").pod_metrics["default/web"] = {"pods": 1, "cpu_utilization": 40.0}


def _seed_custom(reg):
    reg.get("member1").custom_metric_series.extend([
        {"resource": "pods", "namespaced": True, "namespace": "default", "object": "web-1",
         "metric": "http_requests", "value": 30.0, "labels": {"verb": "GET"},
         "object_labels": {"app": "web"}},
        {"resource": "pods", "namespaced": True, "namespace": "default", "object": "web-1",
         "metric": "http_requests", "value": 5.0, "labels": {"verb": "POST"},
         "object_labels": {"app": "web"}},
        {"resource": "namespaces", "namespaced": False, "namespace": "", "object": "default",
         "metric": "ns_cost", "value": 12.0}])
    reg.get("member2").custom_metric_series.append(
        {"resource": "pods", "namespaced": True, "namespace": "default", "object": "web-2",
         "metric": "http_requests", "value": 50.0, "labels": {"verb": "GET"},
         "object_labels": {"app": "web"}})
    reg.get("member3").custom_metric_series.append(
        {"resource": "pods", "namespaced": True, "namespace": "other", "object": "web-9",
         "metric": "http_requests", "value": 999.0, "labels": {"verb": "GET"},
         "object_labels": {"app": "web"}})


def _seed_external(reg):
    reg.get("member1").external_metric_series.extend([
        {"namespace": "default", "metric": "queue_depth", "value": 5, "labels": {"queue": "orders"}},
        {"namespace": "default", "metric": "queue_depth", "value": 100,
         "labels": {"queue": "audit"}}])
    reg.get("member2").external_metric_series.append(
        {"namespace": "default", "metric": "queue_depth", "value": 7, "labels": {"queue": "orders"}})
    reg.get("member3").external_metric_series.append(
        {"namespace": "other", "metric": "queue_depth", "value": 999, "labels": {"queue": "orders"}})


def _in(pkg):
    """A match-expression selector in ``pkg``."""
    pol = mod(pkg, "api.policy")
    return pol.LabelSelector(match_expressions=[pol.LabelSelectorRequirement(
        key="verb", operator="In", values=["GET", "PUT"])])


def _plain(out):
    if isinstance(out, (list, set)):
        items = [dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x for x in out]
        return sorted(items, key=repr) if isinstance(out, set) else items
    return out


ADAPTER_CASES = {
    "pod-metrics-by-name": (_seed_resource,
                            lambda a, pkg: a.resources.pod_metrics_by_name("default", "web-1")),
    "pod-metrics-by-selector": (_seed_resource, lambda a, pkg: a.resources
                                .pod_metrics_by_selector("default", {"app": "web"})),
    "node-metrics-by-selector": (_seed_resource, lambda a, pkg: a.resources
                                 .node_metrics_by_selector({"pool": "gpu"})
                                 + a.resources.node_metrics_by_name("n9")),
    "custom-by-name-metric-selector": (_seed_custom, lambda a, pkg: a.custom.get_metric_by_name(
        "pods", "default", "web-1", "http_requests", metric_selector={"verb": "GET"})),
    "custom-by-selector-namespaced": (_seed_custom, lambda a, pkg: a.custom.get_metric_by_selector(
        "pods", "default", "http_requests", object_selector={"app": "web"},
        metric_selector={"verb": "GET"})
        + a.custom.get_metric_by_selector("pods", "default", "http_requests",
                                          metric_selector=_in(pkg))),
    "custom-root-scoped-and-list-all": (_seed_custom, lambda a, pkg: (
        _plain(a.custom.get_metric_by_name("namespaces", "", "default", "ns_cost")),
        sorted((i.group_resource, i.metric, i.namespaced) for i in a.custom.list_all_metrics()),
        _plain(a.custom_metric("http_requests")))),
    "external-with-selector": (_seed_external, lambda a, pkg: (
        a.external.external_metric_sum("default", "queue_depth", {"queue": "orders"}),
        sorted(a.external.list_all_external_metrics()),
        a.external_metric_sum("queue_depth"),
        _plain(a.external.get_external_metric("", "queue_depth")))),
    "workload-summary-helpers": (_seed_resource, lambda a, pkg: (
        _plain(a.resource_metrics("default/web")), a.merged_utilization("default/web"),
        a.merged_utilization("default/none"))),
}


@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_metrics_adapter_equals_jax(case):
    """One query of ``tests/test_metricsadapter.py`` (and the facade's
    summary helpers) on both packages' adapters over the same member series,
    an unreachable member among them: the same samples, in the same order."""
    seed, query = ADAPTER_CASES[case]
    got = []
    for pkg in PKGS:
        reg = _members(pkg, 4)
        seed(reg)
        reg.get("member4").reachable = False
        reg.get("member4").pod_metrics["default/web"] = {"pods": 9, "cpu_utilization": 1.0}
        adapter = importlib.import_module(f"{pkg.__name__}.metricsadapter").MetricsAdapter(reg)
        got.append(_plain(query(adapter, pkg)))
    assert got[1] == got[0]
    assert got[1]


def hpa_custom_metric(p, record):
    """FederatedHPA driven by a selector-filtered custom metric across three
    members (``TestFederatedHPACustomMetrics``)."""
    a = autoscaling(p)
    cp = make_plane(p, members=3, replicas=3)
    for i, (member, val) in enumerate([("member1", 120.0), ("member2", 80.0),
                                       ("member3", 100.0)]):
        cp.members.get(member).custom_metric_series.extend([
            {"resource": "pods", "namespaced": True, "namespace": "default",
             "object": f"web-{i}", "metric": "http_requests", "value": val,
             "labels": {"path": "api"}},
            {"resource": "pods", "namespaced": True, "namespace": "default",
             "object": f"web-{i}", "metric": "http_requests", "value": 10_000.0,
             "labels": {"path": "healthz"}}])
    hpa = make_hpa(p, max_r=10)
    hpa.spec.metrics = [a.MetricSpec(type="Pods", metric_name="http_requests",
                                     metric_selector={"path": "api"}, target_average_value=50.0)]
    cp.store.apply(hpa)
    p.clock.now += 30
    cp.settle()
    record(cp)
    assert replicas(cp) == 6
    assert sum(tc.replicas for tc in binding(cp).spec.clusters) == 6


def test_hpa_custom_metric_equals_jax_plane(monkeypatch):
    run_both(hpa_custom_metric, monkeypatch)


# --------------------------------------------------------------------------
# chip_smoke.run_plane's autoscaling waves on both planes
# --------------------------------------------------------------------------

CONFIG4_TEMPLATES, CONFIG4_CLUSTERS = 300, 40


def config4_plane(p):
    """BASELINE config 4 at ``CONFIG4_TEMPLATES`` x ``CONFIG4_CLUSTERS``
    (``chip_smoke.plane_objects``) through join, cold wave and status
    round."""
    objs = chip_smoke.plane_objects(p.pkg, CONFIG4_TEMPLATES, CONFIG4_CLUSTERS)
    cp = p.plane()
    for cl, m in zip(objs["clusters"], objs["members"]):
        cp.join_cluster(cl, m)
    cp.settle()
    cp.store.apply(objs["policy"])
    cp.store.apply(objs["override"])
    for d in objs["deployments"]:
        cp.store.apply(d)
    cp.settle()
    chip_smoke.report_ready(cp)
    cp.settle()
    return cp


def config4_autoscale_waves(p, record):
    """``chip_smoke.plane_autoscale_waves``' autoscale up, hold, down and
    cron waves at a small size (``autoscale_picks``, seed 7): FederatedHPAs
    at 80 %, inside the tolerance and at 400 %, then at 20 % behind a 300 s
    window, then CronFederatedHPAs at 09:00 UTC; each template at the HPA
    rule or its cron size, on both planes."""
    cp = config4_plane(p)
    record(cp)
    up, down, crons = chip_smoke.autoscale_picks(CONFIG4_TEMPLATES, set(), (20, 8, 8), 8, 20)
    rep0 = {i: replicas(cp, f"d{i}") for i in (*up, *down, *crons)}
    assert all(r == (i % 40) + 1 for i, r in rep0.items())
    chip_smoke.set_samples(cp, up)
    for hpa in chip_smoke.hpa_objects(p.pkg, sorted(up), rep0, window=300):
        cp.store.apply(hpa)
    p.clock.now += 16
    cp.settle()
    record(cp)
    want = {i: chip_smoke.hpa_rule(rep0[i], u, 1, chip_smoke.hpa_max(rep0[i]))
            for i, u in up.items()}
    assert {i: replicas(cp, f"d{i}") for i in up} == want
    assert sum(want[i] != rep0[i] for i in up) == 28
    chip_smoke.set_samples(cp, {i: chip_smoke.HPA_TARGET for i in up})
    chip_smoke.set_samples(cp, {i: 20 for i in down})
    for hpa in chip_smoke.hpa_objects(p.pkg, down, rep0, window=300):
        cp.store.apply(hpa)
    cp.settle()
    record(cp)
    assert {i: replicas(cp, f"d{i}") for i in down} == {i: rep0[i] for i in down}
    p.clock.now += 301
    cp.settle()
    record(cp)
    assert {i: replicas(cp, f"d{i}") for i in down} == {
        i: chip_smoke.hpa_rule(rep0[i], 20, 1, chip_smoke.hpa_max(rep0[i]), held=False)
        for i in down}
    chip_smoke.set_samples(cp, {i: chip_smoke.HPA_TARGET for i in down})
    for obj in chip_smoke.cron_objects(p.pkg, crons):
        cp.store.apply(obj)
    p.clock.now = chip_smoke.next_utc(p.clock.now, 8, 59, 30)
    cp.settle()
    record(cp)
    assert {i: replicas(cp, f"d{i}") for i in crons} == {i: rep0[i] for i in crons}
    p.clock.now += 60
    cp.settle()
    record(cp)
    assert {i: replicas(cp, f"d{i}") for i in crons} == crons
    p.clock.now += 5
    cp.settle()
    record(cp)
    for i, r in crons.items():
        hist = cp.store.get("CronFederatedHPA", f"default/d{i}-cron").status.execution_histories
        assert [h.applied_replicas for h in hist] == [r]


def test_config4_autoscale_waves_equal_jax_plane(monkeypatch):
    run_both(config4_autoscale_waves, monkeypatch)
