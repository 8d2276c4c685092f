"""The port's failover path against the JAX plane on the CPU.

The scenarios of ``tests/test_e2e_propagation.py`` (``TestFailover``,
``TestDescheduler``), ``tests/test_failover_chaos.py``
(``TestGracefulEvictionEdges``, ``TestChaosPlane``) and
``tests/test_pod_runtime_addons.py`` (``TestUnschedulableCounting``) run on
``karmada_tpu.controlplane.ControlPlane`` and on the port's
(``device="cpu"``) under one injected clock, through ``run_both`` of
``tests/test_torch_controlplane.py``: after every settle the two planes'
states (bindings with their graceful-eviction tasks, Works, member objects,
templates, Clusters with their taints, Leases) must be equal. Tolerance:
exact equality.

Both packages keep their own feature gate and their own fault injector:
each scenario arms its own package's ``utils.faultinject``, and the
``gates`` fixture sets a gate in both; every test disarms both injectors
when it ends."""

import importlib

import numpy as np
import pytest

import karmada_tpu_torch

from test_torch_controlplane import (  # noqa: F401 (fixtures)
    PKGS,
    _one_torch_thread,
    gates,
    mod,
    only_binding,
    placed,
    run_both,
)

FEATURES = mod(karmada_tpu_torch, "utils.features")


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    for pkg in PKGS:
        mod(pkg, "utils.faultinject").disarm()


def _failover_policy(p, toleration=30):
    pol = p.deployment_policy(p.b.dynamic_weight_placement())
    pol.spec.failover = p.pol.FailoverBehavior(
        application=p.pol.ApplicationFailoverBehavior(
            decision_conditions_toleration_seconds=toleration))
    return pol


# --------------------------------------------------------------------------
# TestFailover, TestDescheduler (tests/test_e2e_propagation.py)
# --------------------------------------------------------------------------


def cluster_failover(p, record):
    cp = p.make_plane(3)
    cp.store.apply(p.b.new_deployment("ha-app", replicas=6))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement()))
    cp.settle()
    record(cp)
    before = placed(only_binding(cp))
    assert sum(before.values()) == 6
    cp.members.get("member2").reachable = False
    cp.settle()
    record(cp)
    cluster2 = cp.store.get("Cluster", "member2")
    assert any(t.effect == "NoExecute" for t in cluster2.spec.taints)
    rb = only_binding(cp)
    assert "member2" not in placed(rb) and sum(placed(rb).values()) == 6
    if before.get("member2"):
        assert [t.from_cluster for t in rb.spec.graceful_eviction_tasks] == ["member2"]


def graceful_eviction_completes(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.b.new_deployment("svc", replicas=2))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement()))
    cp.settle()
    record(cp)
    cp.members.get("member1").reachable = False
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    assert rb.spec.graceful_eviction_tasks
    for name, reps in placed(rb).items():
        cp.members.get(name).set_workload_status(
            "apps/v1/Deployment", "default", "svc",
            {"replicas": reps, "readyReplicas": reps, "updatedReplicas": reps})
    cp.settle()
    record(cp)
    assert not only_binding(cp).spec.graceful_eviction_tasks
    ns = p.prop.execution_namespace("member1")
    assert cp.store.get("Work", f"{ns}/default.svc-deployment") is None


def application_failover(p, record):
    cp = p.plane()
    for i in (1, 2):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
    cp.store.apply(p.b.new_deployment("flaky", replicas=2))
    cp.store.apply(_failover_policy(p))
    cp.settle()
    record(cp)
    victim = sorted(placed(only_binding(cp)))[0]
    cp.members.get(victim).set_workload_status(
        "apps/v1/Deployment", "default", "flaky",
        {"replicas": 1, "readyReplicas": 0, "updatedReplicas": 0})
    cp.settle()
    record(cp)
    assert victim in placed(only_binding(cp))
    p.clock.now += 60
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    assert victim not in placed(rb) and sum(placed(rb).values()) == 2


def descheduler_reclaims(p, record):
    cp = p.plane(enable_descheduler=True)
    for i in (1, 2):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
    cp.store.apply(p.b.new_deployment("batchy", replicas=8))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement()))
    cp.settle()
    record(cp)
    before = placed(only_binding(cp))
    victim = max(before, key=lambda n: before[n])
    cp.members.get(victim).unschedulable_replicas["default/batchy"] = 2
    cp.settle()
    record(cp)
    assert sum(placed(only_binding(cp)).values()) == 8


def descheduler_pod_conditions(p, record):
    """TestUnschedulableCounting.test_descheduler_uses_pod_conditions."""
    p.clock.now = 0.0
    cp = p.plane(enable_descheduler=True)
    for name in ("m1", "m2"):
        cp.join_cluster(p.b.new_cluster(name))
    cp.store.apply(p.b.new_deployment("web", replicas=4))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement(), name="web-pp"))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"m1", "m2"}
    m1 = cp.members.get("m1")
    for pod in ("web-x", "web-y"):
        m1.add_pod("default", pod, owner_key="default/web")
        m1.mark_pod_unschedulable("default", pod, since=0.0)
    p.clock.now = 120.0
    cp.settle()
    record(cp)
    assert placed(only_binding(cp))["m2"] == 4


# --------------------------------------------------------------------------
# TestGracefulEvictionEdges (tests/test_failover_chaos.py)
# --------------------------------------------------------------------------


def _bare_binding(p, name, replicas, clusters, **spec):
    rb = p.api.ResourceBinding(meta=p.core.ObjectMeta(name=name, namespace="default"))
    rb.spec.replicas = replicas
    rb.spec.clusters = [p.api.TargetCluster(name=c, replicas=r) for c, r in clusters]
    for k, v in spec.items():
        setattr(rb.spec, k, v)
    return rb


def _work_api(p):
    return mod(p.pkg, "api.work")


def task_past_grace_purged(p, record):
    p.clock.now = 1000.0
    cp = p.plane(eviction_timeout=50.0)
    w = _work_api(p)
    rb = _bare_binding(p, "app", 2, [("m2", 2)], graceful_eviction_tasks=[
        w.GracefulEvictionTask(from_cluster="m1", replicas=2, reason="test",
                               creation_timestamp=p.clock.now)])
    rb.status.aggregated_status = [
        w.AggregatedStatusItem(cluster_name="m2", applied=False, health="Unknown")]
    cp.store.apply(rb)
    cp.settle()
    record(cp)
    assert cp.store.get("ResourceBinding", "default/app").spec.graceful_eviction_tasks
    p.clock.now += 51.0
    cp.settle()
    record(cp)
    assert not cp.store.get("ResourceBinding", "default/app").spec.graceful_eviction_tasks


def per_task_grace(p, record):
    p.clock.now = 500.0
    cp = p.plane(eviction_timeout=600.0)
    w = _work_api(p)
    cp.store.apply(_bare_binding(p, "fast", 1, [("m2", 1)], graceful_eviction_tasks=[
        w.GracefulEvictionTask(from_cluster="m1", replicas=1, reason="test",
                               grace_period_seconds=5, creation_timestamp=p.clock.now)]))
    p.clock.now += 6.0
    cp.settle()
    record(cp)
    assert not cp.store.get("ResourceBinding", "default/fast").spec.graceful_eviction_tasks


def preserve_state_double_reschedule(p, record):
    p.clock.now = 2000.0
    cp = p.plane(eviction_timeout=50.0)
    w = _work_api(p)
    rb = _bare_binding(p, "stateful", 2, [("m1", 2)], scheduler_name="nobody",
                       failover=p.pol.FailoverBehavior(
                           application=p.pol.ApplicationFailoverBehavior(
                               decision_conditions_toleration_seconds=10,
                               state_preservation={"phase": ".phase"})))
    rb.status.aggregated_status = [w.AggregatedStatusItem(
        cluster_name="m1", applied=True, health="Unhealthy", status={"phase": "hop1"})]
    cp.store.apply(rb)
    cp.settle()
    p.clock.now += 11.0
    cp.settle()
    record(cp)
    rb = cp.store.get("ResourceBinding", "default/stateful")
    assert {t.from_cluster: t.preserved_label_state
            for t in rb.spec.graceful_eviction_tasks} == {"m1": {"phase": "hop1"}}
    rb.spec.clusters = [p.api.TargetCluster(name="m2", replicas=2)]
    rb.status.aggregated_status = [w.AggregatedStatusItem(
        cluster_name="m2", applied=True, health="Unhealthy", status={"phase": "hop2"})]
    cp.store.apply(rb)
    cp.settle()
    p.clock.now += 11.0
    cp.settle()
    record(cp)
    rb = cp.store.get("ResourceBinding", "default/stateful")
    assert {t.from_cluster: t.preserved_label_state
            for t in rb.spec.graceful_eviction_tasks} == {
        "m1": {"phase": "hop1"}, "m2": {"phase": "hop2"}}


# --------------------------------------------------------------------------
# TestChaosPlane (tests/test_failover_chaos.py)
# --------------------------------------------------------------------------


def _ordered_policy(p):
    def term(group):
        return p.pol.ClusterAffinityTerm(
            affinity_name=f"grp-{group}",
            label_selector=p.pol.LabelSelector(match_labels={"group": group}))

    return p.deployment_policy(p.b.dynamic_weight_placement(
        cluster_affinities=[term("primary"), term("fallback")]), name="chaos-policy")


def _grouped_plane(p):
    cp = p.plane()
    for i in range(1, 5):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi",
                                        labels={"group": "primary" if i < 3 else "fallback"}))
    cp.settle()
    return cp


def seeded_kill_replays(p, record):
    """The seeded kill's placements against ``replay_failover`` of the
    package's own ``refimpl/failover_np.py`` on the fired-event log."""
    faults = mod(p.pkg, "utils.faultinject")
    p.clock.now = 3000.0
    cp = _grouped_plane(p)
    cp.store.apply(p.b.new_deployment("web", replicas=8))
    cp.store.apply(_ordered_policy(p))
    cp.settle()
    record(cp)
    before = placed(only_binding(cp))
    assert set(before) <= {"member1", "member2"} and sum(before.values()) == 8
    inj = faults.arm("cluster.health=down,match=member2", seed=3)
    p.clock.now += 60
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    after = placed(rb)
    assert "member2" not in after and sum(after.values()) == 8
    assert rb.status.scheduler_observed_affinity_name == "grp-primary"
    engine = cp.scheduler._engine
    snap = engine.snapshot
    compiled = mod(p.pkg, "scheduler.snapshot").compile_placement(
        _ordered_policy(p).spec.placement, snap)
    reqs = np.zeros((1, len(snap.dims)), np.int64)
    pods = snap.dim_index("pods")
    if pods is not None:
        reqs[0, pods] = 1
    avail = engine._availability_np(reqs, np.asarray([8], np.int32))[0]
    key = "default/web-deployment"
    want = mod(p.pkg, "refimpl.failover_np").replay_failover(
        inj.log, snap.names, {key: before},
        {key: np.stack([m for _, m in compiled.terms])},
        {key: compiled.taint_ok & compiled.spread_field_ok}, {key: compiled.strategy},
        {key: 8}, {key: compiled.static_weights}, {key: avail})
    assert want[key] == after
    assert [(e.seq, e.point, e.action, e.key) for e in inj.log][:1] == [
        (0, "cluster.health", "down", "member2")]


def primary_wipeout(p, record):
    faults = mod(p.pkg, "utils.faultinject")
    p.clock.now = 4000.0
    cp = _grouped_plane(p)
    cp.store.apply(p.b.new_deployment("web", replicas=6))
    cp.store.apply(_ordered_policy(p))
    cp.settle()
    record(cp)
    faults.arm("cluster.health=down,match=member1;cluster.health=down,match=member2", seed=11)
    p.clock.now += 60
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    assert set(placed(rb)) <= {"member3", "member4"} and sum(placed(rb).values()) == 6
    assert rb.status.scheduler_observed_affinity_name == "grp-fallback"
    faults.disarm()
    p.clock.now += 60
    cp.settle()
    record(cp)
    cluster2 = cp.store.get("Cluster", "member2")
    assert not any(t.effect == "NoExecute" for t in cluster2.spec.taints)


SCENARIOS = {
    "TestFailover-cluster-failover": (cluster_failover, (FEATURES.FAILOVER,)),
    "TestFailover-graceful-eviction-completes": (graceful_eviction_completes,
                                                 (FEATURES.FAILOVER,)),
    "TestFailover-application-failover": (application_failover, ()),
    "TestDescheduler": (descheduler_reclaims, ()),
    "TestUnschedulableCounting-descheduler": (descheduler_pod_conditions, ()),
    "TestGracefulEvictionEdges-past-grace": (task_past_grace_purged, (FEATURES.FAILOVER,)),
    "TestGracefulEvictionEdges-per-task-grace": (per_task_grace, (FEATURES.FAILOVER,)),
    "TestGracefulEvictionEdges-preserve-state": (
        preserve_state_double_reschedule,
        (FEATURES.FAILOVER, FEATURES.STATEFUL_FAILOVER_INJECTION)),
    "TestChaosPlane-seeded-kill": (seeded_kill_replays, (FEATURES.FAILOVER,)),
    "TestChaosPlane-primary-wipeout": (primary_wipeout, (FEATURES.FAILOVER,)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_failover_scenario_equals_jax_plane(name, monkeypatch, gates):  # noqa: F811
    scenario, on = SCENARIOS[name]
    for gate in on:
        gates(gate, True)
    run_both(scenario, monkeypatch)


# --------------------------------------------------------------------------
# TestUnschedulableCounting, the fault injector
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["threshold", "override"])
def test_unschedulable_counting_equals_jax(case):
    out = []
    for pkg in PKGS:
        m = mod(pkg, "utils.member").MemberCluster("m1")
        if case == "threshold":
            for pod in ("web-1", "web-2", "web-3"):
                m.add_pod("default", pod, owner_key="default/web")
            m.mark_pod_unschedulable("default", "web-1", since=100.0)
            m.mark_pod_unschedulable("default", "web-2", since=195.0)
            out.append((m.count_unschedulable(now=200.0), m.count_unschedulable(now=300.0)))
        else:
            m.add_pod("default", "a-1", owner_key="default/a")
            m.mark_pod_unschedulable("default", "a-1", since=0.0)
            m.unschedulable_replicas.update({"default/a": 5, "default/b": 2})
            out.append(m.count_unschedulable(now=1000.0))
    assert out[0] == out[1]
    assert out[1] == (({"default/web": 1}, {"default/web": 2}) if case == "threshold"
                      else {"default/a": 5, "default/b": 2})


@pytest.mark.parametrize("spec", [
    "cluster.health=down,match=member3",
    "cluster.health=down,rate=0.5,count=7;estimator.rpc=error,after=3,rate=0.3",
    "cluster.health=down,after=5,match=m",
])
def test_fault_injector_replays_as_jax(spec):
    """The same spec and seed fire the same events in both packages."""
    logs = []
    for pkg in PKGS:
        faults = mod(pkg, "utils.faultinject")
        inj = faults.arm(spec, seed=7)
        fired = [(faults.fault_point(point, key) or faults.FaultRule("", "")).action
                 for point in ("cluster.health", "estimator.rpc")
                 for key in (f"member{i}" for i in range(40))]
        faults.disarm()
        assert faults.fault_point("cluster.health", "member3") is None
        logs.append((fired, [(e.seq, e.point, e.action, e.key) for e in inj.log]))
    assert logs[0] == logs[1] and logs[1][1]


def test_fault_spec_errors_equal_jax():
    for bad in ("cluster.health=explode", "=down", "cluster.health=down,bogus=1"):
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as err:
                mod(pkg, "utils.faultinject").parse_spec(bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_failover_modules_are_the_ports():
    """Every controller of the failover path the port's plane builds is the
    port's own."""
    cp = importlib.import_module("karmada_tpu_torch.controlplane").ControlPlane(
        device="cpu", enable_descheduler=True)
    for comp in (cp.taint_manager, cp.graceful_eviction, cp.app_failover, cp.descheduler,
                 cp.dependencies_distributor, cp.frq_controller, cp.remedy_controller):
        assert type(comp).__module__.startswith("karmada_tpu_torch.")
