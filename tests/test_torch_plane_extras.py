"""The port's plane extras against the JAX plane on the CPU.

The scenarios of ``tests/test_extras_controllers.py`` (dependencies,
namespace sync, the workload rebalancer, FederatedResourceQuota status and
cluster-scoped bindings), ``tests/test_search_remedy_agent.py``
(``TestRemedy``) and ``tests/test_pod_runtime_addons.py`` (the estimator
toggles of ``TestAddons``, ``TestDetectorLifecycle`` and
``TestServiceNameResolutionDetector``), and the plane's scheduler
options (``disabled_scheduler_plugins``, ``scheduler_filter_plugins``) and
``enable_member_hpa_sync``, run on
``karmada_tpu.controlplane.ControlPlane`` and on the port's
(``device="cpu"``) under one injected clock, through ``run_both`` of
``tests/test_torch_controlplane.py``: after every settle the two planes'
states (bindings, Works, member objects, templates, Clusters with their
annotations, rebalancers and quotas) must be equal. Tolerance: exact
equality. The JAX tests drive the estimator addon through ``cli.cmd_addons``
and ``cmd_local_up``; the CLI is not ported (ROADMAP A7c), so the scenarios
call the plane methods those commands call."""

import numpy as np
import pytest

from test_torch_controlplane import (  # noqa: F401 (fixture)
    PKGS,
    _one_torch_thread,
    mod,
    only_binding,
    placed,
    run_both,
)


def _deps_policy(p, placement):
    pol = p.deployment_policy(placement, name="p")
    pol.spec.propagate_deps = True
    return pol


def _configmap(p, name, **kw):
    return p.core.Resource(api_version="v1", kind="ConfigMap",
                           meta=p.core.ObjectMeta(name=name, namespace="default"), **kw)


def _with_volume(p, name, replicas, cm):
    dep = p.b.new_deployment(name, replicas=replicas)
    dep.spec["template"]["spec"]["volumes"] = [{"name": "cfg", "configMap": {"name": cm}}]
    return dep


# --------------------------------------------------------------------------
# TestDependenciesDistributor
# --------------------------------------------------------------------------


def configmap_follows_workload(p, record):
    cp = p.make_plane(2)
    cp.store.apply(_configmap(p, "app-config", spec={"data": {"k": "v"}}))
    cp.store.apply(_with_volume(p, "app", 2, "app-config"))
    cp.store.apply(_deps_policy(p, p.b.dynamic_weight_placement()))
    cp.settle()
    record(cp)
    where = set(placed(cp.store.get("ResourceBinding", "default/app-deployment")))
    attached = cp.store.get("ResourceBinding", "default/app-config-configmap")
    assert {tc.name for tc in attached.spec.clusters} == where
    for name in where:
        assert cp.members.get(name).get("v1/ConfigMap", "default", "app-config") is not None


def attached_removed_with_parent(p, record):
    cp = p.make_plane(1)
    cp.store.apply(_configmap(p, "c1"))
    cp.store.apply(_with_volume(p, "app", 1, "c1"))
    cp.store.apply(_deps_policy(p, p.b.duplicated_placement()))
    cp.settle()
    record(cp)
    assert cp.store.get("ResourceBinding", "default/c1-configmap") is not None
    cp.store.delete("Resource", "default/app")
    cp.settle()
    record(cp)
    assert cp.store.get("ResourceBinding", "default/c1-configmap") is None


def adopted_binding_survives(p, record):
    label = mod(p.pkg, "controllers.dependencies").DEPENDED_BY_LABEL
    cp = p.make_plane(1)
    cp.store.apply(_configmap(p, "c1"))
    cp.store.apply(_with_volume(p, "app", 1, "c1"))
    cp.store.apply(_deps_policy(p, p.b.duplicated_placement()))
    cp.settle()
    record(cp)
    attached = cp.store.get("ResourceBinding", "default/c1-configmap")
    del attached.meta.labels[label]
    cp.store.apply(attached)
    cp.store.delete("Resource", "default/app")
    cp.settle()
    record(cp)
    assert cp.store.get("ResourceBinding", "default/c1-configmap") is not None


# --------------------------------------------------------------------------
# TestNamespaceSync
# --------------------------------------------------------------------------


def _namespace(p, name):
    return p.core.Resource(api_version="v1", kind="Namespace", meta=p.core.ObjectMeta(name=name))


def namespace_propagates(p, record):
    cp = p.make_plane(2)
    cp.store.apply(_namespace(p, "team-a"))
    cp.settle()
    record(cp)
    for m in ("member1", "member2"):
        assert cp.members.get(m).get("v1/Namespace", "", "team-a") is not None
    cp.join_cluster(p.b.new_cluster("member3", cpu="100", memory="200Gi"))
    cp.settle()
    record(cp)
    assert cp.members.get("member3").get("v1/Namespace", "", "team-a") is not None


def reserved_namespace_skipped(p, record):
    cp = p.make_plane(1)
    cp.store.apply(_namespace(p, "kube-system"))
    cp.settle()
    record(cp)
    assert cp.members.get("member1").get("v1/Namespace", "", "kube-system") is None


# --------------------------------------------------------------------------
# TestWorkloadRebalancer, TestClusterScopedBindings
# --------------------------------------------------------------------------


def _rebalancer(p, name, *workloads, ttl=None):
    ex = mod(p.pkg, "controllers.extras")
    return ex.WorkloadRebalancer(
        meta=p.core.ObjectMeta(name=name),
        spec=ex.WorkloadRebalancerSpec(
            workloads=[ex.ObjectReferenceSelector(kind="Deployment", name=w)
                       for w in workloads],
            ttl_seconds_after_finished=ttl))


def _rebalance_plane(p, n=2, apps=("app",), replicas=4):
    p.clock.now = 5000.0
    cp = p.plane()
    for i in range(1, n + 1):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
    for app in apps:
        cp.store.apply(p.b.new_deployment(app, replicas=replicas))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.settle()
    return cp


def rebalancer_triggers_fresh(p, record):
    cp = _rebalance_plane(p)
    record(cp)
    p.clock.now += 10
    cp.store.apply(_rebalancer(p, "rb1", "app"))
    cp.settle()
    record(cp)
    rb = cp.store.get("ResourceBinding", "default/app-deployment")
    assert rb.spec.reschedule_triggered_at == p.clock.now
    r = cp.store.get("WorkloadRebalancer", "rb1")
    assert r.status.observed_workloads[0]["result"] == "Successful"
    assert r.status.finish_time == p.clock.now


def rebalancer_inplace_edit(p, record):
    ex = mod(p.pkg, "controllers.extras")
    cp = _rebalance_plane(p, apps=("app", "app2"))
    p.clock.now += 10
    cp.store.apply(_rebalancer(p, "rb-edit", "app"))
    cp.settle()
    record(cp)
    p.clock.now += 10
    reb = cp.store.get("WorkloadRebalancer", "rb-edit")
    reb.spec.workloads[0] = ex.ObjectReferenceSelector(kind="Deployment", name="app2")
    cp.store.apply(reb)
    cp.settle()
    record(cp)
    assert cp.store.get("ResourceBinding", "default/app2-deployment").spec \
        .reschedule_triggered_at == p.clock.now
    p.clock.now += 10
    cp.settle()
    record(cp)


def rebalancer_legacy_status(p, record):
    cp = _rebalance_plane(p)
    p.clock.now += 10
    cp.store.apply(_rebalancer(p, "rb-legacy", "app"))
    cp.settle()
    t_first = p.clock.now
    del cp.store.get("WorkloadRebalancer", "rb-legacy").status.observed_spec_digest
    p.clock.now += 10
    cp.settle()
    record(cp)
    assert cp.store.get("ResourceBinding", "default/app-deployment").spec \
        .reschedule_triggered_at == t_first


def rebalancer_ttl(p, record):
    cp = _rebalance_plane(p, n=1, replicas=2)
    cp.store.apply(_rebalancer(p, "rb-ttl", "app", ttl=60))
    cp.settle()
    record(cp)
    p.clock.now += 59
    cp.settle()
    assert cp.store.get("WorkloadRebalancer", "rb-ttl") is not None
    p.clock.now += 2
    cp.settle()
    record(cp)
    assert cp.store.get("WorkloadRebalancer", "rb-ttl") is None


def rebalancer_ttl_pending(p, record):
    ex = mod(p.pkg, "controllers.extras")
    cp = _rebalance_plane(p, n=1, replicas=2)
    cp.store.apply(_rebalancer(p, "rb-grow", "app", ttl=60))
    cp.settle()
    record(cp)
    p.clock.now += 50
    r = cp.store.get("WorkloadRebalancer", "rb-grow")
    r.spec.workloads.append(ex.ObjectReferenceSelector(kind="Deployment", name="ghost"))
    r.status.observed_workloads = []
    cp.store.apply(r)
    cp.settle()
    record(cp)
    p.clock.now += 100
    cp.settle()
    record(cp)


def fresh_uses_plane_clock(p, record):
    p.clock.now = 7000.0
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("small", cpu="4", memory="200Gi"))
    cp.store.apply(p.b.new_deployment("app", replicas=4, cpu="1"))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.settle()
    record(cp)
    cp.join_cluster(p.b.new_cluster("big", cpu="400", memory="800Gi"))
    p.clock.now += 10
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"small"}
    cp.store.apply(_rebalancer(p, "go-fresh", "app"))
    p.clock.now += 10
    cp.settle()
    record(cp)
    assert "big" in placed(only_binding(cp))


def cluster_role_via_crb(p, record):
    cp = p.make_plane(2)
    for m in cp.members.names():
        cp.members.get(m).api_enablements.append("rbac.authorization.k8s.io/v1/ClusterRole")
    cp.settle()
    cp.store.apply(p.core.Resource(
        api_version="rbac.authorization.k8s.io/v1", kind="ClusterRole",
        meta=p.core.ObjectMeta(name="viewer"),
        spec={"rules": [{"apiGroups": [""], "resources": ["pods"], "verbs": ["get", "list"]}]}))
    cp.store.apply(p.pol.ClusterPropagationPolicy(
        meta=p.core.ObjectMeta(name="roles"),
        spec=p.pol.PropagationSpec(
            resource_selectors=[p.pol.ResourceSelector(
                api_version="rbac.authorization.k8s.io/v1", kind="ClusterRole")],
            placement=p.b.duplicated_placement())))
    cp.settle()
    record(cp)
    assert cp.store.get("ClusterResourceBinding", "viewer-clusterrole") is not None
    for m in ("member1", "member2"):
        assert cp.members.get(m).get("rbac.authorization.k8s.io/v1/ClusterRole", "",
                                     "viewer") is not None


# --------------------------------------------------------------------------
# TestFederatedResourceQuota
# --------------------------------------------------------------------------


def frq_static_and_live_usage(p, record):
    cp = p.make_plane(2)
    cp.store.apply(p.pol.FederatedResourceQuota(
        meta=p.core.ObjectMeta(name="quota", namespace="default"),
        spec=p.pol.FederatedResourceQuotaSpec(overall={"cpu": 10_000}, static_assignments=[
            p.pol.StaticClusterAssignment(cluster_name="member1", hard={"cpu": 6000}),
            p.pol.StaticClusterAssignment(cluster_name="member2", hard={"cpu": 4000})])))
    cp.settle()
    record(cp)
    q1 = cp.members.get("member1").get("v1/ResourceQuota", "default", "quota")
    assert q1.spec["hard"]["cpu"] == 6000
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.store.apply(p.b.new_deployment("quotad", replicas=3, cpu="500m"))
    cp.settle()
    record(cp)
    frq = cp.store.get("FederatedResourceQuota", "default/quota")
    assert frq.status.overall_used == {"cpu": 1500} and frq.status.overall == {"cpu": 10_000}
    cp.store.apply(p.b.new_deployment("quotad", replicas=1, cpu="500m"))
    cp.settle()
    record(cp)
    assert cp.store.get("FederatedResourceQuota", "default/quota").status.overall_used == {
        "cpu": 500}
    metrics = mod(p.pkg, "utils.metrics")
    assert metrics.quota_used.value(namespace="default", resource="cpu") == 500
    assert metrics.quota_limit.value(namespace="default", resource="cpu") == 10_000
    cp.store.delete("FederatedResourceQuota", "default/quota")
    cp.settle()
    record(cp)
    assert not any(dict(k).get("namespace") == "default"
                   for k in metrics.quota_used.samples())


# --------------------------------------------------------------------------
# TestRemedy, TestServiceNameResolutionDetector, TestDetectorLifecycle
# --------------------------------------------------------------------------


def _remedy(p, **spec):
    rem = mod(p.pkg, "controllers.remedy")
    return rem.Remedy(meta=p.core.ObjectMeta(name="dns-remedy"), spec=rem.RemedySpec(**spec))


def _annotation(p):
    return mod(p.pkg, "controllers.remedy").REMEDY_ACTIONS_ANNOTATION


def traffic_control_on_condition(p, record):
    rem = mod(p.pkg, "controllers.remedy")
    cp = p.make_plane(2)
    cp.store.apply(_remedy(p, cluster_affinity=p.pol.ClusterAffinity(cluster_names=["member1"]),
                           decision_matches=[rem.DecisionMatch()]))
    cp.settle()
    record(cp)
    for healthy in (False, True):
        cluster = cp.store.get("Cluster", "member1")
        p.core.set_condition(cluster.status.conditions, p.core.Condition(
            type="ServiceDomainNameResolutionReady", status=healthy))
        cp.store.apply(cluster)
        cp.settle()
        record(cp)
        got = cp.store.get("Cluster", "member1").meta.annotations.get(_annotation(p))
        assert got == (None if healthy else "TrafficControl")


def _dns_service(p):
    return p.core.Resource(api_version="v1", kind="Service",
                           meta=p.core.ObjectMeta(namespace="kube-system", name="kube-dns"))


def _dns_ready(cp, name="m1"):
    conds = {c.type: c.status for c in cp.store.get("Cluster", name).status.conditions}
    return conds.get("ServiceDomainNameResolutionReady")


def sn_detector_follows_probe(p, record):
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("m1"))
    member = cp.members.get("m1")
    member.apply(_dns_service(p))
    cp.add_sn_detector("m1")
    cp.settle()
    record(cp)
    assert _dns_ready(cp) is True
    member.delete("v1/Service", "kube-system", "kube-dns")
    cp.settle()
    record(cp)
    assert _dns_ready(cp) is False


def sn_detector_feeds_remedy(p, record):
    rem = mod(p.pkg, "controllers.remedy")
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("m1"))
    cp.add_sn_detector("m1")
    cp.store.apply(_remedy(p, decision_matches=[rem.DecisionMatch()]))
    cp.settle()
    record(cp)
    assert cp.store.get("Cluster", "m1").meta.annotations.get(_annotation(p)) == "TrafficControl"
    cp.members.get("m1").apply(_dns_service(p))
    cp.settle()
    record(cp)
    assert _annotation(p) not in cp.store.get("Cluster", "m1").meta.annotations


def stale_detector_deactivated(p, record):
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("m1"))
    det1 = cp.add_sn_detector("m1", probe=lambda: False)
    cp.settle()
    record(cp)
    cp.unjoin_cluster("m1")
    assert det1.active is False
    cp.join_cluster(p.b.new_cluster("m1"))
    cp.add_sn_detector("m1", probe=lambda: True)
    cp.settle()
    record(cp)
    assert _dns_ready(cp) is True


def replacing_detector(p, record):
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("m1"))
    det1 = cp.add_sn_detector("m1", probe=lambda: False)
    det2 = cp.add_sn_detector("m1", probe=lambda: True)
    assert det1.active is False and det2.active is True
    cp.settle()
    record(cp)
    assert _dns_ready(cp) is True


# --------------------------------------------------------------------------
# TestAddons: the estimator toggles
# --------------------------------------------------------------------------


def _nodes(p, name):
    acc = mod(p.pkg, "estimator.accurate")
    return [acc.NodeState(name=f"{name}-n{j}", allocatable={"cpu": 8000, "memory": 32 << 30,
                                                           "pods": 110},
                          requested={"cpu": 1000 * j}, num_pods=10 * j) for j in range(3)]


def estimator_toggle(p, record):
    cp = p.plane()
    for i in (1, 2):
        m = mod(p.pkg, "utils.member").MemberCluster(f"member{i}")
        m.nodes = _nodes(p, f"member{i}")
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"), m)
    cp.settle()
    assert cp.scheduler.extra_estimators == []
    cp.enable_accurate_estimators()
    assert len(cp.scheduler.extra_estimators) == 1
    assert cp.estimators.get("member1") is not None
    # a cluster event rebuilds the engine with the estimator fan-out
    cp.join_cluster(p.b.new_cluster("member3", cpu="100", memory="200Gi"))
    cp.store.apply(p.b.new_deployment("est", replicas=40, cpu="1"))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.settle()
    record(cp)
    engine = cp.scheduler._engine
    assert len(engine.extra_estimators) == 1
    cp.members.get("member1").add_pod("default", "est-x", owner_key="default/est")
    cp.members.get("member1").mark_pod_unschedulable("default", "est-x", since=0.0)
    p.clock.now += 120
    cp.settle()
    assert cp.estimators.get("member1").unschedulable == {"default/est": 1}
    cp.unjoin_cluster("member3")
    assert len(cp.scheduler.extra_estimators) == 1
    cp.settle()
    record(cp)
    cp.disable_accurate_estimators()
    assert cp.scheduler.extra_estimators == [] and cp.estimators.get("member1") is None
    cp.settle()
    record(cp)


def estimator_covers_later_joins(p, record):
    cp = p.plane()
    cp.enable_accurate_estimators()
    cp.join_cluster(p.b.new_cluster("late"))
    assert cp.estimators.get("late") is not None
    cp.settle()
    record(cp)


# --------------------------------------------------------------------------
# the plane's scheduler options and member HPA sync
# --------------------------------------------------------------------------


def _three(p, cp, **kw):
    for i in (1, 2, 3):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi", **(
            kw if i == 2 else {})))
    cp.store.apply(p.b.new_deployment("web", replicas=6))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement(), name="p"))
    cp.settle()


def disabled_taint_plugin(p, record):
    """``disabled_scheduler_plugins``: with TaintToleration off, a NoSchedule
    taint no longer filters its cluster."""
    taint = p.api.Taint(key="dedicated", value="infra", effect="NoSchedule")
    for disabled in ((), ("TaintToleration",)):
        cp = p.plane(disabled_scheduler_plugins=disabled)
        _three(p, cp, taints=[taint])
        record(cp)
        assert ("member2" in placed(only_binding(cp))) == bool(disabled)


def custom_filter_plugin(p, record):
    """``scheduler_filter_plugins``: an out-of-tree filter (snapshot,
    problems) -> bool[B, C] AND-composed with the in-tree ones."""
    def no_member1(snap, problems):
        mask = np.ones((len(problems), snap.num_clusters), bool)
        mask[:, snap.index["member1"]] = False
        return mask

    cp = p.plane(scheduler_filter_plugins=[no_member1])
    _three(p, cp)
    record(cp)
    assert set(placed(only_binding(cp))) == {"member2", "member3"}


def member_hpa_sync(p, record):
    """``enable_member_hpa_sync``: the replicas syncer writes the sum of the
    members' replicas back onto an HPA-marked template."""
    hs = mod(p.pkg, "controllers.hpa_sync")
    cp = p.plane(enable_member_hpa_sync=True)
    assert cp.hpa_marker is not None and cp.replicas_syncer is not None
    for i in (1, 2):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
    dep = p.b.new_deployment("web", replicas=4)
    dep.meta.labels[hs.HPA_TARGET_LABEL] = "default/web-hpa"
    cp.store.apply(dep)
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.settle()
    record(cp)
    for name in sorted(placed(only_binding(cp))):
        member = cp.members.get(name)
        obj = member.get("apps/v1/Deployment", "default", "web")
        obj.spec["replicas"] += 1
        member.apply(obj)
    cp.settle()
    record(cp)
    assert cp.store.get("Resource", "default/web").spec["replicas"] > 4


SCENARIOS = {
    "TestDependenciesDistributor-follows-workload": configmap_follows_workload,
    "TestDependenciesDistributor-removed-with-parent": attached_removed_with_parent,
    "TestDependenciesDistributor-adopted-survives": adopted_binding_survives,
    "TestNamespaceSync-propagates": namespace_propagates,
    "TestNamespaceSync-reserved-skipped": reserved_namespace_skipped,
    "TestWorkloadRebalancer-triggers-fresh": rebalancer_triggers_fresh,
    "TestWorkloadRebalancer-inplace-edit": rebalancer_inplace_edit,
    "TestWorkloadRebalancer-legacy-status": rebalancer_legacy_status,
    "TestWorkloadRebalancer-ttl": rebalancer_ttl,
    "TestClusterScopedBindings-ttl-pending": rebalancer_ttl_pending,
    "TestClusterScopedBindings-fresh-plane-clock": fresh_uses_plane_clock,
    "TestClusterScopedBindings-cluster-role": cluster_role_via_crb,
    "TestFederatedResourceQuota": frq_static_and_live_usage,
    "TestRemedy": traffic_control_on_condition,
    "TestServiceNameResolutionDetector-follows-probe": sn_detector_follows_probe,
    "TestServiceNameResolutionDetector-feeds-remedy": sn_detector_feeds_remedy,
    "TestDetectorLifecycle-unjoin": stale_detector_deactivated,
    "TestDetectorLifecycle-replace": replacing_detector,
    "TestAddons-estimator-toggle": estimator_toggle,
    "TestAddons-estimator-later-joins": estimator_covers_later_joins,
    "ControlPlane-disabled-scheduler-plugins": disabled_taint_plugin,
    "ControlPlane-scheduler-filter-plugins": custom_filter_plugin,
    "ControlPlane-member-hpa-sync": member_hpa_sync,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_extras_scenario_equals_jax_plane(name, monkeypatch):
    run_both(SCENARIOS[name], monkeypatch)


@pytest.mark.parametrize("kind,obj", [
    ("WorkloadRebalancer", "empty"),
    ("FederatedResourceQuota", "over"),
    ("FederatedResourceQuota", "missing"),
])
def test_admission_refuses_as_jax(kind, obj):
    """The validators that came with the rebalancer and the FRQ status
    controller refuse what the JAX chain refuses, with its message."""
    msgs = []
    for pkg in PKGS:
        core, pol = mod(pkg, "api.core"), mod(pkg, "api.policy")
        webhook = mod(pkg, "webhook")
        if kind == "WorkloadRebalancer":
            ex = mod(pkg, "controllers.extras")
            bad = ex.WorkloadRebalancer(meta=core.ObjectMeta(name="r"))
        else:
            hard = {"cpu": 20_000} if obj == "over" else {"gpu": 1}
            bad = pol.FederatedResourceQuota(
                meta=core.ObjectMeta(name="q", namespace="default"),
                spec=pol.FederatedResourceQuotaSpec(overall={"cpu": 10_000}, static_assignments=[
                    pol.StaticClusterAssignment(cluster_name="m1", hard=hard)]))
        with pytest.raises(webhook.ValidationError) as err:
            webhook.default_admission_chain().admit(kind, bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------
# the drift rebalancer, the admission overrides and a patched engine
# --------------------------------------------------------------------------


def _drift_plane(p):
    """``tests/test_preemption.py``'s drift plane: two 8-CPU members, a
    dynamic-weight policy and four Deployments, settled; the rebalancer's
    ticker off (rounds by hand)."""
    cp = p.plane(enable_drift_rebalancer=True)
    cp.drift_rebalancer.active = False
    for name in ("c0", "c1"):
        cp.join_cluster(p.b.new_cluster(name, cpu="8", memory="100Gi", pods=1000))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="pol"))
    for i in range(4):
        cp.store.apply(p.b.new_deployment(f"w{i}", replicas=4, cpu="1", memory="1Gi"))
    cp.settle()
    return cp


def drift_rounds(p, record, seen):
    """``enable_drift_rebalancer``: a 64-CPU member joins, every placement
    drifts, and two rounds by hand trigger the budget's bindings; each
    round's stats are seen."""
    cp = _drift_plane(p)
    record(cp)
    cp.join_cluster(p.b.new_cluster("c2", cpu="64", memory="100Gi", pods=1000))
    cp.settle()
    for _ in range(2):
        # a trigger is consumed by a schedule time after its stamp
        p.clock.now += 10
        seen.append(cp.drift_rebalancer.rebalance_once())
        record(cp)
        p.clock.now += 10
        cp.settle()
        record(cp)
    first, second = seen
    assert first["budget"] == 2 and first["drifted"] >= 3 and len(first["triggered"]) == 2
    assert all("c2" in placed(cp.store.get("ResourceBinding", key))
               for key in first["triggered"])
    # the re-placed rows score 0; the rows past the first budget trigger
    assert second["triggered"] and not set(first["triggered"]) & set(second["triggered"])


def drift_ticker(p, record, seen):
    """The rebalancer's ticker: switched on, it runs a round on every
    settle pass until no placement drifts."""
    cp = _drift_plane(p)
    cp.join_cluster(p.b.new_cluster("c2", cpu="64", memory="100Gi", pods=1000))
    cp.drift_rebalancer.active = True
    for _ in range(3):
        p.clock.now += 10
        cp.settle()
    record(cp)
    seen.append(cp.drift_rebalancer.last_round)
    assert seen[-1]["scored"] == 4


def admission_overrides(p, record, seen):
    """``admission_override`` and ``delete_admission_override``: every store
    write and delete goes through the external hooks, which wrap the
    in-process chain, label the templates they admit, refuse one template
    and protect another from deletion."""
    chain = p.webhook.default_admission_chain()

    def admit(kind, obj):
        chain.admit(kind, obj)
        if kind == "Resource":
            if obj.meta.name == "blocked":
                raise p.webhook.ValidationError("blocked by the external hook")
            obj.meta.labels["admitted-by"] = "external"

    def admit_delete(kind, obj):
        chain.admit_delete(kind, obj)
        if kind == "Resource" and obj.meta.name == "keep":
            raise p.webhook.ValidationError("keep is protected")
        seen.append((kind, obj.meta.namespaced_name))

    cp = p.plane(admission_override=admit, delete_admission_override=admit_delete)
    for i in (1, 2):
        cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    for name in ("web", "keep"):
        cp.store.apply(p.b.new_deployment(name, replicas=4))
    with pytest.raises(p.webhook.ValidationError):
        cp.store.apply(p.b.new_deployment("blocked", replicas=4))
    cp.settle()
    record(cp)
    assert cp.store.get("Resource", "default/blocked") is None
    with pytest.raises(p.webhook.ValidationError):
        cp.store.delete("Resource", "default/keep")
    cp.store.delete("Resource", "default/web")
    cp.settle()
    record(cp)
    (rb,) = cp.store.list("ResourceBinding")
    assert rb.meta.namespaced_name == "default/keep-deployment"
    for name in placed(rb):
        obj = cp.members.get(name).get("apps/v1/Deployment", "default", "keep")
        assert obj.meta.labels["admitted-by"] == "external"
    assert ("Resource", "default/web") in seen


def patched_engine(p, record, seen):
    """A double with the narrow ``schedule(problems)`` signature patched
    over the engine's method (as ``tests/test_preemption.py`` spies on the
    waves): the controller calls it without ``dirty_keys``, on its waves and
    on the drift rebalancer's dry solves. The waves it sees are seen."""
    cls = mod(p.pkg, "scheduler").TensorScheduler
    orig = cls.schedule

    def spy(self, problems):
        seen.append([(pr.key, getattr(pr, "priority", 0)) for pr in problems])
        return orig(self, problems)

    cls.schedule = spy
    try:
        drift_rounds(p, record, [])
    finally:
        cls.schedule = orig
    assert len(seen) > 2


OPTION_SCENARIOS = {
    "ControlPlane-drift-rebalancer-rounds": drift_rounds,
    "ControlPlane-drift-rebalancer-ticker": drift_ticker,
    "ControlPlane-admission-overrides": admission_overrides,
    "SchedulerController-patched-engine": patched_engine,
}


@pytest.mark.parametrize("name", list(OPTION_SCENARIOS))
def test_plane_option_equals_jax_plane(name, monkeypatch):
    """The scenario's states after every settle and what it saw (round
    stats, deletes, engine waves) equal the JAX plane's."""
    monkeypatch.setenv(mod(PKGS[1], "controllers.rebalance").BUDGET_ENV, "2")
    seen = {}
    run_both(lambda p, record: OPTION_SCENARIOS[name](
        p, record, seen.setdefault(p.pkg.__name__, [])), monkeypatch)
    want, got = (seen[pkg.__name__] for pkg in PKGS)
    assert want and got == want
