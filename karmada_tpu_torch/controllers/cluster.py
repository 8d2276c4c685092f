"""Cluster lifecycle + status controllers and the NoExecute taint manager.

The port's own copy of ``karmada_tpu/controllers/cluster.py``. Ref:
- cluster-status-controller (pkg/controllers/status/cluster_status_controller.go):
  per-cluster heartbeat — health probe (Push) or the agent's Lease (Pull),
  Ready condition (:197-206), k8s version + API enablements (:242-258),
  node informers -> ResourceSummary (:260-284); the ``cluster.health``
  fault-injection seam (``utils.faultinject``) flips a member NotReady.
- cluster-controller (pkg/controllers/cluster/cluster_controller.go:64-93):
  condition->taint conversion (NotReady/Unreachable taint templates).
- taint-manager (pkg/controllers/cluster/taint_manager.go): NoExecute taints
  evict bindings that don't tolerate them (into graceful-eviction tasks when
  the GracefulEviction feature is on).
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.cluster import (
    NO_EXECUTE,
    NO_SCHEDULE,
    TAINT_CLUSTER_NOT_READY,
    TAINT_CLUSTER_UNREACHABLE,
    Cluster,
    ResourceSummary,
    Taint,
)
from ..api.core import Condition, set_condition
from ..api.work import (
    EVICTION_PRODUCER_TAINT_MANAGER,
    EVICTION_REASON_TAINT_UNTOLERATED,
    GracefulEvictionTask,
    TargetCluster,
)
from ..utils import DONE, Runtime, Store
from ..utils.features import FAILOVER, GRACEFUL_EVICTION, feature_gate
from ..utils.member import MemberClientRegistry

NOT_READY_TAINT = Taint(key=TAINT_CLUSTER_NOT_READY, effect=NO_SCHEDULE)
NOT_READY_EXECUTE_TAINT = Taint(key=TAINT_CLUSTER_NOT_READY, effect=NO_EXECUTE)
UNREACHABLE_EXECUTE_TAINT = Taint(key=TAINT_CLUSTER_UNREACHABLE, effect=NO_EXECUTE)


class ClusterStatusController:
    """Periodic member heartbeat -> Cluster.Status (run as a runtime ticker)."""

    #: how stale an agent lease may be before a Pull cluster degrades
    #: (ClusterLeaseDuration x renew fraction analogue)
    LEASE_GRACE_SECONDS = 120.0

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        members: MemberClientRegistry,
        clock=None,
        lease_grace_seconds: float = LEASE_GRACE_SECONDS,
    ) -> None:
        self.store = store
        self.members = members
        self.clock = clock or time.time
        self.lease_grace = lease_grace_seconds
        runtime.add_ticker(self.collect_all)
        # a lease renewal re-judges its cluster immediately — tickers run in
        # registration order, and the agent's renewal ticker registers after
        # this controller, so without this a recovered agent would stay
        # NotReady for a full extra settle pass
        store.watch("Lease", self._on_lease)

    def _on_lease(self, event) -> None:
        cluster = self.store.get("Cluster", event.obj.meta.name)
        if cluster is not None:
            self.collect(cluster)

    def collect_all(self) -> None:
        for cluster in self.store.list("Cluster"):
            self.collect(cluster)

    def collect(self, cluster: Cluster) -> None:
        from ..utils.faultinject import fault_point

        member = self.members.get(cluster.name)
        # chaos seam: an armed `cluster.health=down` rule flips
        # this member NotReady for the firing judgement — the same
        # condition->taint->NoExecute-eviction machinery a real outage
        # drives, replayable from the fault seed
        rule = fault_point("cluster.health", cluster.name)
        forced_down = rule is not None and rule.action == "down"
        if cluster.spec.sync_mode == "Pull":
            # the plane cannot probe Pull members; Ready is lease freshness
            # ALONE (monitorClusterHealth over the agent-renewed Lease) — a
            # dead agent degrades only after the grace period, by design
            lease = self.store.get("Lease", cluster.name)
            ready = (
                lease is not None
                and self.clock() - lease.renew_time < self.lease_grace
                and not forced_down
            )
            reason = "AgentLeaseRenewed" if ready else "AgentLeaseExpired"
        else:
            ready = member is not None and member.reachable and not forced_down
            reason = "ClusterReady" if ready else "ClusterNotReachable"
        # status collection still needs a live client regardless of how
        # Ready was judged
        reachable = (
            member is not None and member.reachable and not forced_down
        )
        changed = set_condition(
            cluster.status.conditions,
            Condition(type="Ready", status=ready, reason=reason),
        )
        if reachable:
            summary_alloc = member.summary_allocatable()
            summary_used = member.summary_allocated()
            new_summary = ResourceSummary(
                allocatable=summary_alloc,
                allocated=summary_used,
                allocatable_modelings=cluster.status.resource_summary.allocatable_modelings,
            )
            if (
                new_summary.allocatable != cluster.status.resource_summary.allocatable
                or new_summary.allocated != cluster.status.resource_summary.allocated
            ):
                cluster.status.resource_summary = new_summary
                changed = True
            if cluster.status.api_enablements != member.api_enablements:
                cluster.status.api_enablements = list(member.api_enablements)
                changed = True
            if cluster.status.kubernetes_version != member.kubernetes_version:
                cluster.status.kubernetes_version = member.kubernetes_version
                changed = True
        if changed:
            self.store.apply(cluster)


class ClusterController:
    """Condition->taint conversion + finalizer-style cleanup."""

    def __init__(self, store: Store, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.new_worker("cluster", self._reconcile)
        store.watch("Cluster", lambda e: self.worker.enqueue(e.key))

    def _reconcile(self, key: str) -> Optional[str]:
        cluster = self.store.get("Cluster", key)
        if cluster is None:
            return DONE
        ready = any(
            c.type == "Ready" and c.status for c in cluster.status.conditions
        )
        taints = [
            t
            for t in cluster.spec.taints
            if t.key not in (TAINT_CLUSTER_NOT_READY, TAINT_CLUSTER_UNREACHABLE)
        ]
        if not ready:
            # UpdateStatusCondition -> taint templates
            # (cluster_controller.go:64-93): NoSchedule immediately; NoExecute
            # drives eviction when cluster Failover is enabled
            taints.append(NOT_READY_TAINT)
            if feature_gate.enabled(FAILOVER):
                taints.append(NOT_READY_EXECUTE_TAINT)
        if taints != cluster.spec.taints:
            cluster.spec.taints = taints
            self.store.apply(cluster)
        return DONE


class TaintManager:
    """NoExecute taints -> evict intolerant bindings
    (cluster/taint_manager.go). With GracefulEviction on, eviction goes
    through spec.gracefulEvictionTasks; otherwise the cluster entry is
    dropped immediately."""

    def __init__(self, store: Store, runtime: Runtime, clock=None) -> None:
        self.store = store
        self.clock = clock or time.time
        self.worker = runtime.new_worker("taint-manager", self._reconcile)
        store.watch("Cluster", lambda e: self.worker.enqueue(e.key))

    def _reconcile(self, key: str) -> Optional[str]:
        cluster = self.store.get("Cluster", key)
        if cluster is None:
            return DONE
        no_execute = [t for t in cluster.spec.taints if t.effect == NO_EXECUTE]
        if not no_execute:
            return DONE
        if not feature_gate.enabled(FAILOVER):
            return DONE
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
          for rb in self.store.list(kind):
            if not any(tc.name == cluster.name for tc in rb.spec.clusters):
                continue
            tolerations = (
                rb.spec.placement.cluster_tolerations if rb.spec.placement else []
            )
            untolerated = [
                t
                for t in no_execute
                if not any(tol.tolerates(t) for tol in tolerations)
            ]
            if not untolerated:
                continue
            evict_binding(
                rb,
                cluster.name,
                reason=EVICTION_REASON_TAINT_UNTOLERATED,
                producer=EVICTION_PRODUCER_TAINT_MANAGER,
                message=f"cluster {cluster.name} has NoExecute taint "
                f"{untolerated[0].key}",
                # the injected clock must stamp eviction tasks, or the
                # timeout-drain math mixes fake and wall time
                now=self.clock(),
            )
            self.store.apply(rb)
        return DONE


def evict_binding(
    rb,
    cluster_name: str,
    *,
    reason: str,
    producer: str,
    message: str = "",
    purge_mode: str = "Graciously",
    grace_period_seconds=None,
    preserved_label_state: Optional[dict] = None,
    now: Optional[float] = None,
) -> None:
    """Move a cluster from spec.clusters into graceful-eviction tasks
    (binding_types_helper GracefulEvictCluster semantics). Without the
    GracefulEviction feature the cluster is dropped outright."""
    target = next((tc for tc in rb.spec.clusters if tc.name == cluster_name), None)
    if target is None:
        return
    rb.spec.clusters = [tc for tc in rb.spec.clusters if tc.name != cluster_name]
    if feature_gate.enabled(GRACEFUL_EVICTION):
        if not any(
            t.from_cluster == cluster_name for t in rb.spec.graceful_eviction_tasks
        ):
            rb.spec.graceful_eviction_tasks.append(
                GracefulEvictionTask(
                    from_cluster=cluster_name,
                    replicas=target.replicas,
                    reason=reason,
                    message=message,
                    producer=producer,
                    purge_mode=purge_mode,
                    grace_period_seconds=grace_period_seconds,
                    creation_timestamp=now if now is not None else time.time(),
                    preserved_label_state=dict(preserved_label_state or {}),
                    clusters_before_failover=[tc.name for tc in rb.spec.clusters]
                    + [cluster_name],
                )
            )
    rb.meta.generation += 1  # spec changed -> scheduler re-runs
