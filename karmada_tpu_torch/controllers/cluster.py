"""Cluster lifecycle and status controllers, and graceful eviction.

The port's own copy of ``karmada_tpu/controllers/cluster.py``. Ref:
- cluster-status-controller (pkg/controllers/status/cluster_status_controller.go):
  per-cluster heartbeat — health probe, Ready condition (:197-206), k8s
  version + API enablements (:242-258), node informers -> ResourceSummary
  (:260-284).
- cluster-controller (pkg/controllers/cluster/cluster_controller.go:64-93):
  condition->taint conversion (NotReady/Unreachable taint templates).
The NoExecute taint manager comes with the failover controllers, and the
JAX module's chaos seam in ``collect`` with the fault-injection tooling.
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
from ..api.work import GracefulEvictionTask
from ..utils import DONE, Runtime, Store
from ..utils.features import FAILOVER, GRACEFUL_EVICTION, feature_gate
from ..utils.member import MemberClientRegistry

NOT_READY_TAINT = Taint(key=TAINT_CLUSTER_NOT_READY, effect=NO_SCHEDULE)
NOT_READY_EXECUTE_TAINT = Taint(key=TAINT_CLUSTER_NOT_READY, effect=NO_EXECUTE)


class ClusterStatusController:
    """Periodic member heartbeat -> Cluster.Status (run as a runtime ticker).

    Push members only: Ready is the probe of the plane's own client. The
    JAX module's Pull branch (Ready from the agent's Lease) comes with the
    Pull agent."""

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        members: MemberClientRegistry,
    ) -> None:
        self.store = store
        self.members = members
        runtime.add_ticker(self.collect_all)

    def collect_all(self) -> None:
        for cluster in self.store.list("Cluster"):
            self.collect(cluster)

    def collect(self, cluster: Cluster) -> None:
        member = self.members.get(cluster.name)
        ready = member is not None and member.reachable
        reason = "ClusterReady" if ready else "ClusterNotReachable"
        changed = set_condition(
            cluster.status.conditions,
            Condition(type="Ready", status=ready, reason=reason),
        )
        if ready:
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
