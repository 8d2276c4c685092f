"""Failover machinery: graceful eviction, application failover, descheduler.

The port's own copy of ``karmada_tpu/controllers/failover.py``. Ref:
- graceful-eviction controllers (pkg/controllers/gracefuleviction/
  evictiontask.go:36-150): keep the evicted cluster's workload until the
  replacement is healthy or a timeout passes, then drop the task (the
  binding controller then garbage-collects the Work).
- application-failover controllers (pkg/controllers/applicationfailover/
  rb_application_failover_controller.go:61-165): unhealthy longer than
  TolerationSeconds -> evict the cluster with the policy's PurgeMode and
  state-preservation rules (StatefulFailoverInjection).
- descheduler (pkg/descheduler/descheduler.go:141-241): periodic sweep
  asking estimators for unschedulable replicas, shrinking spec.clusters to
  trigger scale rescheduling.
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.work import (
    EVICTION_REASON_APPLICATION_FAILURE,
    SCHEDULED,
    FULLY_APPLIED,
    ResourceBinding,
    TargetCluster,
)
from ..utils import DONE, Runtime, Store
from ..utils.features import (
    FAILOVER,
    STATEFUL_FAILOVER_INJECTION,
    feature_gate,
)
from .cluster import evict_binding

# default timeout after which an eviction task completes regardless
# (graceful-eviction controller --graceful-eviction-timeout, default 10m)
DEFAULT_EVICTION_TIMEOUT = 600.0


class GracefulEvictionController:
    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        timeout_seconds: float = DEFAULT_EVICTION_TIMEOUT,
        clock=time.time,
    ) -> None:
        self.store = store
        self.timeout = timeout_seconds
        self.clock = clock
        self.worker = runtime.new_worker("graceful-eviction", self._reconcile)
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            store.watch(kind, lambda e, k=kind: self.worker.enqueue((k, e.key)))
        runtime.add_ticker(self._sweep)

    def _sweep(self) -> None:
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            for rb in self.store.list(kind):
                if rb.spec.graceful_eviction_tasks:
                    self.worker.enqueue((kind, rb.meta.namespaced_name))

    def _reconcile(self, kind_key) -> Optional[str]:
        kind, key = kind_key
        rb = self.store.get(kind, key)
        if rb is None or not rb.spec.graceful_eviction_tasks:
            return DONE
        keep = []
        changed = False
        for task in rb.spec.graceful_eviction_tasks:
            if self._task_done(rb, task):
                changed = True  # drop the task; binding controller GCs work
            else:
                keep.append(task)
        if changed:
            rb.spec.graceful_eviction_tasks = keep
            self.store.apply(rb)
        return DONE

    def _task_done(self, rb: ResourceBinding, task) -> bool:
        """assessEvictionTasks (evictiontask.go:36-118): done when the new
        schedule result is healthy, or the task timed out, or deletion is
        suppressed-resolved."""
        now = self.clock()
        grace = (
            task.grace_period_seconds
            if task.grace_period_seconds is not None
            else self.timeout
        )
        if task.creation_timestamp and now - task.creation_timestamp > grace:
            return True
        if task.suppress_deletion is not None:
            return not task.suppress_deletion
        # replacement healthy: binding scheduled AND every scheduled cluster
        # reports healthy applied status (evictiontask.go:78-118)
        if not rb.spec.clusters:
            return False
        by_cluster = {i.cluster_name: i for i in rb.status.aggregated_status}
        for tc in rb.spec.clusters:
            item = by_cluster.get(tc.name)
            if item is None or not item.applied or item.health != "Healthy":
                return False
        return True


class ApplicationFailoverController:
    """Unhealthy-too-long applications get evicted and rescheduled."""

    def __init__(self, store: Store, runtime: Runtime, clock=time.time) -> None:
        self.store = store
        self.clock = clock
        # cluster -> first-unhealthy timestamp per binding key
        self._unhealthy_since: dict[tuple[str, str], float] = {}
        self.worker = runtime.new_worker("app-failover", self._reconcile)
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            store.watch(kind, lambda e, k=kind: self.worker.enqueue((k, e.key)))
        runtime.add_ticker(self._sweep)

    def _sweep(self) -> None:
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            for rb in self.store.list(kind):
                if rb.spec.failover is not None:
                    self.worker.enqueue((kind, rb.meta.namespaced_name))

    def _reconcile(self, kind_key) -> Optional[str]:
        kind, key = kind_key
        rb = self.store.get(kind, key)
        if rb is None or rb.spec.failover is None:
            return DONE
        app = getattr(rb.spec.failover, "application", None)
        if app is None:
            return DONE
        now = self.clock()
        toleration = app.decision_conditions_toleration_seconds
        changed = False
        for item in rb.status.aggregated_status:
            k = (key, item.cluster_name)
            if item.health == "Unhealthy":
                since = self._unhealthy_since.setdefault(k, now)
                if now - since >= toleration and any(
                    tc.name == item.cluster_name for tc in rb.spec.clusters
                ):
                    preserved = self._preserve_state(rb, item)
                    evict_binding(
                        rb,
                        item.cluster_name,
                        reason=EVICTION_REASON_APPLICATION_FAILURE,
                        producer="ResourceBindingApplicationFailover",
                        message="application unhealthy beyond toleration",
                        purge_mode=app.purge_mode,
                        grace_period_seconds=app.grace_period_seconds,
                        preserved_label_state=preserved,
                        now=now,
                    )
                    changed = True
                    self._unhealthy_since.pop(k, None)
            else:
                self._unhealthy_since.pop(k, None)
        if changed:
            self.store.apply(rb)
        return DONE

    def _preserve_state(self, rb: ResourceBinding, item) -> dict:
        """StatePreservation JSONPath extraction re-injected as labels on the
        replacement cluster (StatefulFailoverInjection,
        binding/common.go:117-121,153-176)."""
        app = rb.spec.failover.application
        if (
            not feature_gate.enabled(STATEFUL_FAILOVER_INJECTION)
            or not app.state_preservation
            or item.status is None
        ):
            return {}
        out = {}
        for name, path in app.state_preservation.items():
            value = item.status
            for part in path.strip(".").split("."):
                if isinstance(value, dict) and part in value:
                    value = value[part]
                else:
                    value = None
                    break
            if value is not None:
                out[name] = str(value)
        return out


class Descheduler:
    """Periodic unschedulable-replica reclaim (pkg/descheduler)."""

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        members,
        clock=None,
    ) -> None:
        import time as _time

        self.store = store
        self.members = members
        self.clock = clock or _time.time
        #: addon on/off switch — the ticker registration is permanent
        #: (Runtime has no removal), so disable must gate the pass itself
        self.active = True
        runtime.add_ticker(self.deschedule_once)

    def deschedule_once(self) -> None:
        """descheduleOnce (descheduler.go:162-206): for every binding, ask
        each target cluster's estimator for unschedulable replicas and shrink
        the schedule result accordingly (floor at 0); the scheduler then
        scale-reschedules the delta elsewhere."""
        if not self.active:
            return
        # GetUnschedulableReplicas inputs: pod-condition derived counts
        # (PodScheduled=False/Unschedulable past the threshold) merged with
        # simulation overrides — memoized per member per pass, computed
        # lazily on first reference so a tick with no bindings (or bindings
        # touching few clusters) never pays a fleet-wide pod scan.
        now = self.clock()
        counts: dict[str, dict[str, int]] = {}

        def member_counts(name: str) -> dict[str, int]:
            got = counts.get(name)
            if got is None:
                member = self.members.get(name)
                got = (
                    member.count_unschedulable(now)
                    if member is not None and member.reachable
                    else {}
                )
                counts[name] = got
            return got

        for kind in ("ResourceBinding", "ClusterResourceBinding"):
          for rb in self.store.list(kind):
            if rb.spec.replicas <= 0 or not rb.spec.clusters:
                continue
            workload_key = rb.spec.resource.namespaced_key
            new_targets = []
            changed = False
            for tc in rb.spec.clusters:
                unschedulable = member_counts(tc.name).get(workload_key, 0)
                if unschedulable > 0:
                    reduced = max(tc.replicas - unschedulable, 0)
                    changed = True
                    if reduced > 0:
                        new_targets.append(
                            TargetCluster(name=tc.name, replicas=reduced)
                        )
                else:
                    new_targets.append(tc)
            if changed:
                rb.spec.clusters = new_targets
                rb.meta.generation += 1  # triggers scale rescheduling
                self.store.apply(rb)
