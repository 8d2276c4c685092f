"""Member-cluster clients: the boundary to each member's state.

The port's own copy of the client surface of ``karmada_tpu/utils/member.py``.
Ref analogues: pkg/util/membercluster_client.go (per-cluster clients),
pkg/util/objectwatcher/objectwatcher.go:43-307 (versioned create/update/
delete of propagated objects), pkg/util/fedinformer (per-cluster informers —
here watch handlers on the member store).

A MemberCluster is an in-process stand-in for one member kube-apiserver:
resources keyed by (gvk, namespace, name), node state for the cluster's
resource summary, the pods and unschedulable counts the descheduler and the
estimator refresh read, the metric surfaces the metrics adapter and the
FederatedHPA controller read (aggregate and per-pod workload samples, pod and
node metrics, custom and external metric series), and a reachability flag
for failure injection. A real deployment replaces this class with a REST
client; the controller code above it is transport-agnostic. The JAX module's
pod log, exec and proxy seams serve the search cache and the proxy, which
the port does not carry yet (ROADMAP A7b).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from ..api.core import Resource
from ..estimator.accurate import NodeState
from .clone import clone_resource


class UnreachableError(Exception):
    pass


class ConflictError(Exception):
    """Propagation target already exists and is not managed by the control
    plane (ConflictResolution=Abort)."""


MANAGED_ANNOTATION = "karmada.io/managed"


@dataclass(frozen=True)
class MemberEvent:
    type: str  # Added | Modified | Deleted
    cluster: str
    gvk: str
    namespace: str
    name: str
    obj: Resource


class MemberCluster:
    """One member cluster's state."""

    def __init__(self, name: str):
        self.name = name
        self.reachable = True
        self.kubernetes_version = "v1.31.0"
        self.api_enablements: list[str] = [
            "apps/v1/Deployment",
            "apps/v1/StatefulSet",
            "batch/v1/Job",
            "v1/Pod",
            "v1/ConfigMap",
            "v1/Secret",
            "v1/Service",
            "v1/ServiceAccount",
        ]
        self.nodes: list[NodeState] = []
        # workload-key -> unschedulable replica count (descheduler input;
        # ref: estimator server/replica/replica.go)
        self.unschedulable_replicas: dict[str, int] = {}
        # workload-key -> metric sample {"pods", "ready_pods",
        # "cpu_utilization"} (metrics.k8s.io stand-in for the metrics adapter)
        self.pod_metrics: dict[str, dict] = {}
        # workload-key -> PER-POD sample set (the federated podList the
        # FederatedHPA replica calculator groups by readiness; field names
        # are controllers.replica_calculator.PodSample kwargs — request/
        # value in milli-units): [{"name", "phase", "ready", "request",
        # "value", ...}, ...]
        self.workload_pods: dict[str, list[dict]] = {}
        # metrics.k8s.io per-object surfaces (metricsadapter ResourceMetrics):
        # "namespace/pod" -> {"cpu": milli, "memory": bytes, "labels": {...}}
        self.pod_metrics_detail: dict[str, dict] = {}
        # node name -> {"cpu": milli, "memory": bytes, "labels": {...}}
        self.node_metrics: dict[str, dict] = {}
        # custom.metrics.k8s.io series (metricsadapter CustomMetrics): each
        # {"resource": "pods", "namespaced": bool, "namespace": str,
        #  "object": str, "metric": str, "value": float, "labels": {...}}
        self.custom_metric_series: list[dict] = []
        # external.metrics.k8s.io series: each {"namespace": str,
        #  "metric": str, "value": float, "labels": {...}}
        self.external_metric_series: list[dict] = []
        self._resources: dict[tuple[str, str, str], Resource] = {}
        self._watchers: list[Callable[[MemberEvent], None]] = []
        self._lock = threading.RLock()

    # -- client surface ----------------------------------------------------

    def _check(self) -> None:
        if not self.reachable:
            raise UnreachableError(f"cluster {self.name} unreachable")

    def apply(self, obj: Resource) -> Resource:
        self._check()
        key = (f"{obj.api_version}/{obj.kind}", obj.meta.namespace, obj.meta.name)
        with self._lock:
            existed = key in self._resources
            obj.meta.resource_version += 1
            self._resources[key] = obj
        self._notify(
            MemberEvent(
                "Modified" if existed else "Added",
                self.name, key[0], key[1], key[2], obj,
            )
        )
        return obj

    def get(self, gvk: str, namespace: str, name: str) -> Optional[Resource]:
        self._check()
        with self._lock:
            return self._resources.get((gvk, namespace, name))

    def delete(self, gvk: str, namespace: str, name: str) -> Optional[Resource]:
        self._check()
        with self._lock:
            obj = self._resources.pop((gvk, namespace, name), None)
        if obj is not None:
            self._notify(MemberEvent("Deleted", self.name, gvk, namespace, name, obj))
        return obj

    def list(self, gvk: Optional[str] = None) -> list[Resource]:
        self._check()
        with self._lock:
            return [
                o for (g, _, _), o in self._resources.items() if gvk is None or g == gvk
            ]

    def watch(self, handler: Callable[[MemberEvent], None]) -> None:
        self._watchers.append(handler)

    def _notify(self, event: MemberEvent) -> None:
        for h in list(self._watchers):
            h(event)

    # -- pods and unschedulable counting -----------------------------------

    def add_pod(
        self,
        namespace: str,
        name: str,
        *,
        owner_key: str = "",
        conditions: Optional[list[dict]] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> Resource:
        """Register a pod in the member state. Pods are ordinary "v1/Pod"
        resources; ``owner_key`` links the pod to its workload (the stand-in
        for the ownerRef/label-selector match in estimator
        server/replica/replica.go:43-77)."""
        from ..api.core import ObjectMeta

        pod = Resource(
            api_version="v1",
            kind="Pod",
            meta=ObjectMeta(namespace=namespace, name=name, labels=dict(labels or {})),
            spec={"owner_key": owner_key},
            status={"conditions": list(conditions or [])},
        )
        return self.apply(pod)

    def mark_pod_unschedulable(
        self, namespace: str, name: str, since: float
    ) -> None:
        """Set the PodScheduled=False/Unschedulable condition (the signal
        GetUnschedulableReplicas counts)."""
        pod = self.get("v1/Pod", namespace, name)
        if pod is None:
            return
        conds = [
            c
            for c in pod.status.setdefault("conditions", [])
            if c.get("type") != "PodScheduled"
        ]
        conds.append(
            {
                "type": "PodScheduled",
                "status": "False",
                "reason": "Unschedulable",
                "last_transition": since,
            }
        )
        pod.status["conditions"] = conds
        self.apply(pod)

    def count_unschedulable(
        self, now: float, threshold_seconds: float = 60.0
    ) -> dict[str, int]:
        """workload-key -> replicas stuck PodScheduled=False/Unschedulable
        for longer than the threshold (ref: server/replica/replica.go:43-77;
        the threshold mirrors --unschedulable-threshold). Explicit
        ``unschedulable_replicas`` entries (simulation overrides) are merged
        in, taking the max per workload."""
        counts: dict[str, int] = {}
        for pod in self.list("v1/Pod"):
            owner = (pod.spec or {}).get("owner_key", "")
            if not owner:
                continue
            for cond in (pod.status or {}).get("conditions", []):
                if (
                    cond.get("type") == "PodScheduled"
                    and cond.get("status") == "False"
                    and cond.get("reason") == "Unschedulable"
                    and now - cond.get("last_transition", now) >= threshold_seconds
                ):
                    counts[owner] = counts.get(owner, 0) + 1
                    break
        for key, n in self.unschedulable_replicas.items():
            counts[key] = max(counts.get(key, 0), n)
        return counts

    # -- member-side simulation helpers (tests / failure injection) --------

    def set_workload_status(
        self, gvk: str, namespace: str, name: str, status: dict
    ) -> None:
        obj = self.get(gvk, namespace, name)
        if obj is not None:
            obj.status = dict(status)
            self.apply(obj)

    def summary_allocatable(self) -> dict[str, int]:
        total: dict[str, int] = {}
        for n in self.nodes:
            for k, v in n.allocatable.items():
                total[k] = total.get(k, 0) + v
        return total

    def summary_allocated(self) -> dict[str, int]:
        total: dict[str, int] = {}
        for n in self.nodes:
            for k, v in n.requested.items():
                total[k] = total.get(k, 0) + v
        return total


class MemberClientRegistry:
    def __init__(self) -> None:
        self._clients: dict[str, MemberCluster] = {}

    def register(self, member: MemberCluster) -> None:
        self._clients[member.name] = member

    def deregister(self, name: str) -> None:
        self._clients.pop(name, None)

    def get(self, name: str) -> Optional[MemberCluster]:
        return self._clients.get(name)

    def names(self) -> Iterable[str]:
        return list(self._clients)


class ObjectWatcher:
    """Versioned create/update/delete of propagated objects into members
    (objectwatcher.go:75-307): records the version it wrote, so a re-apply
    of the same manifest onto an un-drifted member is a no-op, and runs the
    interpreter's Retain hook on update."""

    def __init__(self, members: MemberClientRegistry, interpreter) -> None:
        self.members = members
        self.interpreter = interpreter
        # (cluster, gvk, ns, name) -> (desired manifest pin, applied rv,
        # conflict_resolution): re-applying the SAME manifest object onto an
        # un-drifted member is a no-op, and the execution controller echoes
        # one such apply per Work condition update — the pin (a strong ref,
        # so the id cannot be recycled) collapses that loop. Any member
        # drift changes the observed resource_version and misses the cache.
        self._applied: dict[tuple[str, str, str, str], tuple] = {}

    def create_or_update(
        self, cluster: str, desired: Resource, conflict_resolution: str = "Overwrite"
    ) -> Resource:
        member = self.members.get(cluster)
        if member is None:
            raise UnreachableError(f"no client for cluster {cluster}")
        gvk = f"{desired.api_version}/{desired.kind}"
        vkey = (cluster, gvk, desired.meta.namespace, desired.meta.name)
        observed = member.get(gvk, desired.meta.namespace, desired.meta.name)
        cached = self._applied.get(vkey)
        if (
            cached is not None
            and cached[0] is desired
            and observed is not None
            and observed.meta.resource_version == cached[1]
            and conflict_resolution == cached[2]
        ):
            return observed
        if observed is not None:
            # an unmanaged pre-existing object is a conflict
            # (execution_controller + objectwatcher ConflictResolution)
            if (
                observed.meta.annotations.get(MANAGED_ANNOTATION) != "true"
                and conflict_resolution == "Abort"
            ):
                raise ConflictError(
                    f"{gvk} {desired.meta.namespaced_name} already exists in "
                    f"{cluster} and is not managed"
                )
            # retain() tiers return a fresh object; clone only if a no-hook
            # tier passed `desired` straight through (one copy per apply)
            to_apply = self.interpreter.retain(desired, observed)
            if to_apply is desired:
                to_apply = clone_resource(desired)
            to_apply.meta.annotations[MANAGED_ANNOTATION] = "true"
            to_apply.meta.resource_version = observed.meta.resource_version
            # member status is owned by the member; never push it down
            to_apply.status = observed.status
        else:
            to_apply = clone_resource(desired)
            to_apply.meta.annotations[MANAGED_ANNOTATION] = "true"
        applied = member.apply(to_apply)
        self._applied[vkey] = (
            desired, applied.meta.resource_version, conflict_resolution,
        )
        return applied

    def delete(self, cluster: str, gvk: str, namespace: str, name: str) -> None:
        member = self.members.get(cluster)
        if member is None:
            return
        member.delete(gvk, namespace, name)
        self._applied.pop((cluster, gvk, namespace, name), None)
