"""Native default interpreters for built-in workload kinds.

The port's own copy of ``karmada_tpu/interpreter/native.py``. Ref:
pkg/resourceinterpreter/default/native/*.go — Go implementations for
Deployment/StatefulSet/DaemonSet/Job/Pod/... Replica extraction with
pod-template resource requests, per-kind status aggregation/health, retain
semantics, dependency discovery (configmaps/secrets/PVCs/service accounts).

Resource layout follows kube conventions inside the free-form spec/status
dicts (spec.replicas, spec.template.spec.containers[*].resources.requests).
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Optional

from ..api.core import Resource
from ..api.work import AggregatedStatusItem, NodeClaim, ReplicaRequirements
from ..utils.clone import clone_resource
from ..utils.quantity import parse_quantity
from .facade import (
    AGGREGATE_STATUS,
    GET_DEPENDENCIES,
    GET_REPLICAS,
    INTERPRET_HEALTH,
    REFLECT_STATUS,
    RETAIN,
    REVISE_REPLICA,
    DependentObjectReference,
    ResourceInterpreter,
)

DEPLOYMENT = "apps/v1/Deployment"
STATEFULSET = "apps/v1/StatefulSet"
DAEMONSET = "apps/v1/DaemonSet"
JOB = "batch/v1/Job"
POD = "v1/Pod"

WORKLOAD_KINDS = (DEPLOYMENT, STATEFULSET, JOB, POD)


def pod_requests(pod_spec: dict) -> dict[str, int]:
    """Sum container resource requests in canonical units (the reference's
    ResourceRequest from pod template)."""
    total: dict[str, int] = {}
    for container in pod_spec.get("containers", []):
        for name, qty in container.get("resources", {}).get("requests", {}).items():
            total[name] = total.get(name, 0) + parse_quantity(qty, name)
    return total


def _template_pod_spec(obj: Resource) -> dict:
    return obj.spec.get("template", {}).get("spec", {})


def _node_claim(pod_spec: dict) -> Optional[NodeClaim]:
    selector = pod_spec.get("nodeSelector")
    tolerations = pod_spec.get("tolerations")
    if not selector and not tolerations:
        return None
    return NodeClaim(
        node_selector=dict(selector or {}), tolerations=list(tolerations or [])
    )


def _get_replicas_workload(obj: Resource) -> tuple[int, Optional[ReplicaRequirements]]:
    if _gvk(obj) == POD:
        replicas = 1
        pod_spec = obj.spec
    else:
        replicas = int(obj.spec.get("replicas", obj.spec.get("parallelism", 1)))
        pod_spec = _template_pod_spec(obj)
    reqs = ReplicaRequirements(
        resource_request=pod_requests(pod_spec),
        node_claim=_node_claim(pod_spec),
        namespace=obj.meta.namespace,
        priority_class_name=pod_spec.get("priorityClassName", ""),
    )
    return replicas, reqs


def _revise_replica(obj: Resource, replicas: int) -> Resource:
    out = clone_resource(obj)
    if _gvk(out) == JOB and "parallelism" in out.spec:
        out.spec["parallelism"] = replicas
    else:
        out.spec["replicas"] = replicas
    return out


def _reflect_status(obj: Resource) -> Optional[dict[str, Any]]:
    return obj.status or None


def _deployment_health(obj: Resource) -> bool:
    """deployment healthy: observed generation caught up and all replicas
    ready+updated (native/health.go semantics)."""
    st = obj.status or {}
    replicas = int(obj.spec.get("replicas", 0))
    return (
        int(st.get("readyReplicas", 0)) >= replicas
        and int(st.get("updatedReplicas", 0)) >= replicas
    )


def _pod_health(obj: Resource) -> bool:
    return (obj.status or {}).get("phase") in ("Running", "Succeeded")


def _job_health(obj: Resource) -> bool:
    st = obj.status or {}
    return int(st.get("failed", 0)) == 0


_SUM_FIELDS = {
    DEPLOYMENT: ("replicas", "readyReplicas", "updatedReplicas", "availableReplicas",
                 "unavailableReplicas"),
    STATEFULSET: ("replicas", "readyReplicas", "updatedReplicas", "availableReplicas"),
    DAEMONSET: ("currentNumberScheduled", "numberReady", "numberAvailable",
                "desiredNumberScheduled"),
    JOB: ("active", "succeeded", "failed"),
}


def _aggregate_status_sum(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    """Per-kind numeric status aggregation across member clusters
    (native/aggregatestatus.go pattern: sum counters into the template)."""
    out = clone_resource(obj)
    fields = _SUM_FIELDS.get(_gvk(obj), ())
    agg: dict[str, Any] = {f: 0 for f in fields}
    for item in items:
        st = item.status or {}
        for f in fields:
            agg[f] += int(st.get(f, 0))
    out.status = {**(out.status or {}), **agg}
    return out


def _aggregate_lb_ingress(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    """Service(LoadBalancer)/Ingress: concatenate every member's
    status.loadBalancer.ingress, defaulting hostname to the member name so
    consumers can tell where each VIP came from
    (native/aggregatestatus.go:123-205). Non-LoadBalancer Services keep
    their status untouched."""
    out = clone_resource(obj)
    if _gvk(obj) == "v1/Service" and (obj.spec or {}).get("type") != "LoadBalancer":
        return out
    merged = []
    for item in items:
        for ing in ((item.status or {}).get("loadBalancer") or {}).get("ingress", []) or []:
            ing = dict(ing)
            if not ing.get("hostname"):
                ing["hostname"] = item.cluster_name
            merged.append(ing)
    out.status = {**(out.status or {}), "loadBalancer": {"ingress": merged}}
    return out


#: final-phase precedence (aggregatestatus.go:444-456): any Failed member
#: fails the whole pod; missing status counts as Pending
_POD_PHASE_ORDER = ("Failed", "Pending", "Running", "Succeeded")


def _aggregate_pod(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    out = clone_resource(obj)
    phases = set()
    containers: list[dict] = []
    init_containers: list[dict] = []
    for item in items:
        st = item.status
        if not st:
            phases.add("Pending")
            continue
        phases.add(st.get("phase", "Pending"))
        for cs in st.get("containerStatuses", []) or []:
            containers.append({"ready": cs.get("ready", False),
                              "state": cs.get("state", {})})
        for cs in st.get("initContainerStatuses", []) or []:
            init_containers.append({"ready": cs.get("ready", False),
                                    "state": cs.get("state", {})})
    phase = next((p for p in _POD_PHASE_ORDER if p in phases), "Pending")
    out.status = {
        "phase": phase,
        "containerStatuses": containers,
        "initContainerStatuses": init_containers,
    }
    return out


def _aggregate_pvc(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    """Bound only when every member is Bound; any Lost member loses the
    claim outright (aggregatestatus.go:521-557)."""
    out = clone_resource(obj)
    phase = "Bound"
    for item in items:
        p = (item.status or {}).get("phase")
        if p == "Lost":
            phase = "Lost"
            break
        if p and p != "Bound":
            phase = p
    out.status = {**(out.status or {}), "phase": phase}
    return out


def _aggregate_pdb(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    """Sum healthy/expected/allowed counters; disruptedPods are namespaced
    by member name to stay distinguishable (aggregatestatus.go:559-600)."""
    out = clone_resource(obj)
    agg = {"currentHealthy": 0, "desiredHealthy": 0, "expectedPods": 0,
           "disruptionsAllowed": 0}
    disrupted: dict[str, Any] = {}
    for item in items:
        st = item.status or {}
        for f in agg:
            agg[f] += int(st.get(f, 0))
        for pod_name, when in (st.get("disruptedPods") or {}).items():
            disrupted[f"{item.cluster_name}/{pod_name}"] = when
    out.status = {**(out.status or {}), **agg, "disruptedPods": disrupted}
    return out


def _aggregate_hpa(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    out = clone_resource(obj)
    agg = {"currentReplicas": 0, "desiredReplicas": 0}
    for item in items:
        st = item.status or {}
        for f in agg:
            agg[f] += int(st.get(f, 0))
    out.status = {**(out.status or {}), **agg}
    return out


def _ts_sort_key(val: str):
    """Parse an RFC3339 timestamp for chronological comparison. Raw string
    comparison is only chronological when every member emits identical
    formatting (Z vs +00:00, fractional seconds) — the reference compares
    parsed metav1.Time values (aggregatestatus.go:232-271)."""
    try:
        dt = datetime.fromisoformat(val.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt
    except ValueError:
        return datetime.min.replace(tzinfo=timezone.utc)


def _aggregate_cronjob(obj: Resource, items: list[AggregatedStatusItem]) -> Resource:
    """Concatenate active job refs, keep the chronologically latest
    schedule/success times — aggregatestatus.go:232-271."""
    out = clone_resource(obj)
    active: list = []
    last_schedule = None
    last_success = None
    for item in items:
        st = item.status or {}
        active.extend(st.get("active", []) or [])
        for field, cur in (("lastScheduleTime", last_schedule),
                           ("lastSuccessfulTime", last_success)):
            val = st.get(field)
            if val and (cur is None or _ts_sort_key(val) > _ts_sort_key(cur)):
                if field == "lastScheduleTime":
                    last_schedule = val
                else:
                    last_success = val
    out.status = {**(out.status or {}), "active": active,
                  "lastScheduleTime": last_schedule,
                  "lastSuccessfulTime": last_success}
    return out


def _retain_default(desired: Resource, observed: Resource) -> Resource:
    """Keep member-side mutated fields the control plane must not stomp
    (native/retain.go): nodeName on pods, clusterIP on services, and
    member-HPA-owned replica counts (the hpaScaleTargetMarker label marks
    workloads whose replicas belong to the members)."""
    out = clone_resource(desired)
    if _gvk(desired) == POD:
        node_name = observed.spec.get("nodeName")
        if node_name:
            out.spec["nodeName"] = node_name
    if _gvk(desired) == "v1/Service":
        cluster_ip = observed.spec.get("clusterIP")
        if cluster_ip:
            out.spec["clusterIP"] = cluster_ip
    if (
        desired.meta.labels.get("resourcetemplate.karmada.io/retain-replicas")
        == "true"
        and "replicas" in observed.spec
    ):
        out.spec["replicas"] = observed.spec["replicas"]
    return out


def _get_dependencies(obj: Resource) -> list[DependentObjectReference]:
    """Dependencies from the pod template: configmaps/secrets/PVCs/service
    account (default/native/dependencies.go)."""
    pod_spec = obj.spec if _gvk(obj) == POD else _template_pod_spec(obj)
    return pod_spec_dependencies(pod_spec, obj.meta.namespace)


def pod_spec_dependencies(
    pod_spec: dict, ns: str
) -> list[DependentObjectReference]:
    """Walk a bare pod spec for referenced objects — shared with the
    declarative DSL's pod_template_path rule (kube.getPodDependencies)."""
    deps: list[DependentObjectReference] = []
    seen: set[tuple[str, str]] = set()

    def add(kind: str, api_version: str, name: str) -> None:
        if name and (kind, name) not in seen:
            seen.add((kind, name))
            deps.append(
                DependentObjectReference(
                    api_version=api_version, kind=kind, namespace=ns, name=name
                )
            )

    for vol in pod_spec.get("volumes", []):
        if "configMap" in vol:
            add("ConfigMap", "v1", vol["configMap"].get("name", ""))
        if "secret" in vol:
            add("Secret", "v1", vol["secret"].get("secretName", ""))
        if "persistentVolumeClaim" in vol:
            add("PersistentVolumeClaim", "v1",
                vol["persistentVolumeClaim"].get("claimName", ""))
    for container in pod_spec.get("containers", []):
        for env in container.get("env", []):
            ref = env.get("valueFrom", {})
            if "configMapKeyRef" in ref:
                add("ConfigMap", "v1", ref["configMapKeyRef"].get("name", ""))
            if "secretKeyRef" in ref:
                add("Secret", "v1", ref["secretKeyRef"].get("name", ""))
        for src in container.get("envFrom", []):
            if "configMapRef" in src:
                add("ConfigMap", "v1", src["configMapRef"].get("name", ""))
            if "secretRef" in src:
                add("Secret", "v1", src["secretRef"].get("name", ""))
    sa = pod_spec.get("serviceAccountName")
    if sa and sa != "default":
        add("ServiceAccount", "v1", sa)
    return deps


def _gvk(obj: Resource) -> str:
    return f"{obj.api_version}/{obj.kind}"


def register_native_interpreters(interp: ResourceInterpreter) -> None:
    for gvk in (DEPLOYMENT, STATEFULSET, DAEMONSET, JOB, POD):
        interp.register_native(gvk, GET_REPLICAS, _get_replicas_workload)
        interp.register_native(gvk, REVISE_REPLICA, _revise_replica)
        interp.register_native(gvk, AGGREGATE_STATUS, _aggregate_status_sum)
        interp.register_native(gvk, GET_DEPENDENCIES, _get_dependencies)
    # per-kind status aggregators beyond the counter sums
    # (native/aggregatestatus.go:123-645)
    interp.register_native("v1/Service", AGGREGATE_STATUS, _aggregate_lb_ingress)
    interp.register_native(
        "networking.k8s.io/v1/Ingress", AGGREGATE_STATUS, _aggregate_lb_ingress
    )
    interp.register_native(POD, AGGREGATE_STATUS, _aggregate_pod)
    interp.register_native(
        "v1/PersistentVolumeClaim", AGGREGATE_STATUS, _aggregate_pvc
    )
    interp.register_native(
        "policy/v1/PodDisruptionBudget", AGGREGATE_STATUS, _aggregate_pdb
    )
    interp.register_native(
        "autoscaling/v2/HorizontalPodAutoscaler", AGGREGATE_STATUS, _aggregate_hpa
    )
    interp.register_native("batch/v1/CronJob", AGGREGATE_STATUS, _aggregate_cronjob)
    interp.register_native("*", REFLECT_STATUS, _reflect_status)
    interp.register_native("*", RETAIN, _retain_default)
    interp.register_native(DEPLOYMENT, INTERPRET_HEALTH, _deployment_health)
    interp.register_native(STATEFULSET, INTERPRET_HEALTH, _deployment_health)
    interp.register_native(POD, INTERPRET_HEALTH, _pod_health)
    interp.register_native(JOB, INTERPRET_HEALTH, _job_health)
