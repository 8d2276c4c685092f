"""Declarative interpreter customizations: user-defined resource semantics.

The port's own copy of ``karmada_tpu/interpreter/declarative.py``.

Ref: pkg/apis/config/v1alpha1 ResourceInterpreterCustomization +
pkg/resourceinterpreter/customized/declarative (gopher-lua VM pool,
lua.go:46-316) and the configmanager that (de)registers customizations on CR
changes.

The reference embeds Lua; this build's declarative layer is a *path DSL* —
each operation is configured with JSONPath-ish field paths and simple
expressions, which covers the thirdparty customization corpus (replica
fields, status remaps, health predicates) without an embedded VM. Fully
programmatic extensions use ResourceInterpreter.register_customized
(the webhook-interpreter analogue).

DSL fields (all optional, per operation):
- replica_path: dotted path to the replica count (GetReplicas/ReviseReplica)
- replica_default: replica count when replica_path is unset on the object
  (argo Workflow/BroadcastJob default to 1 when .spec.parallelism is nil)
- requests_path: dotted path to a per-replica resource-request map
- pod_requests_path: dotted spec path of a pod template whose container
  requests form the per-replica requirements (kube.accuratePodRequirements)
- status_paths: list of status fields to reflect (ReflectStatus)
- health: predicate list, ANDed (InterpretHealth). Forms:
    {path, op (==|!=|>=|<=|in|exists), value}        — direct status field
    {path, op, spec_path} / {path, op, status_path}  — compare two fields
    {condition: type, status: "True", reason: r?}    — scan status.conditions
    {observed_generation: true}                      — status.observedGeneration
                                                       == metadata.generation
    {any: [sub-predicates]}                          — OR group
- status_aggregation: {field: "sum"|"max"|"min"|"last"|"and"|"or"}
  ("last" = last non-empty, for revisions/selectors)
- status_zero_fields: numeric fields zero-filled when no member statuses
- aggregate_observed_generation: set status.observedGeneration to
  metadata.generation once every member has observed its own generation
- retain_paths: spec paths copied observed→desired (Retain; flux
  spec.suspend carry-over pattern)
- retain_status: carry the whole observed status into desired (argo)
- dependencies: list of (GetDependencies):
    {kind, api_version, name_path, namespace_path?}  — single ref
    {list_path, name_field, kind | kind_field, api_version} — ref list
    {pod_template_path}  — walk a pod template for configmaps/secrets/
                           PVCs/serviceaccounts (kube.getPodDependencies)
"""

from __future__ import annotations

from ..utils.clone import clone_json, clone_resource
from dataclasses import dataclass, field
from typing import Any, Optional

from ..api.core import ObjectMeta, Resource
from ..api.work import AggregatedStatusItem, ReplicaRequirements
from ..utils import DONE, Runtime, Store
from ..utils.quantity import parse_resource_list
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


def get_path(obj: Any, path: str) -> Any:
    node = obj
    for part in path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        elif isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
        if node is None:
            return None
    return node


def set_path(obj: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    node = obj
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


@dataclass
class CustomizationRules:
    replica_path: str = ""
    replica_default: int = 0
    requests_path: str = ""
    pod_requests_path: str = ""
    status_paths: list[str] = field(default_factory=list)
    health: list[dict] = field(default_factory=list)
    status_aggregation: dict[str, str] = field(default_factory=dict)
    status_zero_fields: list[str] = field(default_factory=list)
    aggregate_observed_generation: bool = False
    retain_paths: list[str] = field(default_factory=list)
    retain_status: bool = False
    dependencies: list[dict] = field(default_factory=list)
    # --- expression tier (mirrors the reference CR's luaScript slots,
    # config/v1alpha1 CustomizationTarget: replicaResource/replicaRevision/
    # retention/statusAggregation/healthInterpretation/statusReflection/
    # dependencyInterpretation). A script field, when set, OVERRIDES the
    # path-DSL for that operation; syntax is the sandboxed expression
    # language of interpreter/exprlang.py with the same entry-point names
    # the reference's Lua VM dispatches to (lua.go:46-316).
    replica_resource_script: str = ""  # GetReplicas(observedObj)
    replica_revision_script: str = ""  # ReviseReplica(desiredObj, replica)
    retention_script: str = ""  # Retain(desiredObj, observedObj)
    status_aggregation_script: str = ""  # AggregateStatus(desiredObj, items)
    health_script: str = ""  # InterpretHealth(observedObj)
    status_reflection_script: str = ""  # ReflectStatus(observedObj)
    dependency_script: str = ""  # GetDependencies(desiredObj)


@dataclass
class ResourceInterpreterCustomization:
    KIND = "ResourceInterpreterCustomization"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    target_api_version: str = ""
    target_kind: str = ""
    rules: CustomizationRules = field(default_factory=CustomizationRules)

    @property
    def target_gvk(self) -> str:
        return f"{self.target_api_version}/{self.target_kind}"


def _check_predicate(pred: dict, obj: Resource) -> bool:
    st = obj.status or {}
    if "any" in pred:
        return any(_check_predicate(p, obj) for p in pred["any"])
    if pred.get("observed_generation"):
        gen = obj.meta.generation if hasattr(obj.meta, "generation") else 0
        return (st.get("observedGeneration") or 0) >= (gen or 0)
    if "condition" in pred:
        for cond in st.get("conditions") or []:
            if cond.get("type") != pred["condition"]:
                continue
            if cond.get("status") != pred.get("status", "True"):
                continue
            if "reason" in pred and cond.get("reason") != pred["reason"]:
                continue
            return True
        return False
    value = get_path(st, pred["path"])
    op = pred.get("op", "==")
    if op == "exists":
        return value is not None
    if "spec_path" in pred:
        want = get_path(obj.spec, pred["spec_path"])
    elif "status_path" in pred:
        want = get_path(st, pred["status_path"])
    else:
        want = pred.get("value")
    if value is None:
        return False
    if op == "==":
        return value == want
    if op == "!=":
        return value != want
    if op == "in":
        return value in (want or [])
    if op == ">=":
        return value >= want
    if op == "<=":
        return value <= want
    return False


def _compile(rules: CustomizationRules) -> dict[str, Any]:
    """Build operation callables from the DSL."""
    ops: dict[str, Any] = {}
    if rules.replica_path or rules.replica_default:

        def get_replicas(obj: Resource):
            raw_replicas = (
                get_path(obj.spec, rules.replica_path) if rules.replica_path else None
            )
            try:
                replicas = int(raw_replicas)
            except (TypeError, ValueError):
                # unset, or an IntOrString like "50%" (kruise BroadcastJob
                # parallelism) — fall back rather than wedge the reconciler
                replicas = rules.replica_default

            reqs = None
            if rules.requests_path:
                raw = get_path(obj.spec, rules.requests_path) or {}
                reqs = ReplicaRequirements(
                    resource_request=parse_resource_list(raw),
                    namespace=obj.meta.namespace,
                )
            elif rules.pod_requests_path:
                template = get_path(obj.spec, rules.pod_requests_path) or {}
                from .native import pod_requests

                reqs = ReplicaRequirements(
                    resource_request=pod_requests(template.get("spec") or {}),
                    namespace=obj.meta.namespace,
                )
            return replicas, reqs

        ops[GET_REPLICAS] = get_replicas
        if rules.replica_path:

            def revise_replica(obj: Resource, replicas: int):
                out = clone_resource(obj)
                set_path(out.spec, rules.replica_path, replicas)
                return out

            ops[REVISE_REPLICA] = revise_replica
    if rules.status_paths:

        def reflect_status(obj: Resource):
            out: dict[str, Any] = {}
            for p in rules.status_paths:
                if p.startswith("meta."):
                    # metadata projected into the reflected status (e.g.
                    # meta.generation -> status["generation"], so aggregation
                    # can compare member generation vs observedGeneration)
                    value = getattr(obj.meta, p[len("meta."):], None)
                else:
                    value = get_path(obj.status or {}, p)
                if value is not None:
                    out[p.split(".", 1)[-1] if p.startswith("meta.") else p] = value
            return out or None

        ops[REFLECT_STATUS] = reflect_status
    if rules.health:

        def interpret_health(obj: Resource) -> bool:
            return all(_check_predicate(p, obj) for p in rules.health)

        ops[INTERPRET_HEALTH] = interpret_health
    if (
        rules.status_aggregation
        or rules.status_zero_fields
        or rules.aggregate_observed_generation
    ):

        def aggregate_status(obj: Resource, items: list[AggregatedStatusItem]):
            out = clone_resource(obj)
            agg: dict[str, Any] = {}
            for fname, how in rules.status_aggregation.items():
                values = [
                    (item.status or {}).get(fname)
                    for item in items
                    if (item.status or {}).get(fname) not in (None, "")
                ]
                if not values:
                    if fname in rules.status_zero_fields:
                        agg[fname] = 0
                    continue
                if how == "sum":
                    agg[fname] = sum(values)
                elif how == "max":
                    agg[fname] = max(values)
                elif how == "min":
                    agg[fname] = min(values)
                elif how == "last":
                    agg[fname] = values[-1]
                elif how == "and":
                    agg[fname] = all(values)
                elif how == "or":
                    agg[fname] = any(values)
            if rules.aggregate_observed_generation:
                # advance only once every member observed its own generation
                all_observed = all(
                    (item.status or {}).get("observedGeneration", 0)
                    >= (item.status or {}).get("generation", 0)
                    for item in items
                )
                if all_observed:
                    agg["observedGeneration"] = out.meta.generation or 0
            out.status = {**(out.status or {}), **agg}
            return out

        ops[AGGREGATE_STATUS] = aggregate_status
    if rules.retain_paths or rules.retain_status:

        def retain(desired: Resource, observed: Resource):
            out = clone_resource(desired)
            for path in rules.retain_paths:
                value = get_path(observed.spec, path)
                if value is not None:
                    set_path(out.spec, path, clone_json(value))
            if rules.retain_status and observed.status is not None:
                out.status = clone_json(observed.status)
            return out

        ops[RETAIN] = retain
    if rules.dependencies:

        def get_dependencies(obj: Resource):
            deps = []
            for rule in rules.dependencies:
                if rule.get("pod_template_path"):
                    template = get_path(obj.spec, rule["pod_template_path"]) or {}
                    from .native import pod_spec_dependencies

                    deps.extend(
                        pod_spec_dependencies(
                            template.get("spec") or {}, obj.meta.namespace
                        )
                    )
                elif rule.get("list_path"):
                    for entry in get_path(obj.spec, rule["list_path"]) or []:
                        if not isinstance(entry, dict):
                            continue
                        name = entry.get(rule.get("name_field", "name"))
                        kind = (
                            entry.get(rule["kind_field"])
                            if rule.get("kind_field")
                            else rule.get("kind", "ConfigMap")
                        )
                        if name and kind:
                            deps.append(
                                DependentObjectReference(
                                    api_version=rule.get("api_version", "v1"),
                                    kind=str(kind),
                                    namespace=obj.meta.namespace,
                                    name=str(name),
                                )
                            )
                else:
                    name = get_path(obj.spec, rule.get("name_path", ""))
                    if name:
                        namespace = (
                            get_path(obj.spec, rule["namespace_path"])
                            if rule.get("namespace_path")
                            else None
                        )
                        # the referenced kind may live in the object itself
                        # (flux sourceRef.kind), with a per-kind api group
                        kind = (
                            get_path(obj.spec, rule["kind_path"])
                            if rule.get("kind_path")
                            else None
                        ) or rule.get("kind", "ConfigMap")
                        api_version = rule.get("api_version_by_kind", {}).get(
                            kind, rule.get("api_version", "v1")
                        )
                        deps.append(
                            DependentObjectReference(
                                api_version=api_version,
                                kind=str(kind),
                                namespace=str(namespace or obj.meta.namespace),
                                name=str(name),
                            )
                        )
            return deps

        ops[GET_DEPENDENCIES] = get_dependencies
    _compile_scripts(rules, ops)
    return ops


def _compile_scripts(rules: CustomizationRules, ops: dict[str, Any]) -> None:
    """Overlay the expression-tier scripts (exprlang) onto the op map —
    scripts override the path-DSL for their operation. Entry-point names
    and call shapes mirror the reference Lua VM (luavm/lua.go:46-316)."""
    from .exprlang import ExprVM
    from .webhook import resource_from_dict, resource_to_dict

    def vm_for(source: str) -> ExprVM:
        return ExprVM(source)  # raises ScriptError on invalid scripts

    if rules.replica_resource_script:
        vm = vm_for(rules.replica_resource_script)

        def get_replicas_script(obj: Resource, vm=vm):
            out = vm.call("GetReplicas", resource_to_dict(obj))
            if isinstance(out, tuple):
                replicas, requires = (list(out) + [None])[:2]
            else:
                replicas, requires = out, None
            reqs = None
            if isinstance(requires, dict):
                claim = requires.get("nodeClaim") or {}
                from ..api.work import NodeClaim

                reqs = ReplicaRequirements(
                    resource_request=parse_resource_list(
                        requires.get("resourceRequest") or {}
                    ),
                    node_claim=(
                        NodeClaim(
                            node_selector=claim.get("nodeSelector") or {},
                            tolerations=claim.get("tolerations") or [],
                            hard_node_affinity=claim.get("hardNodeAffinity"),
                        )
                        if claim
                        else None
                    ),
                    namespace=str(requires.get("namespace") or obj.meta.namespace),
                    priority_class_name=str(
                        requires.get("priorityClassName") or ""
                    ),
                )
            return int(replicas or 0), reqs

        ops[GET_REPLICAS] = get_replicas_script
    if rules.replica_revision_script:
        vm = vm_for(rules.replica_revision_script)

        def revise_replica_script(obj: Resource, replicas: int, vm=vm):
            out = vm.call("ReviseReplica", resource_to_dict(obj), replicas)
            return resource_from_dict(out)

        ops[REVISE_REPLICA] = revise_replica_script
    if rules.retention_script:
        vm = vm_for(rules.retention_script)

        def retain_script(desired: Resource, observed: Resource, vm=vm):
            out = vm.call(
                "Retain", resource_to_dict(desired), resource_to_dict(observed)
            )
            return resource_from_dict(out)

        ops[RETAIN] = retain_script
    if rules.status_aggregation_script:
        vm = vm_for(rules.status_aggregation_script)

        def aggregate_script(obj: Resource, items: list[AggregatedStatusItem], vm=vm):
            wire_items = [
                {
                    "clusterName": it.cluster_name,
                    "status": it.status,
                    "applied": it.applied,
                    "health": it.health,
                }
                for it in items
            ]
            out = vm.call(
                "AggregateStatus", resource_to_dict(obj), wire_items
            )
            return resource_from_dict(out)

        ops[AGGREGATE_STATUS] = aggregate_script
    if rules.health_script:
        vm = vm_for(rules.health_script)

        def health_script(obj: Resource, vm=vm) -> bool:
            return bool(vm.call("InterpretHealth", resource_to_dict(obj)))

        ops[INTERPRET_HEALTH] = health_script
    if rules.status_reflection_script:
        vm = vm_for(rules.status_reflection_script)

        def reflect_script(obj: Resource, vm=vm):
            out = vm.call("ReflectStatus", resource_to_dict(obj))
            return out if out else None

        ops[REFLECT_STATUS] = reflect_script
    if rules.dependency_script:
        vm = vm_for(rules.dependency_script)

        def dependencies_script(obj: Resource, vm=vm):
            out = vm.call("GetDependencies", resource_to_dict(obj)) or []
            return [
                DependentObjectReference(
                    api_version=str(d.get("apiVersion", "v1")),
                    kind=str(d.get("kind", "")),
                    namespace=str(d.get("namespace") or obj.meta.namespace),
                    name=str(d.get("name", "")),
                )
                for d in out
                if isinstance(d, dict)
            ]

        ops[GET_DEPENDENCIES] = dependencies_script


class CustomizationConfigManager:
    """Registers/deregisters customizations on CR events
    (customized/declarative configmanager analogue)."""

    def __init__(
        self, store: Store, runtime: Runtime, interpreter: ResourceInterpreter
    ) -> None:
        self.store = store
        self.interpreter = interpreter
        self._registered: dict[str, list[tuple[str, str]]] = {}
        self.worker = runtime.new_worker("interpreter-config", self._reconcile)
        store.watch(
            "ResourceInterpreterCustomization",
            lambda e: self.worker.enqueue((e.key, e.type)),
        )

    def _reconcile(self, key_type) -> Optional[str]:
        key, event_type = key_type
        cr = self.store.get("ResourceInterpreterCustomization", key)
        # drop previous registrations for this CR
        previous = self._registered.pop(key, [])
        for gvk, op in previous:
            self.interpreter.deregister_customized(gvk, op)
        affected_gvks = {gvk for gvk, _ in previous}
        if cr is not None:
            ops = _compile(cr.rules)
            regs = []
            for op, fn in ops.items():
                self.interpreter.register_customized(cr.target_gvk, op, fn)
                regs.append((cr.target_gvk, op))
            self._registered[key] = regs
            affected_gvks.add(cr.target_gvk)
        # full re-sync of affected templates (the reference's controllers
        # resync on interpreter-config changes): a touch re-runs the
        # detector/binding pipeline with the new semantics
        for res in self.store.list("Resource"):
            if f"{res.api_version}/{res.kind}" in affected_gvks:
                self.store.apply(res)
        return DONE
