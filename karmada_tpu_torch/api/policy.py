"""Policy API: propagation and override policies, placement, quota.

The port's own copy of ``karmada_tpu.api.policy``. Ref:
pkg/apis/policy/v1alpha1/propagation_types.go — PropagationPolicy (:52),
Placement (:393-447), ClusterAffinity/ClusterAffinities (:400-433),
SpreadConstraint (:453-487), ReplicaSchedulingStrategy (:546-614);
override_types.go (OverridePolicy); federatedresourcequota_types.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .cluster import Cluster, Toleration
from .core import ObjectMeta

# ReplicaSchedulingType
DUPLICATED = "Duplicated"
DIVIDED = "Divided"
# ReplicaDivisionPreference
AGGREGATED = "Aggregated"
WEIGHTED = "Weighted"
# DynamicWeightFactor
DYNAMIC_WEIGHT_AVAILABLE_REPLICAS = "AvailableReplicas"
# SpreadByField
SPREAD_BY_CLUSTER = "cluster"
SPREAD_BY_ZONE = "zone"
SPREAD_BY_REGION = "region"
SPREAD_BY_PROVIDER = "provider"

# ConflictResolution
CONFLICT_OVERWRITE = "Overwrite"
CONFLICT_ABORT = "Abort"


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: tuple[str, ...] = ()


@dataclass
class LabelSelector:
    """k8s LabelSelector: AND of match_labels and match_expressions."""

    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            has = req.key in labels
            if req.operator == "Exists":
                if not has:
                    return False
            elif req.operator == "DoesNotExist":
                if has:
                    return False
            elif req.operator == "In":
                if not has or labels[req.key] not in req.values:
                    return False
            elif req.operator == "NotIn":
                if has and labels[req.key] in req.values:
                    return False
            else:
                raise ValueError(f"unknown operator {req.operator}")
        return True


@dataclass
class FieldSelector:
    """Cluster field selector over provider/region/zone.
    Ref: propagation_types.go FieldSelector + pkg/util/cluster.go matching."""

    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)

    _FIELDS = ("provider", "region", "zone")

    def matches(self, cluster: Cluster) -> bool:
        fields = {
            "provider": cluster.spec.provider,
            "region": cluster.spec.region,
            "zone": cluster.spec.zone,
        }
        for req in self.match_expressions:
            val = fields.get(req.key, "")
            if req.operator == "In":
                if val not in req.values:
                    return False
            elif req.operator == "NotIn":
                if val in req.values:
                    return False
            else:
                raise ValueError(f"unsupported field selector operator {req.operator}")
        return True


@dataclass
class ClusterAffinity:
    """Ref: propagation_types.go:400-415 + util.ClusterMatches
    (pkg/util/cluster.go:79-105): exclude wins, then cluster_names /
    label_selector / field_selector must all pass (empty means match-all)."""

    cluster_names: list[str] = field(default_factory=list)
    exclude: list[str] = field(default_factory=list)
    label_selector: Optional[LabelSelector] = None
    field_selector: Optional[FieldSelector] = None

    def matches(self, cluster: Cluster) -> bool:
        if cluster.name in self.exclude:
            return False
        if self.cluster_names and cluster.name not in self.cluster_names:
            return False
        if self.label_selector is not None and not self.label_selector.matches(
            cluster.meta.labels
        ):
            return False
        if self.field_selector is not None and not self.field_selector.matches(cluster):
            return False
        return True


@dataclass
class ClusterAffinityTerm(ClusterAffinity):
    """Named affinity group for ordered failover.
    Ref: propagation_types.go:417-424."""

    affinity_name: str = ""


@dataclass
class SpreadConstraint:
    """Ref: propagation_types.go:461-487. min_groups defaults to 1;
    max_groups 0 means unbounded."""

    spread_by_field: str = ""  # cluster | zone | region | provider
    spread_by_label: str = ""
    min_groups: int = 1
    max_groups: int = 0


@dataclass
class StaticClusterWeight:
    target_cluster: ClusterAffinity = field(default_factory=ClusterAffinity)
    weight: int = 1


@dataclass
class ClusterPreferences:
    static_weight_list: list[StaticClusterWeight] = field(default_factory=list)
    dynamic_weight: str = ""  # "" or AvailableReplicas


@dataclass
class ReplicaSchedulingStrategy:
    """Ref: propagation_types.go:546-614."""

    replica_scheduling_type: str = DIVIDED
    replica_division_preference: str = ""  # Aggregated | Weighted
    weight_preference: Optional[ClusterPreferences] = None


@dataclass
class Placement:
    """Ref: propagation_types.go:393-447."""

    cluster_affinity: Optional[ClusterAffinity] = None
    cluster_affinities: list[ClusterAffinityTerm] = field(default_factory=list)
    cluster_tolerations: list[Toleration] = field(default_factory=list)
    spread_constraints: list[SpreadConstraint] = field(default_factory=list)
    replica_scheduling: Optional[ReplicaSchedulingStrategy] = None

    def replica_scheduling_type(self) -> str:
        """Defaulting mirrors Placement.ReplicaSchedulingType():
        nil strategy means Duplicated."""
        if self.replica_scheduling is None:
            return DUPLICATED
        return self.replica_scheduling.replica_scheduling_type or DUPLICATED


@dataclass
class ResourceSelector:
    """Selects which templates a policy applies to.
    Ref: propagation_types.go ResourceSelector."""

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    label_selector: Optional[LabelSelector] = None


@dataclass
class PropagationSpec:
    resource_selectors: list[ResourceSelector] = field(default_factory=list)
    placement: Placement = field(default_factory=Placement)
    priority: int = 0
    preemption: str = "Never"  # Never | Always
    propagate_deps: bool = False
    conflict_resolution: str = CONFLICT_ABORT
    suspend_dispatching: bool = False
    # suspend dispatching only to these member clusters
    # (propagation_types.go:237-258 Suspension.DispatchingOnClusters)
    suspend_dispatching_on_clusters: Optional[list[str]] = None
    preserve_resources_on_deletion: bool = False
    failover: Optional["FailoverBehavior"] = None
    # scheduler to use; default scheduler name mirrors the reference default
    scheduler_name: str = "default-scheduler"
    # "" (immediate) | "Lazy": policy changes defer until the resource
    # template itself changes (propagation_types.go:159-178,653-660)
    activation_preference: str = ""


@dataclass
class ApplicationFailoverBehavior:
    """Ref: propagation_types.go ApplicationFailoverBehavior."""

    decision_conditions_toleration_seconds: int = 300
    purge_mode: str = "Graciously"  # Graciously | Immediately | Never
    grace_period_seconds: Optional[int] = None
    state_preservation: Optional[dict[str, str]] = None  # name -> JSONPath


@dataclass
class FailoverBehavior:
    application: Optional[ApplicationFailoverBehavior] = None


@dataclass
class PropagationPolicy:
    KIND = "PropagationPolicy"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PropagationSpec = field(default_factory=PropagationSpec)

    @property
    def cluster_scoped(self) -> bool:
        return False


@dataclass
class ClusterPropagationPolicy(PropagationPolicy):
    KIND = "ClusterPropagationPolicy"

    @property
    def cluster_scoped(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Override policy (ref: pkg/apis/policy/v1alpha1/override_types.go)
# ---------------------------------------------------------------------------


@dataclass
class PlaintextOverrider:
    """JSONPatch-style overrider: op add/remove/replace at a path."""

    path: str = ""
    operator: str = "replace"  # add | remove | replace
    value: Any = None


@dataclass
class FieldPatchOperation:
    """One operation inside an embedded document
    (override_types.go:287-310 JSONPatchOperation/YAMLPatchOperation)."""

    sub_path: str = ""  # RFC 6901 path within the embedded document
    operator: str = "replace"  # add | remove | replace
    value: Any = None


@dataclass
class FieldOverrider:
    """Patch a STRING field whose value is an embedded JSON or YAML
    document (e.g. a ConfigMap data key): parse, apply the operations at
    their sub-paths, re-serialize (override_types.go:266-285). A single
    instance carries either json or yaml operations, not both."""

    field_path: str = ""  # RFC 6901 path to the string field
    json: list[FieldPatchOperation] = field(default_factory=list)
    yaml: list[FieldPatchOperation] = field(default_factory=list)


@dataclass
class ImageOverrider:
    component: str = "Registry"  # Registry | Repository | Tag
    operator: str = "replace"
    value: str = ""
    predicate_path: str = ""


@dataclass
class CommandArgsOverrider:
    container_name: str = ""
    operator: str = "add"  # add | remove
    value: list[str] = field(default_factory=list)


@dataclass
class LabelAnnotationOverrider:
    operator: str = "replace"  # add | remove | replace
    value: dict[str, str] = field(default_factory=dict)


@dataclass
class Overriders:
    plaintext: list[PlaintextOverrider] = field(default_factory=list)
    image_overrider: list[ImageOverrider] = field(default_factory=list)
    command_overrider: list[CommandArgsOverrider] = field(default_factory=list)
    args_overrider: list[CommandArgsOverrider] = field(default_factory=list)
    labels_overrider: list[LabelAnnotationOverrider] = field(default_factory=list)
    annotations_overrider: list[LabelAnnotationOverrider] = field(default_factory=list)
    field_overrider: list[FieldOverrider] = field(default_factory=list)


@dataclass
class RuleWithCluster:
    target_cluster: Optional[ClusterAffinity] = None
    overriders: Overriders = field(default_factory=Overriders)


@dataclass
class OverrideSpec:
    resource_selectors: list[ResourceSelector] = field(default_factory=list)
    override_rules: list[RuleWithCluster] = field(default_factory=list)


@dataclass
class OverridePolicy:
    KIND = "OverridePolicy"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: OverrideSpec = field(default_factory=OverrideSpec)

    @property
    def cluster_scoped(self) -> bool:
        return False


@dataclass
class ClusterOverridePolicy(OverridePolicy):
    KIND = "ClusterOverridePolicy"

    @property
    def cluster_scoped(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# FederatedResourceQuota (ref: federatedresourcequota_types.go)
# ---------------------------------------------------------------------------


@dataclass
class StaticClusterAssignment:
    cluster_name: str = ""
    hard: dict[str, int] = field(default_factory=dict)


@dataclass
class FederatedResourceQuotaSpec:
    overall: dict[str, int] = field(default_factory=dict)
    static_assignments: list[StaticClusterAssignment] = field(default_factory=list)


@dataclass
class FederatedResourceQuotaStatus:
    overall: dict[str, int] = field(default_factory=dict)
    overall_used: dict[str, int] = field(default_factory=dict)
    aggregated_status: list[Any] = field(default_factory=list)


@dataclass
class FederatedResourceQuota:
    KIND = "FederatedResourceQuota"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: FederatedResourceQuotaSpec = field(default_factory=FederatedResourceQuotaSpec)
    status: FederatedResourceQuotaStatus = field(
        default_factory=FederatedResourceQuotaStatus
    )
