"""Policy API: the placement types the scheduler consumes.

The scheduler-facing subset of ``karmada_tpu.api.policy``, kept as the
port's own copy. Ref: pkg/apis/policy/v1alpha1/propagation_types.go —
Placement (:393-447), ClusterAffinity/ClusterAffinities (:400-433),
SpreadConstraint (:453-487), ReplicaSchedulingStrategy (:546-614); and the
FederatedResourceQuota the quota plane packs
(federatedresourcequota_types.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .cluster import Toleration
from .core import ObjectMeta

# ReplicaSchedulingType
DUPLICATED = "Duplicated"
DIVIDED = "Divided"
# ReplicaDivisionPreference
AGGREGATED = "Aggregated"
WEIGHTED = "Weighted"


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


@dataclass
class FieldSelector:
    """Cluster field selector over provider/region/zone.
    Ref: propagation_types.go FieldSelector + pkg/util/cluster.go matching."""

    match_expressions: list[LabelSelectorRequirement] = field(default_factory=list)


@dataclass
class ClusterAffinity:
    """Ref: propagation_types.go:400-415 + util.ClusterMatches
    (pkg/util/cluster.go:79-105): exclude wins, then cluster_names /
    label_selector / field_selector must all pass (empty means match-all)."""

    cluster_names: list[str] = field(default_factory=list)
    exclude: list[str] = field(default_factory=list)
    label_selector: Optional[LabelSelector] = None
    field_selector: Optional[FieldSelector] = None


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
