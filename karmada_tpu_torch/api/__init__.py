"""Typed API data model: the subset the scheduler consumes (ref: pkg/apis/*)."""

from .core import (  # noqa: F401
    Condition,
    ObjectMeta,
)
from .cluster import (  # noqa: F401
    NO_EXECUTE,
    NO_SCHEDULE,
    PREFER_NO_SCHEDULE,
    PUSH,
    AllocatableModeling,
    Cluster,
    ClusterSpec,
    ClusterStatus,
    ResourceModel,
    ResourceModelRange,
    ResourceSummary,
    Taint,
    default_resource_models,
    standardize_resource_models,
    Toleration,
)
from .policy import (  # noqa: F401
    AGGREGATED,
    DIVIDED,
    DUPLICATED,
    WEIGHTED,
    ClusterAffinity,
    ClusterAffinityTerm,
    ClusterPreferences,
    FederatedResourceQuota,
    FederatedResourceQuotaSpec,
    FederatedResourceQuotaStatus,
    FieldSelector,
    LabelSelector,
    LabelSelectorRequirement,
    Placement,
    ReplicaSchedulingStrategy,
    SpreadConstraint,
    StaticClusterAssignment,
    StaticClusterWeight,
)
from .work import NodeClaim, ReplicaRequirements  # noqa: F401
