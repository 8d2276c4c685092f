"""Cluster API: member-cluster inventory and capacity status.

The port's own copy of ``karmada_tpu.api.cluster``. Its ``Lease`` serves the
Pull agent's heartbeat; the JAX type's second use, the leader-election lock,
waits for leader election (ROADMAP A7b).

Ref: pkg/apis/cluster/v1alpha1/types.go —
SyncMode (:77-80), Provider/Region/Zones (:119-139), Taints (:141-145),
ResourceModels (:147-203), APIEnablements (:293-295),
ResourceSummary Allocatable/Allocated/Allocating + AllocatableModelings
(:305-369).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .core import Condition, ObjectMeta

# SyncMode
PUSH = "Push"
PULL = "Pull"

# Taint effects (k8s core semantics; scheduler filters NoSchedule/NoExecute:
# pkg/scheduler/framework/plugins/tainttoleration/taint_toleration.go:46-74)
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Well-known cluster condition / taint keys
# (ref: pkg/apis/cluster/v1alpha1/well_known_constants.go)
CLUSTER_CONDITION_READY = "Ready"
TAINT_CLUSTER_NOT_READY = "cluster.karmada.io/not-ready"
TAINT_CLUSTER_UNREACHABLE = "cluster.karmada.io/unreachable"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str
    value: str = ""


@dataclass(frozen=True)
class Toleration:
    """k8s-style toleration. operator: 'Equal' matches key+value, 'Exists'
    matches key regardless of value; empty key + Exists tolerates everything.
    ``toleration_seconds`` only applies to NoExecute (eviction delay)."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:  # empty key with Exists tolerates all taints
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class ResourceModelRange:
    """[min, max) range for one resource in a model grade.
    Ref: cluster types.go:147-203."""

    name: str
    min: int
    max: int


@dataclass
class ResourceModel:
    grade: int
    ranges: list[ResourceModelRange] = field(default_factory=list)


@dataclass
class AllocatableModeling:
    grade: int
    count: int


#: (grade, cpu-min cores, cpu-max cores, mem-min GB, mem-max GB); the last
#: grade's max is open-ended (apis/cluster/mutation/mutation.go:81-215)
_DEFAULT_GRADES = (
    (0, 0, 1, 0, 4),
    (1, 1, 2, 4, 16),
    (2, 2, 4, 16, 32),
    (3, 4, 8, 32, 64),
    (4, 8, 16, 64, 128),
    (5, 16, 32, 128, 256),
    (6, 32, 64, 256, 512),
    (7, 64, 128, 512, 1024),
    (8, 128, None, 1024, None),
)

MAX_INT64 = 2**63 - 1
_GB = 1 << 30


def default_resource_models() -> list[ResourceModel]:
    """The reference's nine default cpu/memory grades, in canonical units
    (cpu milli, memory bytes) — SetDefaultClusterResourceModels."""
    out = []
    for grade, cmin, cmax, mmin, mmax in _DEFAULT_GRADES:
        out.append(ResourceModel(grade=grade, ranges=[
            ResourceModelRange(
                name="cpu", min=cmin * 1000,
                max=MAX_INT64 if cmax is None else cmax * 1000,
            ),
            ResourceModelRange(
                name="memory", min=mmin * _GB,
                max=MAX_INT64 if mmax is None else mmax * _GB,
            ),
        ]))
    return out


def standardize_resource_models(models: list[ResourceModel]) -> None:
    """StandardizeClusterResourceModels: sort by grade; the first grade's
    mins act as zero and the last grade's maxes as MaxInt64, so the model
    space is gapless at both ends."""
    if not models:
        return
    models.sort(key=lambda m: m.grade)
    for rng in models[0].ranges:
        rng.min = 0
    for rng in models[-1].ranges:
        rng.max = MAX_INT64


@dataclass
class ResourceSummary:
    """Cluster-level resource accounting (canonical int units, see
    utils.quantity). Ref: cluster types.go:305-369."""

    allocatable: dict[str, int] = field(default_factory=dict)
    allocated: dict[str, int] = field(default_factory=dict)
    allocating: dict[str, int] = field(default_factory=dict)
    allocatable_modelings: list[AllocatableModeling] = field(default_factory=list)


@dataclass
class ClusterSpec:
    sync_mode: str = PUSH
    provider: str = ""
    region: str = ""
    zones: list[str] = field(default_factory=list)
    taints: list[Taint] = field(default_factory=list)
    resource_models: list[ResourceModel] = field(default_factory=list)
    # endpoint/secret refs omitted: member access is via the cluster client
    # registry (utils.member_clients), the analogue of Secret-stored
    # kubeconfigs (pkg/util/membercluster_client.go).
    api_endpoint: str = ""

    @property
    def zone(self) -> str:
        return self.zones[0] if self.zones else ""


@dataclass
class ClusterStatus:
    kubernetes_version: str = ""
    api_enablements: list[str] = field(default_factory=list)  # list of GVK strings
    conditions: list[Condition] = field(default_factory=list)
    node_summary_total: int = 0
    node_summary_ready: int = 0
    resource_summary: ResourceSummary = field(default_factory=ResourceSummary)


@dataclass
class Cluster:
    KIND = "Cluster"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterSpec = field(default_factory=ClusterSpec)
    status: ClusterStatus = field(default_factory=ClusterStatus)

    @property
    def name(self) -> str:
        return self.meta.name


@dataclass
class Lease:
    """coordination.k8s.io Lease analogue. The Pull agent renews
    ``renew_time`` (cluster_status_controller.go:210-213 + monitorClusterHealth
    lease observation); the control plane judges freshness, since it cannot
    probe a Pull cluster directly. The holder fields are the leader-election
    resource lock's (client-go leaderelection over LeasesResourceLock)."""

    KIND = "Lease"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    renew_time: float = 0.0
    holder_identity: str = ""
    lease_duration_seconds: float = 0.0
    acquire_time: float = 0.0
    lease_transitions: int = 0
