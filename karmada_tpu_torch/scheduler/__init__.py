"""Batched scheduler (ref: pkg/scheduler): the fleet path, the host
general path, the ranked multi-term path, the quota plane, and the
armed-only preemption and provenance planes."""

from .core import (  # noqa: F401
    INSUFFICIENT_ERROR,
    BindingProblem,
    PreemptionOutcome,
    ScheduleResult,
    TensorScheduler,
    host_profile_table,
    kernel_variant,
)
from .quota import (  # noqa: F401
    QUOTA_EXCEEDED_ERROR,
    QUOTA_EXCEEDED_REASON,
    QuotaSnapshot,
    build_quota_snapshot,
    per_replica_vector,
    usage_from_bindings,
)
from .snapshot import (  # noqa: F401
    ClusterSnapshot,
    CompiledPlacement,
    compile_affinity,
    compile_placement,
    snapshot_arrays,
    snapshot_from_arrays,
    strategy_code,
)
