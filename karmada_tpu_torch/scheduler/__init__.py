"""Batched scheduler (ref: pkg/scheduler): the fleet path and the host
general path."""

from .core import (  # noqa: F401
    INSUFFICIENT_ERROR,
    BindingProblem,
    ScheduleResult,
    TensorScheduler,
    host_profile_table,
    kernel_variant,
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
