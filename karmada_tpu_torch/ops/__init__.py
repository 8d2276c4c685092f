"""Tensor ops of the scheduling hot path: estimate, dispense, divide.

Plain torch functions with the JAX package's names and signatures, plus the
hand-written kernels behind wrappers that take the plain
version on CPU tensors and launch the kernel on CUDA tensors:

- ``estimate_merge`` (K1, ``csrc/estimate_merge.cu``): general estimate per
  request profile, no-summary masking, row gather and estimator merge;
- ``divide_replicas`` (K2, ``csrc/divide_replicas.cu``): the unified replica
  division of all four strategies;
- ``profile_table`` (K1's table form): the estimate per interned request
  profile that the fleet path gathers by row on the device;
- ``estimate_merge_table`` (K1's merge form): the row gather of a profile
  table and the min-merge with extra estimates, when the resource-model
  estimator, static-assignment quota caps or extra estimators answer;
- ``quota_admit`` (K12, ``csrc/quota_admit.cu``): FIFO quota admission of
  one wave per namespace;
- ``quota_cluster_caps`` and ``quota_caps_fold`` (K13, ``csrc/quota_caps.cu``):
  the static-assignment quota ceiling per row, and folded into the fleet's
  profile table;
- ``explain_pass`` (K14, ``csrc/explain_pass.cu``): the armed-only
  provenance pass, the per-cell stage exclusion bitmask and the per-row
  top-k candidate summary;
- ``preempt_select`` (K15, ``csrc/preempt_select.cu``): plane-wide victim
  selection of a preemption pass and the capacity it frees per cluster;
- ``first_fit_group`` (K17, ``csrc/first_fit_group.cu``, in ``masks``): the
  ranked ClusterAffinities path's ordered-failover group selection.

The fleet path's own kernels (K3-K6) live in ``scheduler/fleet_kernels.py``.

Every dtype is pinned: storage stays int32/bool, accumulators are int64 (the
JAX package turns on x64 for its whole process instead).
"""

from .dispense import (  # noqa: F401
    acc_dtype,
    take_by_weight,
    take_by_weight_batch,
)
from .divide import (  # noqa: F401
    AGGREGATED,
    DUPLICATED,
    DYNAMIC_WEIGHT,
    STATIC_WEIGHT,
    DivideResult,
    divide_replicas,
    divide_replicas_ref,
)
from .estimate import (  # noqa: F401
    MAX_INT32,
    MERGE_GROUP,
    UNAUTHENTIC,
    estimate_merge,
    estimate_merge_ref,
    estimate_merge_table,
    estimate_merge_table_ref,
    general_estimate,
    general_estimate_interned,
    merge_estimates,
    profile_table,
    profile_table_ref,
)
from .explain import (  # noqa: F401
    TOPK_COLS,
    explain_pass,
    explain_pass_ref,
    topk_width,
)
from .preempt import (  # noqa: F401
    MAX_PRIORITY,
    MAX_WEIGHT,
    preempt_select,
    preempt_select_ref,
)
from .quota import (  # noqa: F401
    DEMAND_CLAMP,
    MAX_ADMIT_ROWS,
    UNLIMITED,
    cluster_caps_np,
    cluster_caps_ref,
    quota_admit,
    quota_admit_ref,
    quota_caps_fold,
    quota_caps_fold_ref,
    quota_cluster_caps,
)
from . import masks  # noqa: F401
from .masks import first_fit_group, first_fit_group_ref  # noqa: F401
