"""Placement provenance as one batched pass: the exclusion bitmask and the
top-k candidate summary.

Counterpart of ``karmada_tpu/ops/explain.py``. ``explain_pass`` (K14,
``csrc/explain_pass.cu``) answers for every binding x cluster of a chunk a
packed EXCLUSION BITMASK, one bit per decision stage in
``utils.reasons.STAGE_REASONS`` order (affinity/group rank, taints and
NoExecute, API enablement, estimator availability, quota cluster cap, quota
admission, spread constraint, preemption), and per binding the top-k
candidates (cluster, availability, credited prev, final assignment, that
cluster's mask byte) ranked by (assigned desc, availability desc, index
asc). The stage masks arrive composed: the engine's capture layer
(``TensorScheduler._explain_inputs``) folds leniency, the selected affinity
group and the spread selection in, as the solve kernels receive composed
feasibility.

``explain_pass_ref`` is the plain torch version; the wrapper takes it on
CPU tensors and launches the kernel on CUDA tensors. The numpy referent
(``refimpl/explain_np.py``) re-derives the same bits per binding and per
cluster and shares no code with either.
"""

from __future__ import annotations

import torch

from .. import native
from ..utils.reasons import STAGE_REASONS

#: exclusion-bit positions, from the taxonomy's stage order
BIT_AFFINITY = STAGE_REASONS.index("AffinityMismatch")
BIT_TAINT = STAGE_REASONS.index("TaintUntolerated")
BIT_API = STAGE_REASONS.index("ApiNotEnabled")
BIT_AVAILABILITY = STAGE_REASONS.index("NoAvailableReplicas")
BIT_QUOTA_CAP = STAGE_REASONS.index("QuotaCapExceeded")
BIT_QUOTA_ADMIT = STAGE_REASONS.index("QuotaExceeded")
BIT_SPREAD = STAGE_REASONS.index("SpreadConstraintUnsatisfied")
BIT_PREEMPTED = STAGE_REASONS.index("PreemptedByHigherPriority")
N_STAGES = len(STAGE_REASONS)
assert N_STAGES <= 8, "exclusion mask is one uint8 per cell"

#: top-k summary column layout (int32[B, K, TOPK_COLS])
TOPK_COLS = 5  # cluster index, avail, prev, assigned, mask byte

#: the widest top-k the kernel keeps per thread (``topk_width``'s default)
MAX_K = 8

_CELL = ("aff_ok", "taint_ok", "api_ok", "spread_ok", "avail", "caps",
         "assignment", "prev", "preempted")
_CELL_DTYPES = (torch.bool,) * 4 + (torch.int32,) * 2 + (torch.int32,) * 2 + (torch.bool,)


def topk_width(c: int, k: int = MAX_K) -> int:
    """The pass's ``k`` for a ``c``-cluster snapshot: the requested width
    clamped to the cluster count."""
    return max(1, min(int(k), int(c)))


def _check(aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted, dynamic,
           replicas, assignment, prev, preempted, k) -> tuple[int, int]:
    b, c = aff_ok.shape
    cells = (aff_ok, taint_ok, api_ok, spread_ok, avail, caps, assignment, prev, preempted)
    if any(t.shape != (b, c) for t in cells) or any(
            t.shape != (b,) for t in (admitted, dynamic, replicas)):
        raise ValueError("explain_pass: inconsistent shapes")
    if not 1 <= k <= min(c, MAX_K) and not (b == 0 or c == 0):
        raise ValueError(f"explain_pass: k = {k} outside [1, min(C, {MAX_K})]")
    return b, c


def explain_pass_ref(aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted,
                     dynamic, replicas, assignment, prev, preempted, *, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K14: ``(mask uint8[B, C], topk int32[B, k,
    TOPK_COLS])``. The top-k is a stable descending sort of the JAX key
    ``assignment * 2^32 + avail + 1`` (int64), so ties keep the lower index
    first, as ``lax.top_k`` does; ``torch.topk`` promises no tie order."""
    _check(aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted, dynamic,
           replicas, assignment, prev, preempted, k)

    def bit(cond, i):
        return cond.to(torch.uint8) << i

    consults = (dynamic & (replicas > 0))[:, None]
    mask = (
        bit(~aff_ok, BIT_AFFINITY)
        | bit(~taint_ok, BIT_TAINT)
        | bit(~api_ok, BIT_API)
        | bit(consults & (avail <= 0), BIT_AVAILABILITY)
        | bit(consults & (caps <= 0), BIT_QUOTA_CAP)
        | bit(~admitted[:, None].expand_as(aff_ok), BIT_QUOTA_ADMIT)
        | bit(~spread_ok, BIT_SPREAD)
        | bit(preempted, BIT_PREEMPTED)
    )
    key = assignment.to(torch.int64) * (1 << 32) + (avail.to(torch.int64) + 1)
    idx = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]
    take = lambda a: torch.gather(a.to(torch.int32), 1, idx)  # noqa: E731
    topk = torch.stack([idx.to(torch.int32), take(avail), take(prev), take(assignment),
                        take(mask)], dim=-1)
    return mask, topk


def explain_pass(aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted,
                 dynamic, replicas, assignment, prev, preempted, *, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K14: ``explain_pass_ref`` as one kernel launch (a warp a row).

    Inputs: ``aff_ok``, ``taint_ok``, ``api_ok``, ``spread_ok`` bool[B, C]
    (each stage's composed pass mask), ``avail`` int32[B, C] (merged
    pre-cap availability, -1 = no summary), ``caps`` int32[B, C] (quota
    cluster cap, MAX_INT32 = none), ``admitted``, ``dynamic`` bool[B],
    ``replicas`` int32[B], ``assignment`` and ``prev`` int32[B, C],
    ``preempted`` bool[B, C]; ``k`` = ``topk_width(C)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``explain_pass.launches`` counts kernel launches."""
    args = (aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted, dynamic,
            replicas, assignment, prev, preempted)
    if native.on_cpu(args):
        return explain_pass_ref(*args, k=k)
    cells = (aff_ok, taint_ok, api_ok, spread_ok, avail, caps, assignment, prev, preempted)
    native.check("explain_pass", **{n: (t, dt) for n, t, dt in zip(_CELL, cells, _CELL_DTYPES)},
                 admitted=(admitted, torch.bool), dynamic=(dynamic, torch.bool),
                 replicas=(replicas, torch.int32))
    b, c = _check(*args, k)
    dev = aff_ok.device
    mask = torch.empty((b, c), dtype=torch.uint8, device=dev)
    topk = torch.empty((b, k, TOPK_COLS), dtype=torch.int32, device=dev)
    if b and c:
        native.launch(explain_pass, "explain_pass", "explain_pass_launch", dev,
                      *args, b, c, k, mask, topk)
    return mask, topk


explain_pass.launches = 0
