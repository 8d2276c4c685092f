"""Unified replica-assignment: all four strategies as one tensor op.

Counterpart of ``karmada_tpu/ops/divide.py``. The reference dispatches through
assignFuncMap (core/assignment.go:31-38) into per-strategy Go loops; here every
strategy reduces to ONE largest-remainder dispense with strategy-dependent
(target, weights, lastReplicas, init):

- Duplicated  (assignment.go:176-182): broadcast, no dispense
- StaticWeight (assignment.go:194-206): target=N, w=rule weights, init=0
- DynamicWeight steady scale-up (division_algorithm.go:119-128):
  target=N-assigned, w=availability, init=previous
- DynamicWeight steady scale-down (division_algorithm.go:101-117):
  target=N, w=FULL previous result, init=0
- Fresh (division_algorithm.go:130-152): target=N, w=availability+credited
  previous, init=0
- Aggregated (division_algorithm.go:80-90 + assignment.go:146-173): the
  dynamic modes with weights masked to the minimal prefix of clusters ordered
  (previously-used desc, availability desc, index asc) whose cumulative
  availability covers the target

``divide_replicas_ref`` is the plain torch version, batched over rows with
the JAX kernel's wide (int64) arithmetic and its int32 wrap-around.
``divide_replicas`` launches the hand-written kernel K2
(``csrc/divide_replicas.cu``) on CUDA tensors and takes the plain version on
CPU tensors. Both keep the JAX signature; ``wide`` and ``fast`` select
arithmetic that the JAX package proves identical to the wide form under the
gates ``scheduler.core.kernel_variant`` checks, so both accept them for
signature parity and compute the wide form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import native
from .dispense import sort_perm, take_by_weight_batch

# Strategy codes — shared with refimpl.divider
DUPLICATED = 0
STATIC_WEIGHT = 1
DYNAMIC_WEIGHT = 2
AGGREGATED = 3


class DivideResult(NamedTuple):
    assignment: torch.Tensor  # int32[B, C] replicas per cluster
    unschedulable: torch.Tensor  # bool[B] — available < target (FitError)


def _aggregated_prefix_mask(
    weights: torch.Tensor,  # int32[B, C] availability in this mode
    is_prev: torch.Tensor,  # bool[B, C] previously-scheduled (>0 replicas)
    target: torch.Tensor,  # int64[B, 1]
) -> torch.Tensor:
    """bool[B, C]: minimal prefix of (prev desc, avail desc, idx asc) order
    whose cumulative availability reaches ``target`` (resortAvailableClusters
    + the prefix loop, assignment.go:146-173), as divide.py:95-107 computes
    it: the kept set is every column at or before the cut position."""
    b, c = weights.shape
    idx = torch.arange(c, dtype=torch.int32, device=weights.device)[None, :]
    prev_key = torch.where(is_prev, 0, 1).to(torch.int32)
    neg_w = -weights  # int32 negation, wrapping as in JAX
    perm = sort_perm(prev_key, neg_w)
    nw_s = neg_w.gather(1, perm)
    cum_before = torch.cumsum((-nw_s).to(torch.int64), dim=1) + nw_s.to(torch.int64)
    n_keep = (cum_before < target).sum(dim=1, keepdim=True)
    pos = (n_keep - 1).clamp(0, c - 1)
    thr_i = perm.gather(1, pos).to(torch.int32)
    thr_p = prev_key.gather(1, thr_i.to(torch.int64))
    thr_w = -nw_s.gather(1, pos)
    le_thr = (prev_key < thr_p) | (
        (prev_key == thr_p)
        & ((weights > thr_w) | ((weights == thr_w) & (idx <= thr_i)))
    )
    return le_thr & (n_keep > 0)


def divide_replicas_ref(
    strategy: torch.Tensor,  # int32[B]
    replicas: torch.Tensor,  # int32[B]
    candidates: torch.Tensor,  # bool[B, C] post-filter feasibility
    static_w: torch.Tensor,  # int32[B, C] rule-matched static weights
    avail: torch.Tensor,  # int32[B, C] estimator availability
    prev: torch.Tensor,  # int32[B, C] full previous assignment
    fresh: torch.Tensor,  # bool[B] reschedule triggered (Fresh mode)
    has_aggregated: bool = True,
    wide: bool = True,
    fast: tuple | None = None,
) -> DivideResult:
    """Plain torch version of K2: ``_divide_one`` of divide.py:110 over a
    batch of rows, in the wide form. ``has_aggregated=False`` skips the
    Aggregated prefix mask as the JAX kernel does; ``wide`` and ``fast`` are
    accepted for signature parity (see the module docstring)."""
    del wide, fast  # proven identical to the wide form under their gates
    i32, i64 = torch.int32, torch.int64
    b, c = candidates.shape
    strategy = strategy.to(i32)[:, None]
    reps = replicas.to(i32)[:, None]
    fresh = fresh.to(torch.bool)[:, None]
    prev = prev.to(i32)
    prev_cand = torch.where(candidates, prev, 0)  # buildScheduledClusters
    assigned = prev_cand.sum(dim=1, keepdim=True, dtype=i64)
    avail = torch.where(candidates, avail.to(i32), 0)

    is_dup = strategy == DUPLICATED
    is_static = strategy == STATIC_WEIGHT
    is_dynamic = (strategy == DYNAMIC_WEIGHT) | (strategy == AGGREGATED)

    # --- dynamic cohorts ---------------------------------------------------
    scale_down = is_dynamic & ~fresh & (assigned > reps)
    scale_up = is_dynamic & ~fresh & (assigned < reps)
    steady_noop = is_dynamic & ~fresh & (assigned == reps)
    is_fresh = is_dynamic & fresh

    target_dyn = torch.where(scale_up, reps.to(i64) - assigned, reps.to(i64))
    w_dyn = torch.where(
        is_fresh, avail + prev_cand, torch.where(scale_down, prev, avail)
    )
    init_dyn = torch.where(scale_up, prev_cand, 0)
    last_dyn = init_dyn

    # availability check precedes division (division_algorithm.go:76-78)
    unschedulable = is_dynamic & ~steady_noop & (
        w_dyn.sum(dim=1, keepdim=True, dtype=i64) < target_dyn
    )

    if has_aggregated and c:
        keep = _aggregated_prefix_mask(
            w_dyn, (prev_cand > 0) & scale_up, target_dyn
        )
        w_dyn = torch.where(
            ((strategy == AGGREGATED) & keep) | (strategy != AGGREGATED), w_dyn, 0
        )

    # --- static weights ----------------------------------------------------
    sw = torch.where(candidates, static_w.to(i32), 0)
    # all-zero weights -> every candidate weighs 1 (division_algorithm.go:63-70)
    sw = torch.where(
        sw.sum(dim=1, keepdim=True, dtype=i64) > 0, sw, candidates.to(i32)
    )
    last_static = prev_cand

    # --- unified dispense --------------------------------------------------
    num = torch.where(is_static, reps.to(i64), target_dyn).to(i32)[:, 0]
    w = torch.where(is_static, sw, w_dyn)
    last = torch.where(is_static, last_static, last_dyn)
    init = torch.where(is_static, 0, init_dyn)
    w = torch.where(is_dup | steady_noop | unschedulable, 0, w)  # no dispense
    out = take_by_weight_batch(num, w, last, init, wide=True)

    out = torch.where(steady_noop, prev_cand, out)
    out = torch.where(is_dup, torch.where(candidates, reps, 0), out)
    out = torch.where(unschedulable, 0, out)
    # a zero-replica binding assigns all candidates with replicas 0 upstream
    out = torch.where(reps == 0, 0, out)
    return DivideResult(assignment=out, unschedulable=unschedulable[:, 0])


_ARGS = ("strategy", "replicas", "candidates", "static_w", "avail", "prev", "fresh")
_DTYPES = (
    torch.int32, torch.int32, torch.bool, torch.int32, torch.int32,
    torch.int32, torch.bool,
)


#: blocks of K2's second kernel, which takes the Aggregated rows with a
#: negative dynamic weight (csrc/divide_replicas.cu); each sorts in its own
#: slice of global scratch
LITERAL_BLOCKS = 16


def launch_buffers(b: int, c: int, device) -> tuple:
    """What one K2 launch writes: the assignment, the unschedulable flags,
    the hand-over list of the second kernel (int32[B + 1]) and its sort
    scratch (one next-power-of-two slice of C keys a block), and that
    kernel's block count."""
    lit_blocks = max(1, min(LITERAL_BLOCKS, b))
    n_pow2 = 1 << max(0, c - 1).bit_length()
    return (
        torch.empty((b, c), dtype=torch.int32, device=device),
        torch.empty((b,), dtype=torch.bool, device=device),
        torch.empty((b + 1,), dtype=torch.int32, device=device),
        torch.empty((lit_blocks * n_pow2,), dtype=torch.int64, device=device),
        lit_blocks,
    )


def divide_replicas(
    strategy: torch.Tensor,
    replicas: torch.Tensor,
    candidates: torch.Tensor,
    static_w: torch.Tensor,
    avail: torch.Tensor,
    prev: torch.Tensor,
    fresh: torch.Tensor,
    has_aggregated: bool = True,
    wide: bool = True,
    fast: tuple | None = None,
) -> DivideResult:
    """K2: batched AssignReplicas over a binding chunk.

    CPU tensors take ``divide_replicas_ref``; CUDA tensors launch the kernel
    (one thread block per row, at any cluster count) or raise.
    ``divide_replicas.launches`` counts kernel launches."""
    args = (strategy, replicas, candidates, static_w, avail, prev, fresh)
    if native.on_cpu(args):
        return divide_replicas_ref(*args, has_aggregated, wide, fast)
    native.check("divide_replicas",
                 **{n: (t, dt) for n, t, dt in zip(_ARGS, args, _DTYPES)})
    dev = candidates.device
    b, c = candidates.shape
    if any(t.shape != (b,) for t in (strategy, replicas, fresh)) or any(
        t.shape != (b, c) for t in (static_w, avail, prev)
    ):
        raise ValueError("divide_replicas: inconsistent shapes")
    bufs = launch_buffers(b, c, dev)
    if b:
        native.launch(divide_replicas, "divide_replicas",
                      "divide_replicas_launch", dev, *args, b, c,
                      int(bool(has_aggregated)), *bufs)
    return DivideResult(assignment=bufs[0], unschedulable=bufs[1])


divide_replicas.launches = 0
