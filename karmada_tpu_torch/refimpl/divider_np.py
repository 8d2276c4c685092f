"""Vectorized-numpy host divider: the tiny-batch path and the card's oracle.

The port's own copy of ``karmada_tpu/refimpl/divider_np.py``. The same
division semantics (division_algorithm.go:75-152, binding.go:112-144) as one
vectorized numpy program: batched cohort masks, exact largest-remainder
apportion with the (weight desc, lastReplicas desc, index asc) order resolved
by an argpartition+sort of the top candidates instead of a full per-row sort.

Two users in the port: ``TensorScheduler._schedule_chunk`` answers chunks
with ``padded * C <= 2**16`` here on the host (the JAX engine's own rule), and
``chip_smoke.py`` checks every row that the card's kernels place against it.
"""

from __future__ import annotations

import numpy as np

from .divider import AGGREGATED, DUPLICATED, DYNAMIC_WEIGHT, STATIC_WEIGHT

MAX_INT32 = 2**31 - 1

#: accumulation dtype of the host divider. MUST stay in parity with the
#: kernels' wide accumulator (karmada_tpu_torch.ops.dispense.ACC_WIDE) —
#: identical placements require both sides to agree on the overflow-free
#: integer range for weight*replica products and availability cumsums.
ACC_NP = np.int64


def _dispense_np(
    num: np.ndarray,  # int64[B] replicas to dispense
    w: np.ndarray,  # int64[B, C] weights (0 = excluded)
    last: np.ndarray,  # int64[B, C] previous replicas (tie-break)
    init: np.ndarray,  # int64[B, C] merged into the result
    k_bound: int,  # >= max(num) — bounds the remainder rank
) -> np.ndarray:
    """Batched TakeByWeight (binding.go:112-144): floors + the remainder
    handed out in (weight desc, last desc, index asc) order."""
    b, c = w.shape
    total = w.sum(axis=1)
    safe_total = np.maximum(total, 1)
    floors = w * num[:, None] // safe_total[:, None]
    remain = num - floors.sum(axis=1)

    # the bonus goes to the `remain` largest (w, last, -idx) keys; remain
    # <= num <= k_bound, so only the top-k keys per row matter. The triple
    # packs exactly into one int64 via mixed-radix arithmetic.
    idx = np.arange(c, dtype=ACC_NP)
    lmax = int(last.max(initial=0)) + 1
    wmax = int(w.max(initial=0))
    assert (wmax + 1) * lmax * c < 2**63, "weights exceed the packed baseline"
    key = (w * lmax + last) * c + (c - 1 - idx)[None, :]
    k = min(k_bound, c)
    if k < c:
        top_idx = np.argpartition(key, c - k, axis=1)[:, c - k :]
    else:
        top_idx = np.broadcast_to(idx[None, :], (b, c))
    top_keys = np.take_along_axis(key, top_idx, axis=1)
    top_sorted = -np.sort(-top_keys, axis=1)  # desc
    pos = np.clip(remain - 1, 0, k - 1).astype(ACC_NP)
    thr = np.take_along_axis(top_sorted, pos[:, None], axis=1)[:, 0]
    bonus = (key >= thr[:, None]) & (remain > 0)[:, None]
    dispensed = np.where(
        (total > 0)[:, None], floors + bonus.astype(ACC_NP), 0
    )
    return init + dispensed


def _aggregated_keep_np(
    w: np.ndarray,  # int64[B, C] availability weights
    is_prev: np.ndarray,  # bool[B, C] previously-scheduled (scale-up credit)
    target: np.ndarray,  # int64[B]
) -> np.ndarray:
    """Minimal prefix of (prev desc, avail desc, idx asc) whose cumulative
    availability covers target (assignment.go:146-173 + the resort)."""
    b, c = w.shape
    idx = np.arange(c, dtype=ACC_NP)
    prev_key = np.where(is_prev, 0, 1)
    order = np.lexsort((idx[None, :].repeat(b, 0), -w, prev_key), axis=1)
    w_sorted = np.take_along_axis(w, order, axis=1)
    cum_before = np.cumsum(w_sorted, axis=1) - w_sorted
    keep_sorted = cum_before < target[:, None]
    keep = np.zeros((b, c), bool)
    np.put_along_axis(keep, order, keep_sorted, axis=1)
    return keep


def assign_batch_np(
    strategy: np.ndarray,  # int32[B]
    replicas: np.ndarray,  # int32[B]
    candidates: np.ndarray,  # bool[B, C]
    static_w: np.ndarray,  # int32[B, C]
    avail: np.ndarray,  # int32[B, C]
    prev: np.ndarray,  # int32[B, C]
    fresh: np.ndarray,  # bool[B]
) -> tuple[np.ndarray, np.ndarray]:
    """Batched AssignReplicas over [B, C] numpy arrays; returns
    (assignment int32[B, C], unschedulable bool[B]). Mirrors
    assignment.go:31-38 dispatch + division_algorithm.go cohorts."""
    b, c = candidates.shape
    strategy = strategy.astype(ACC_NP)
    num = replicas.astype(ACC_NP)
    prev = prev.astype(ACC_NP)
    avail = np.where(candidates, avail, 0).astype(ACC_NP)
    prev_cand = np.where(candidates, prev, 0)
    assigned = prev_cand.sum(axis=1)
    fresh = fresh.astype(bool)

    is_dup = strategy == DUPLICATED
    is_static = strategy == STATIC_WEIGHT
    is_dynamic = (strategy == DYNAMIC_WEIGHT) | (strategy == AGGREGATED)

    scale_down = is_dynamic & ~fresh & (assigned > num)
    scale_up = is_dynamic & ~fresh & (assigned < num)
    steady_noop = is_dynamic & ~fresh & (assigned == num)
    is_fresh = is_dynamic & fresh

    target_dyn = np.where(scale_up, num - assigned, num)
    w_dyn = np.where(
        is_fresh[:, None],
        avail + prev_cand,
        np.where(scale_down[:, None], prev, avail),
    )
    init_dyn = np.where(scale_up[:, None], prev_cand, 0)

    unsched = is_dynamic & ~steady_noop & (w_dyn.sum(axis=1) < target_dyn)

    if (strategy == AGGREGATED).any():
        keep = _aggregated_keep_np(
            w_dyn, (prev_cand > 0) & scale_up[:, None], target_dyn
        )
        w_dyn = np.where(
            ((strategy == AGGREGATED)[:, None] & keep)
            | (strategy != AGGREGATED)[:, None],
            w_dyn,
            0,
        )

    sw = np.where(candidates, static_w, 0).astype(ACC_NP)
    sw = np.where(
        (sw.sum(axis=1) > 0)[:, None], sw, candidates.astype(ACC_NP)
    )
    last_static = np.where(candidates, prev, 0)

    num_d = np.where(is_static, num, target_dyn)
    w = np.where(is_static[:, None], sw, w_dyn)
    last = np.where(is_static[:, None], last_static, init_dyn)
    init = np.where(is_static[:, None], 0, init_dyn)
    w = np.where((is_dup | steady_noop | unsched)[:, None], 0, w)

    k_bound = max(1, int(num_d.max(initial=0)))
    out = _dispense_np(num_d, w, last, init, k_bound)

    out = np.where(steady_noop[:, None], prev_cand, out)
    out = np.where(
        is_dup[:, None], np.where(candidates, num[:, None], 0), out
    )
    out = np.where(unsched[:, None], 0, out)
    out = np.where((num == 0)[:, None], 0, out)
    return out.astype(np.int32), unsched
