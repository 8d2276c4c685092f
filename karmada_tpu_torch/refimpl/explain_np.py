"""Per-binding numpy referent of the placement-provenance kernel.

The port's copy of ``karmada_tpu/refimpl/explain_np.py``. It derives a
binding's diagnostics the way the reference walks its
Filter/Score/Select/AssignReplicas pipeline: plain Python loops with one
``if`` per decision stage per cluster, and a per-binding Python sort for the
candidate summary, sharing no code with ``ops/explain.py`` (a vectorized
bit-or and a packed-key top-k). The tests and ``chip_smoke.py`` hold K14
and its plain version to it; nothing on a scheduling path calls it.

Stage order (bit positions) comes from ``utils.reasons.STAGE_REASONS``.
"""

from __future__ import annotations

import numpy as np

from ..utils.reasons import STAGE_REASONS

_BIT = {code: i for i, code in enumerate(STAGE_REASONS)}


def explain_one(
    aff_ok_row,  # bool[C]
    taint_ok_row,  # bool[C]
    api_ok_row,  # bool[C]
    spread_ok_row,  # bool[C]
    avail_row,  # int[C]
    caps_row,  # int[C]
    admitted: bool,
    dynamic: bool,
    replicas: int,
    assignment_row,  # int[C]
    prev_row,  # int[C]
    preempted_row,  # bool[C]
    k: int,
) -> tuple[np.ndarray, list[tuple]]:
    """One binding's exclusion bits + top-k summary, the reference way:
    each cluster walks the stage list in order and collects every stage
    that rejects it (the reference's filter plugins each record their
    own failure; a cluster can fail several)."""
    c = len(aff_ok_row)
    mask = np.zeros(c, np.uint8)
    consults = bool(dynamic) and int(replicas) > 0
    for j in range(c):
        bits = 0
        if not aff_ok_row[j]:
            bits |= 1 << _BIT["AffinityMismatch"]
        if not taint_ok_row[j]:
            bits |= 1 << _BIT["TaintUntolerated"]
        if not api_ok_row[j]:
            bits |= 1 << _BIT["ApiNotEnabled"]
        if consults and int(avail_row[j]) <= 0:
            bits |= 1 << _BIT["NoAvailableReplicas"]
        if consults and int(caps_row[j]) <= 0:
            bits |= 1 << _BIT["QuotaCapExceeded"]
        if not admitted:
            bits |= 1 << _BIT["QuotaExceeded"]
        if not spread_ok_row[j]:
            bits |= 1 << _BIT["SpreadConstraintUnsatisfied"]
        if preempted_row[j]:
            bits |= 1 << _BIT["PreemptedByHigherPriority"]
        mask[j] = bits
    # candidate summary: assigned desc, then availability desc, then
    # index asc — the reference's stable ordering for result rendering
    order = sorted(
        range(c),
        key=lambda j: (-int(assignment_row[j]), -int(avail_row[j]), j),
    )
    topk = [
        (
            j,
            int(avail_row[j]),
            int(prev_row[j]),
            int(assignment_row[j]),
            int(mask[j]),
        )
        for j in order[:k]
    ]
    return mask, topk


def explain_batch_np(
    aff_ok,  # bool[B, C]
    taint_ok,
    api_ok,
    spread_ok,
    avail,
    caps,
    admitted,  # bool[B]
    dynamic,  # bool[B]
    replicas,  # int[B]
    assignment,
    prev,
    preempted,  # bool[B, C]
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched form: loops ``explain_one`` per binding and packs the
    kernel-shaped outputs (uint8[B, C], int32[B, K, 5])."""
    b, c = np.asarray(aff_ok).shape
    masks = np.zeros((b, c), np.uint8)
    topk = np.zeros((b, k, 5), np.int32)
    for i in range(b):
        mask, rows = explain_one(
            np.asarray(aff_ok)[i], np.asarray(taint_ok)[i],
            np.asarray(api_ok)[i], np.asarray(spread_ok)[i],
            np.asarray(avail)[i], np.asarray(caps)[i],
            bool(np.asarray(admitted)[i]), bool(np.asarray(dynamic)[i]),
            int(np.asarray(replicas)[i]), np.asarray(assignment)[i],
            np.asarray(prev)[i], np.asarray(preempted)[i], k,
        )
        masks[i] = mask
        for slot, row in enumerate(rows):
            topk[i, slot] = row
    return masks, topk
