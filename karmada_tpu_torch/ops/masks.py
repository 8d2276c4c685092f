"""Bitset machinery for label/taint/GVK matching at tensor speed.

Label selectors, tolerations, and API enablement are the O(bindings x
clusters) constant factor of the reference's filter loop
(framework/plugins/*). Here every string universe is interned into a bit
vocabulary (label key=value pairs, label keys, taint triples, GVKs) and packed
into uint32 words, so a full selector evaluates as a handful of AND/OR/
popcount ops over ``[C, words]`` arrays — no string work on the hot path.

The port's copy runs on the host in numpy, once per snapshot and placement
compile. So does ``first_fit_group``, the ranked ClusterAffinities
selection of the ordered-failover path: the JAX engine calls it with numpy
arrays at every call site (karmada_tpu/scheduler/core.py:1258, 1495, 2559),
so it runs in numpy there too.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

WORD = 32


class Vocab:
    """String -> bit-id interning table."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._ids)
            self._ids[s] = i
        return i

    def get(self, s: str) -> int | None:
        return self._ids.get(s)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, s: str) -> bool:
        return s in self._ids

    @property
    def words(self) -> int:
        return max(1, (len(self._ids) + WORD - 1) // WORD)


def pack_bits(rows: Sequence[Iterable[int]], words: int) -> np.ndarray:
    """Pack per-row bit-id lists into uint32[rows, words]."""
    out = np.zeros((len(rows), words), dtype=np.uint32)
    for r, ids in enumerate(rows):
        for i in ids:
            out[r, i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return out


def bits_from_ids(ids: Iterable[int], words: int) -> np.ndarray:
    """Pack one bit-id list into uint32[words]."""
    return pack_bits([list(ids)], words)[0]


def contains_all(bits, require) -> np.ndarray:
    """bool[...]: every bit of ``require`` present in ``bits``.
    bits: uint32[..., W]; require: uint32[W] (broadcast)."""
    return ((bits & require) == require).all(axis=-1)


def intersects(bits, other) -> np.ndarray:
    """bool[...]: any common bit."""
    return ((bits & other) != 0).any(axis=-1)


def affinity_group_rank(term_masks: np.ndarray) -> np.ndarray:
    """int32[..., C] ordered-failover rank tensor: for each cluster, the
    index of the FIRST affinity term (ClusterAffinities fallback group)
    whose mask contains it, ``T`` where none does (scheduler.go:533-596's
    group order as data instead of control flow). ``term_masks``:
    bool[..., T, C]."""
    t = term_masks.shape[-2]
    idx = np.where(
        term_masks,
        np.arange(t, dtype=np.int32).reshape((t, 1)),
        np.int32(t),
    )
    return idx.min(axis=-2)


def first_fit_group(
    cand_tc: np.ndarray,  # bool[B, T, C] per-term candidate sets
    term_len: np.ndarray,  # int32[B] live terms per row (<= T)
    avail: np.ndarray,  # int64[B, C] merged estimator availability
    replicas: np.ndarray,  # int64[B]
    prev: np.ndarray,  # int64[B, C] previous placements
    dynamic: np.ndarray,  # bool[B] divided dynamic-family strategy
    fresh: np.ndarray,  # bool[B] reschedule-triggered
) -> tuple[np.ndarray, np.ndarray]:
    """Batched ordered-failover group selection: each row's FIRST term
    whose candidate set both exists and passes the divider's
    schedulability predicate — the exact cohort math of
    ``refimpl.divider_np.assign_batch_np`` (fresh credits prev, scale-down
    weighs FULL prev, scale-up targets the shortfall, steady no-ops), so
    selecting group t here and then solving once is placement-identical
    to solving groups 0..t in sequence and keeping the first success.

    Returns ``(rank int32[B], fit bool[B])``; rows where NO group fits get
    their LAST live term (its solve produces the failure the per-round
    loop would have reported). The T axis is a short host loop (T = max
    ClusterAffinities length, almost always <= 4) over fully-batched
    [B, C] reductions — O(B*T*C) adds, no [B, T, C] integer temporaries.
    """
    _b, t, _c = cand_tc.shape
    num = replicas.astype(np.int64)
    prev_full_sum = prev.sum(axis=1)
    cand_any = cand_tc.any(axis=2)
    # per-term masked sums as a stack over the short T axis
    avail_sum = np.stack(
        [np.where(cand_tc[:, ti, :], avail, 0).sum(axis=1)
         for ti in range(t)],
        axis=1,
    )
    prev_sum = np.stack(
        [np.where(cand_tc[:, ti, :], prev, 0).sum(axis=1)
         for ti in range(t)],
        axis=1,
    )
    dyn = dynamic[:, None]
    fr = fresh[:, None]
    num_col = num[:, None]
    scale_down = dyn & ~fr & (prev_sum > num_col)
    scale_up = dyn & ~fr & (prev_sum < num_col)
    steady = dyn & ~fr & (prev_sum == num_col)
    target = np.where(scale_up, num_col - prev_sum, num_col)
    w_sum = np.where(
        fr,
        avail_sum + prev_sum,
        np.where(scale_down, prev_full_sum[:, None], avail_sum),
    )
    unsched = dyn & ~steady & (w_sum < target)
    live = np.arange(t, dtype=np.int32)[None, :] < term_len[:, None]
    fit_t = cand_any & ~unsched & live
    fit = fit_t.any(axis=1)
    # first-fitting-group extraction: first-true-index over the T axis
    # (affinity_group_rank's primitive)
    term_idx = np.arange(t, dtype=np.int32)[None, :]
    rank = np.where(fit_t, term_idx, np.int32(t)).min(axis=1)
    last = np.maximum(term_len - 1, 0).astype(np.int32)
    return np.where(fit, rank, last).astype(np.int32), fit


def label_pair(key: str, value: str) -> str:
    return f"{key}={value}"


def intern_labels(vocab: Vocab, key_vocab: Vocab, labels: Mapping[str, str]) -> tuple[list[int], list[int]]:
    """Intern a label map into (pair_ids, key_ids)."""
    pair_ids = [vocab.intern(label_pair(k, v)) for k, v in labels.items()]
    key_ids = [key_vocab.intern(k) for k in labels]
    return pair_ids, key_ids
