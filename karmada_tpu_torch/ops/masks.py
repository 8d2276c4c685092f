"""Bitset machinery for label/taint/GVK matching at tensor speed.

Label selectors, tolerations, and API enablement are the O(bindings x
clusters) constant factor of the reference's filter loop
(framework/plugins/*). Here every string universe is interned into a bit
vocabulary (label key=value pairs, label keys, taint triples, GVKs) and packed
into uint32 words, so a full selector evaluates as a handful of AND/OR/
popcount ops over ``[C, words]`` arrays — no string work on the hot path.

The port's copy of the bit machinery runs on the host in numpy, once per
snapshot and placement compile. ``first_fit_group``, the ranked
ClusterAffinities selection of the ordered-failover path, is the
hand-written kernel K17 (``csrc/first_fit_group.cu``) on CUDA tensors and
its plain torch version ``first_fit_group_ref`` on CPU tensors.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from .. import native
from .estimate import _clip_rows

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


def first_fit_group_ref(
    base: torch.Tensor,  # bool[B, C] every filter but the affinity term
    terms: torch.Tensor,  # bool[U, T, C] ClusterAffinities term masks per placement
    cp_idx: torch.Tensor,  # int32[B] row -> placement
    term_len: torch.Tensor,  # int32[U] live terms per placement (<= T)
    avail: torch.Tensor,  # int32[B, C] merged estimator availability
    replicas: torch.Tensor,  # int32[B]
    prev: torch.Tensor,  # int32[B, C] previous placements
    dynamic: torch.Tensor,  # bool[B] divided dynamic-family strategy
    fresh: torch.Tensor,  # bool[B] reschedule-triggered
    with_base: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ordered-failover group selection (karmada_tpu/ops/masks.py:100):
    each row's FIRST term whose candidate set ``base & terms[cp_idx, t]``
    both exists and passes the divider's schedulability predicate — the
    exact cohort math of ``refimpl.divider_np.assign_batch_np`` (fresh
    credits prev, scale-down weighs FULL prev, scale-up targets the
    shortfall, steady no-ops), so selecting group t here and then solving
    once is placement-identical to solving groups 0..t in sequence and
    keeping the first success.

    Returns ``(rank int32[B], fit bool[B], selected bool[B, C])``; rows
    where NO group fits get their LAST live term (its solve produces the
    failure the per-round loop would have reported). ``selected`` is
    ``base & terms[cp_idx, rank]``, or the term mask alone with
    ``with_base=False``. ``cp_idx`` wraps and clamps as a jnp gather does.
    The T axis is a loop over [B, C] reductions in int64: the stack of every
    term's candidate set is never built."""
    b, c = base.shape
    t_n = terms.shape[1]
    u = _clip_rows(cp_idx, terms.shape[0])
    tl = term_len.to(torch.int64)[u]
    num = replicas.to(torch.int64)
    avail64 = avail.to(torch.int64)
    prev64 = prev.to(torch.int64)
    prev_full = prev64.sum(dim=1)
    dyn, fr = dynamic.bool(), fresh.bool()
    cohort = dyn & ~fr
    rank = torch.zeros(b, dtype=torch.int64, device=base.device)
    fit = torch.zeros(b, dtype=torch.bool, device=base.device)
    for t in range(t_n):
        cand = base & terms[u, t]
        avail_sum = torch.where(cand, avail64, 0).sum(dim=1)
        prev_sum = torch.where(cand, prev64, 0).sum(dim=1)
        scale_down = cohort & (prev_sum > num)
        scale_up = cohort & (prev_sum < num)
        steady = cohort & (prev_sum == num)
        target = torch.where(scale_up, num - prev_sum, num)
        w_sum = torch.where(fr, avail_sum + prev_sum,
                            torch.where(scale_down, prev_full, avail_sum))
        unsched = dyn & ~steady & (w_sum < target)
        fit_t = cand.any(dim=1) & ~unsched & (t < tl)
        rank = torch.where(fit_t & ~fit, t, rank)
        fit |= fit_t
    rank = torch.where(fit, rank, (tl - 1).clamp_min(0))
    sel = terms[u, rank.clamp_max(t_n - 1)]
    return rank.to(torch.int32), fit, (sel & base if with_base else sel)


def first_fit_group(
    base: torch.Tensor,
    terms: torch.Tensor,
    cp_idx: torch.Tensor,
    term_len: torch.Tensor,
    avail: torch.Tensor,
    replicas: torch.Tensor,
    prev: torch.Tensor,
    dynamic: torch.Tensor,
    fresh: torch.Tensor,
    with_base: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K17: ``first_fit_group_ref`` as one kernel launch on CUDA tensors, at
    any row count, term count and cluster count.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``first_fit_group.launches`` counts kernel launches."""
    args = (base, terms, cp_idx, term_len, avail, replicas, prev, dynamic, fresh)
    if native.on_cpu(args):
        return first_fit_group_ref(*args, with_base=with_base)
    native.check(
        "first_fit_group", base=(base, torch.bool), terms=(terms, torch.bool),
        cp_idx=(cp_idx, torch.int32), term_len=(term_len, torch.int32),
        avail=(avail, torch.int32), replicas=(replicas, torch.int32),
        prev=(prev, torch.int32), dynamic=(dynamic, torch.bool),
        fresh=(fresh, torch.bool))
    b, c = base.shape
    u, t_n = terms.shape[:2]
    if (terms.shape != (u, t_n, c) or cp_idx.shape != (b,) or term_len.shape != (u,)
            or avail.shape != (b, c) or prev.shape != (b, c)
            or any(x.shape != (b,) for x in (replicas, dynamic, fresh))):
        raise ValueError("first_fit_group: inconsistent shapes")
    if b and not (u and t_n):
        raise ValueError(f"first_fit_group: {b} rows over {u} placements of {t_n} terms")
    dev = base.device
    rank = torch.empty(b, dtype=torch.int32, device=dev)
    fit = torch.empty(b, dtype=torch.bool, device=dev)
    selected = torch.empty((b, c), dtype=torch.bool, device=dev)
    if b:
        native.launch(first_fit_group, "first_fit_group", "first_fit_group_launch",
                      dev, *args, b, u, t_n, c, int(with_base), rank, fit, selected)
    return rank, fit, selected


first_fit_group.launches = 0


def label_pair(key: str, value: str) -> str:
    return f"{key}={value}"


def intern_labels(vocab: Vocab, key_vocab: Vocab, labels: Mapping[str, str]) -> tuple[list[int], list[int]]:
    """Intern a label map into (pair_ids, key_ids)."""
    pair_ids = [vocab.intern(label_pair(k, v)) for k, v in labels.items()]
    key_ids = [key_vocab.intern(k) for k in labels]
    return pair_ids, key_ids
