"""Vectorized largest-remainder dispenser — the innermost division step.

Counterpart of ``karmada_tpu/ops/dispense.py`` in plain torch: Dispenser.
TakeByWeight (ref: pkg/util/helper/binding.go:112-144) with the
deterministic total order (weight desc, lastReplicas desc, cluster-index
asc). Each cluster gets floor(w * num / sum(w)); the ``remain`` leftover
replicas go one each to the clusters highest in that order.

The bonus set is "key >= the key of the remain-th sorted element", found by
a keys-only sort and an elementwise lexicographic compare, exactly as the JAX
kernel does it. ``lax.sort`` with ``num_keys=3`` becomes chained stable sorts,
minor key first; the keys are negated in int32 as in the JAX kernel, so even
INT32_MIN (whose negation wraps to itself) orders as it does there.

The JAX package's ``take_by_weight_fast`` (packed 31-bit keys, top_k, f32
reciprocal division) is proven identical to the wide form under its
host-checked gates; the port computes the wide form only, and the engine's
division kernel (``ops/divide.py``, K2) is that form.
"""

from __future__ import annotations

import torch

# Accumulator dtypes of the dispense/divide integer math, single-sourced as
# in the JAX package: ``wide`` selects int64, otherwise int32.
ACC_WIDE = torch.int64
ACC_NARROW = torch.int32


def acc_dtype(wide: bool) -> torch.dtype:
    """The accumulator dtype selected by a kernel's ``wide`` flag."""
    return ACC_WIDE if wide else ACC_NARROW


def sort_perm(*keys: torch.Tensor) -> torch.Tensor:
    """int64[B, C] permutation sorting each row lexicographically by
    ``keys`` (major first), ties by column index: chained stable sorts,
    minor key first."""
    b, c = keys[0].shape
    perm = torch.arange(c, device=keys[0].device).expand(b, c)
    for key in reversed(keys):
        order = torch.sort(key.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return perm


def take_by_weight_batch(
    num: torch.Tensor,  # int32[B]: replicas to dispense
    weights: torch.Tensor,  # int32[B, C], >= 0 (0 = excluded from dispensing)
    last: torch.Tensor,  # int32[B, C], previous replicas (tie-break inertia)
    init: torch.Tensor,  # int32[B, C], initial result merged into the output
    wide: bool = True,  # int64 accumulation (False = proven-int32 path)
) -> torch.Tensor:
    """int32[B, C] replica assignment == Dispenser result, row by row.

    A zero weight sum returns ``init`` unchanged (binding.go:117-120)."""
    b, c = weights.shape
    acc = acc_dtype(wide)
    num = num.to(torch.int32)[:, None]
    if c == 0:
        return init.clone()
    idx = torch.arange(c, dtype=torch.int32, device=weights.device)[None, :]

    # the product runs in the accumulator dtype; the sum (and so the
    # division) in int64 whatever it is, as jnp.sum promotes int32 under x64
    total = weights.to(acc).sum(dim=1, keepdim=True, dtype=torch.int64)
    safe_total = total.clamp_min(1)
    floors = torch.div(
        (weights.to(acc) * num.to(acc)).to(torch.int64), safe_total,
        rounding_mode="floor",
    ).to(torch.int32)
    remain = num.to(torch.int64) - floors.sum(dim=1, keepdim=True, dtype=torch.int64)

    neg_w, neg_l = -weights, -last  # int32 negation, wrapping as in JAX
    perm = sort_perm(neg_w, neg_l)
    pos = (remain - 1).clamp(0, c - 1)
    thr_i = perm.gather(1, pos).to(torch.int32)
    thr_w = -neg_w.gather(1, thr_i.to(torch.int64))
    thr_l = -neg_l.gather(1, thr_i.to(torch.int64))
    ge_thr = (weights > thr_w) | (
        (weights == thr_w) & ((last > thr_l) | ((last == thr_l) & (idx <= thr_i)))
    )
    bonus = (ge_thr & (remain > 0)).to(torch.int32)
    dispensed = torch.where(total > 0, floors + bonus, 0)
    return init + dispensed


def take_by_weight(
    num: torch.Tensor,  # int32 scalar
    weights: torch.Tensor,  # int32[C]
    last: torch.Tensor,  # int32[C]
    init: torch.Tensor,  # int32[C]
    wide: bool = True,
) -> torch.Tensor:
    """One binding's dispense: ``take_by_weight_batch`` over a batch of 1."""
    return take_by_weight_batch(
        num.reshape(1), weights[None], last[None], init[None], wide
    )[0]
