"""Preemption: plane-wide victim selection as one batched pass.

Counterpart of ``karmada_tpu/ops/preempt.py``. When a wave's priority > 0
rows cannot fit, the engine selects victims over the whole plane at once
and re-solves the demanders against the freed capacity in the same pass.
The selection rule (``refimpl/preempt_np.py`` is the sequential referent):

- demanders are the priority > 0 rows whose solve answered "available
  replicas are not enough"; each contributes its shortfall x per-replica
  request of unmet demand to its priority class;
- candidate victims are bound rows; a victim serves only demand from
  classes strictly above its own priority;
- victims are taken lowest priority first, then largest displacement
  weight (assigned replicas), then arrival (row index);
- a victim is selected iff some dim it frees still has unmet demand from
  the classes above it at its place in that order: ``exists r: freed[v, r]
  > 0 and cum_excl[v, r] < demand_gt(prio_v)[r]``, with ``cum_excl`` the
  freed capacity of every earlier row in the order.

``preempt_select`` (K15, ``csrc/preempt_select.cu``) returns the victim
flags and the per-cluster freed capacity ``[C, R]`` (victim assignment x
per-replica request, summed over the victims). ``preempt_select_ref`` is
the plain torch version; the wrapper takes it on CPU tensors and launches
the kernel on CUDA tensors. Every int64 sum and product wraps modulo 2^64,
as in JAX; demand and freed rows are clamped to ``DEMAND_CLAMP`` by the
packing layer, and a pass holds at most ``MAX_ADMIT_ROWS`` rows.
"""

from __future__ import annotations

import torch

from .. import native
from .quota import _BINS, _SCAN_TILE, _TILE, MAX_ADMIT_ROWS

#: priority values must fit the packed sort key beside the displacement
#: weight and row index: prio in [0, 2^20), weight < 2^20, B <= 2^17
MAX_PRIORITY = (1 << 20) - 1
MAX_WEIGHT = (1 << 20) - 1

#: the counts of K15's sort: two arrays of eight 8-bit digits
_SORT_COUNTS = 2 * 8 * _BINS


def _check(prio, demand, freed, victim_ok, weight, assigned, requests,
           b_key) -> tuple[int, int, int, int]:
    b, r = demand.shape
    b_key = b if b_key is None else int(b_key)
    if b_key < b:
        raise ValueError(f"preempt_select: b_key {b_key} below the {b} rows")
    if b_key > MAX_ADMIT_ROWS:
        # the DEMAND_CLAMP headroom holds only up to this many rows (the JAX
        # program asserts it inside its jitted call)
        raise ValueError(f"preempt_select: {b_key} rows, at most {MAX_ADMIT_ROWS}")
    c = assigned.shape[1]
    if (prio.shape != (b,) or victim_ok.shape != (b,) or weight.shape != (b,)
            or freed.shape != (b, r) or requests.shape != (b, r)
            or assigned.shape != (b, c)):
        raise ValueError("preempt_select: inconsistent shapes")
    return b, r, c, b_key


def preempt_select_ref(prio, demand, freed, victim_ok, weight, assigned, requests,
                       b_key: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K15: ``(victims bool[B], freed_caps int64[C, R])``,
    the JAX program step by step: the stable sorts by its packed keys, the
    cumsums, the searchsorted lookup of demand_gt, the scatter back to row
    order. Torch has no int64 matrix product on CUDA, so the freed capacity
    reduces per dim over the selected rows.

    ``b_key`` (default: the row count) is the row count the packed sort
    keys are built with: the JAX program's padded row count, so that a key
    that wraps (a priority at or above 2^43 / b_key) wraps as there. The
    JAX program's pad rows are priority-0 rows that demand and free
    nothing, so they change nothing else."""
    b, r, c, bk = _check(prio, demand, freed, victim_ok, weight, assigned, requests, b_key)
    dev = demand.device
    victims = torch.zeros(b, dtype=torch.bool, device=dev)
    freed_caps = torch.zeros((c, r), dtype=torch.int64, device=dev)
    if b == 0:
        return victims, freed_caps
    p64 = prio.to(torch.int64)
    idx64 = torch.arange(b, dtype=torch.int64, device=dev)
    d_order = torch.argsort(-(p64 * bk) - (bk - 1 - idx64), stable=True)
    d_prio = p64[d_order]
    d_demand = demand.to(torch.int64)[d_order]
    d_cum = torch.cumsum(d_demand, dim=0)
    d_cum_excl = d_cum - d_demand

    w64 = weight.to(torch.int64).clamp(0, MAX_WEIGHT)
    v_prio = torch.where(victim_ok, p64, MAX_PRIORITY + 1)
    v_key = v_prio * ((MAX_WEIGHT + 1) * bk) + (MAX_WEIGHT - w64) * bk + idx64
    v_order = torch.argsort(v_key, stable=True)
    v_freed = freed.to(torch.int64)[v_order]
    v_cum_excl = torch.cumsum(v_freed, dim=0) - v_freed
    v_ok = victim_ok[v_order]
    v_p = p64[v_order]

    pos = torch.searchsorted(-d_prio, -v_p, side="left")
    d_gt = d_cum_excl[pos.clamp(max=b - 1)]
    d_gt = torch.where((pos < b)[:, None], d_gt, d_cum[b - 1])
    sel_sorted = v_ok & ((v_freed > 0) & (v_cum_excl < d_gt)).any(dim=1)
    victims[v_order] = sel_sorted

    rows = torch.nonzero(victims).flatten()
    sel_assigned = assigned[rows].to(torch.int64)
    sel_requests = requests.to(torch.int64)[rows]
    for d in range(r):
        freed_caps[:, d] = (sel_assigned * sel_requests[:, d : d + 1]).sum(dim=0)
    return victims, freed_caps


def preempt_select(prio, demand, freed, victim_ok, weight, assigned, requests,
                   b_key: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K15: ``preempt_select_ref`` behind one C entry point (a stable radix
    sort of both keys, the tile sums, the selection fused with the
    victim-order scan, the freed-capacity product over the list of victims;
    see ``csrc/preempt_select.cu``).

    Inputs: ``prio`` int32[B], ``demand``/``freed``/``requests``
    int64[B, R], ``victim_ok`` bool[B], ``weight`` int32[B], ``assigned``
    int32[B, C]; any R; ``b_key`` as in ``preempt_select_ref``, at least B
    and at most MAX_ADMIT_ROWS.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``preempt_select.launches`` counts kernel launches (one per
    call)."""
    args = (prio, demand, freed, victim_ok, weight, assigned, requests)
    if native.on_cpu(args):
        return preempt_select_ref(*args, b_key=b_key)
    native.check("preempt_select", prio=(prio, torch.int32), demand=(demand, torch.int64),
                 freed=(freed, torch.int64), victim_ok=(victim_ok, torch.bool),
                 weight=(weight, torch.int32), assigned=(assigned, torch.int32),
                 requests=(requests, torch.int64))
    b, r, c, bk = _check(*args, b_key)
    dev = demand.device
    if b == 0:
        return (torch.zeros(b, dtype=torch.bool, device=dev),
                torch.zeros((c, r), dtype=torch.int64, device=dev))
    victims = torch.empty(b, dtype=torch.bool, device=dev)
    freed_caps = torch.empty((c, r), dtype=torch.int64, device=dev)
    native.launch(preempt_select, "preempt_select", "preempt_select_launch", dev,
                  *args, b, bk, r, c, victims, freed_caps, *select_scratch(b, r, dev))
    return victims, freed_caps


def select_scratch(b: int, r: int, dev) -> tuple:
    """K15's scratch after its outputs, as ``preempt_select_launch`` takes
    it: both sorts' keys (uint64 in the kernel) and rows, two buffers each;
    their digit counts and the victim count; the in-tile sums of demand in
    priority order; both orders' tile sums; the list of victims."""
    tiles, scan_tiles = -(-b // _TILE), -(-b // _SCAN_TILE)
    return (torch.empty((2, 2, b), dtype=torch.int64, device=dev),
            torch.empty((2, 2, b), dtype=torch.int32, device=dev),
            torch.empty(_SORT_COUNTS * (1 + tiles) + 1, dtype=torch.int32, device=dev),
            torch.empty((r, b), dtype=torch.int64, device=dev),
            torch.empty((2, scan_tiles, r), dtype=torch.int64, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev))


preempt_select.launches = 0
