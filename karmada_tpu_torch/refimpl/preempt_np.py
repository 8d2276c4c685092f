"""Numpy preemption referent: sequential victim selection and drift
rebalance, the reference way.

The port's copy of ``karmada_tpu/refimpl/preempt_np.py``. ``ops.
preempt_select`` (K15) computes the plane-wide selection rule as sorts and
prefix sums. This module is that rule as a reference controller would
write it: walk candidate victims one at a time in (priority asc,
displacement weight desc, arrival) order, keep per-priority-class UNMET
demand explicitly, evict a victim iff some resource dim it frees still has
unmet demand from a class strictly above its own, and credit the freed
capacity to the highest unmet class first. It shares no selection code
with the kernel. The tests and ``chip_smoke.py`` use it; nothing on a
scheduling path does.

``preempt_and_place_np`` composes selection with the per-binding numpy
divider so a whole scarcity wave verifies end to end: demanders re-solve
against availability boosted by the freed per-cluster capacity, exactly
like the engine's same-pass re-solve.

``rebalance_np`` is the continuous-descheduler referent: per binding, the
fresh-solve ideal placement by the one-row numpy divider, drift as the L1
replica distance from the resident placement, and the top ``budget`` rows
(drift desc, arrival asc).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .divider_np import assign_batch_np

MAX_INT32 = 2**31 - 1


def select_victims_np(
    prios: Sequence[int],  # per-binding priority class
    demand: np.ndarray,  # int64[B, R] unmet demand (0 for non-demanders)
    freed: np.ndarray,  # int64[B, R] capacity a victim would free
    victim_ok: Sequence[bool],  # eligible victim
    weights: Sequence[int],  # displacement weight (assigned replicas)
) -> list[bool]:
    """Sequential victim selection: returns the per-row victim flags."""
    demand = np.asarray(demand)
    freed = np.asarray(freed)
    b, r = demand.shape
    # unmet demand per priority class, highest class first
    unmet: dict[int, np.ndarray] = {}
    for i in range(b):
        d = demand[i]
        if d.any():
            q = int(prios[i])
            unmet[q] = unmet.get(q, np.zeros(r, np.int64)) + d
    order = sorted(
        (i for i in range(b) if victim_ok[i]),
        key=lambda i: (int(prios[i]), -int(weights[i]), i),
    )
    victims = [False] * b
    for v in order:
        qv = int(prios[v])
        above = sorted((q for q in unmet if q > qv), reverse=True)
        take = False
        for d in range(r):
            if freed[v, d] <= 0:
                continue
            if any(unmet[q][d] > 0 for q in above):
                take = True
                break
        if not take:
            continue
        victims[v] = True
        # credit the freed capacity to the highest unmet class first,
        # dim by dim (capacity is fungible once freed; crediting top-
        # down mirrors the wave's priority-descending solve order)
        for d in range(r):
            left = int(freed[v, d])
            for q in above:
                if left <= 0:
                    break
                used = min(left, int(unmet[q][d]))
                unmet[q][d] -= used
                left -= used
    return victims


def preempt_and_place_np(
    keys: Sequence[str],
    prios: Sequence[int],
    demand: np.ndarray,
    freed: np.ndarray,
    victim_ok: Sequence[bool],
    weights: Sequence[int],
    *,
    names: Sequence[str],  # cluster column order
    assigned: Mapping[str, Mapping[str, int]],  # key -> victim placement
    requests: Mapping[str, np.ndarray],  # key -> int64[R] per-replica
    base_caps: np.ndarray,  # int64[C, R] snapshot available capacity
    demanders: Sequence[str],  # keys of the rows to re-solve
    candidates: Mapping[str, np.ndarray],  # key -> bool[C] post-filter
    strategies: Mapping[str, int],
    replicas: Mapping[str, int],
    prev: Mapping[str, Mapping[str, int]],
    fresh: Optional[Mapping[str, bool]] = None,
) -> tuple[list[str], dict[str, dict[str, int]]]:
    """The whole scarcity wave, per binding: sequential victim selection,
    per-cluster freed-capacity accumulation, then a one-row numpy divide
    for each demander against availability recomputed over
    ``base_caps + freed``. Returns (victim keys, demander placements by
    key; an empty dict entry = still unschedulable)."""
    flags = select_victims_np(prios, demand, freed, victim_ok, weights)
    col = {nm: j for j, nm in enumerate(names)}
    c = len(names)
    r = np.asarray(base_caps).shape[1]
    freed_caps = np.zeros((c, r), np.int64)
    victim_keys = []
    for i, key in enumerate(keys):
        if not flags[i]:
            continue
        victim_keys.append(key)
        req = np.asarray(requests[key], np.int64)
        for nm, reps in assigned.get(key, {}).items():
            j = col.get(nm)
            if j is not None:
                freed_caps[j] += int(reps) * req
    boosted = np.asarray(base_caps, np.int64) + freed_caps
    out: dict[str, dict[str, int]] = {}
    for key in demanders:
        req = np.asarray(requests[key], np.int64)
        avail = np.full(c, MAX_INT32, np.int64)
        for d in range(r):
            if req[d] > 0:
                avail = np.minimum(
                    avail, np.maximum(boosted[:, d], 0) // req[d]
                )
        prev_row = np.zeros(c, np.int32)
        for nm, reps in prev.get(key, {}).items():
            j = col.get(nm)
            if j is not None:
                prev_row[j] = reps
        assignment, unsched = assign_batch_np(
            np.asarray([strategies[key]], np.int32),
            np.asarray([replicas[key]], np.int32),
            np.asarray(candidates[key], bool)[None, :],
            np.zeros((1, c), np.int32),
            np.minimum(avail, MAX_INT32).astype(np.int32)[None, :],
            prev_row[None, :],
            np.asarray([bool(fresh[key]) if fresh else False]),
        )
        if bool(unsched[0]):
            out[key] = {}
            continue
        out[key] = {
            names[j]: int(assignment[0, j])
            for j in np.flatnonzero(assignment[0] > 0)
        }
    return victim_keys, out


def rebalance_np(
    keys: Sequence[str],
    *,
    names: Sequence[str],
    current: Mapping[str, Mapping[str, int]],  # key -> resident placement
    candidates: Mapping[str, np.ndarray],
    strategies: Mapping[str, int],
    replicas: Mapping[str, int],
    avail: Mapping[str, np.ndarray],  # key -> int32[C] fresh availability
    budget: int,
) -> tuple[dict[str, int], list[str]]:
    """Continuous-descheduler oracle: per-binding fresh-solve ideal via
    the one-row numpy divider (fresh mode — surviving placements
    credited), drift = L1 replica distance from the resident placement,
    trigger set = top ``budget`` rows by (drift desc, arrival asc).
    Returns (drift by key, triggered keys)."""
    col = {nm: j for j, nm in enumerate(names)}
    c = len(names)
    drifts: dict[str, int] = {}
    for key in keys:
        prev_row = np.zeros(c, np.int32)
        for nm, reps in current.get(key, {}).items():
            j = col.get(nm)
            if j is not None:
                prev_row[j] = reps
        assignment, unsched = assign_batch_np(
            np.asarray([strategies[key]], np.int32),
            np.asarray([replicas[key]], np.int32),
            np.asarray(candidates[key], bool)[None, :],
            np.zeros((1, c), np.int32),
            np.asarray(avail[key], np.int32)[None, :],
            prev_row[None, :],
            np.asarray([True]),  # fresh: the rebalance semantics
        )
        if bool(unsched[0]):
            drifts[key] = 0  # nowhere better to go: no drift trigger
            continue
        drifts[key] = int(np.abs(assignment[0] - prev_row).sum())
    arrival: dict[str, int] = {}
    for i, k in enumerate(keys):
        arrival.setdefault(k, i)
    ranked = sorted(
        (k for k in keys if drifts.get(k, 0) > 0),
        key=lambda k: (-drifts[k], arrival[k]),
    )
    return drifts, ranked[: max(int(budget), 0)]
