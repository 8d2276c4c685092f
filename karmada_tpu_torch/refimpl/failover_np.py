"""Numpy failover oracle: ordered ClusterAffinities rescheduling replayed
per binding.

The port's copy of ``karmada_tpu/refimpl/failover_np.py``, a referent for
the tests and ``chip_smoke.py``; nothing on the engine's path calls it. The
engine's tensorized path (``ops.masks.first_fit_group`` + one batched
solve in ``TensorScheduler._schedule_chunk_ranked``) claims that selecting
each displaced binding's first FITTING affinity group vectorized and then
solving once is placement-identical to the reference's control flow —
"try group 0, reschedule, on failure try group 1, ..."
(scheduler.go:533-596). This module IS that control flow: a plain Python
loop per binding over its fallback groups, each attempt dividing through
``refimpl.divider_np.assign_batch_np`` on a single row. No shared
selection code with the engine path — the predicate here is "run the
divider and look at its unschedulable flag", so a drift in the engine's
vectorized fit predicate shows up as an oracle mismatch, not a shared bug.

``replay_failover`` additionally consumes a fault-event log
(utils.faultinject ``FaultEvent``/dict rows): killed clusters are evicted
from every binding's previous placements exactly as the taint-manager ->
``evict_binding`` path does (spec.clusters drops the cluster, the
graceful-eviction task masks it via ClusterEviction), so a chaos run's
final placements can be verified from (seeded event log, pre-kill
placements, post-kill capacity snapshot) alone.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .divider_np import assign_batch_np


def solve_one_ordered(
    term_masks: np.ndarray,  # bool[T, C] ordered affinity-group masks
    base_feasible: np.ndarray,  # bool[C] every non-affinity filter composed
    strategy: int,
    replicas: int,
    static_w: np.ndarray,  # int32[C]
    avail: np.ndarray,  # int32[C] merged estimator availability
    prev: np.ndarray,  # int32[C]
    fresh: bool,
) -> tuple[Optional[np.ndarray], int, str]:
    """One binding through the reference's ordered-group retry loop.
    Returns (assignment int32[C] | None, selected term index, error)."""
    t = term_masks.shape[0]
    last_err = "no affinity group fits"
    for ti in range(t):
        cand = term_masks[ti] & base_feasible
        if not cand.any():
            last_err = "no clusters fit the placement"
            continue
        out, unsched = assign_batch_np(
            np.asarray([strategy], np.int32),
            np.asarray([replicas], np.int32),
            cand[None, :],
            np.asarray(static_w, np.int32)[None, :],
            np.asarray(avail, np.int32)[None, :],
            np.asarray(prev, np.int32)[None, :],
            np.asarray([fresh], bool),
        )
        if bool(unsched[0]):
            last_err = "clusters available replicas are not enough"
            continue
        return out[0], ti, ""
    return None, t - 1, last_err


def replay_failover(
    events: Sequence,  # faultinject FaultEvent / dict rows (cluster kills)
    names: Sequence[str],  # snapshot cluster order (columns)
    placements: Mapping[str, Mapping[str, int]],  # key -> pre-kill clusters
    term_masks: Mapping[str, np.ndarray],  # key -> bool[T, C]
    base_feasible: Mapping[str, np.ndarray],  # key -> bool[C], pre-eviction
    strategies: Mapping[str, int],
    replicas: Mapping[str, int],
    static_w: Mapping[str, np.ndarray],
    avail: Mapping[str, np.ndarray],  # key -> int32[C] at solve time
) -> dict[str, dict[str, int]]:
    """Replay a chaos run's cluster-kill events over pre-kill placements
    and return the expected stable placements, binding by binding.

    Eviction semantics mirror controllers/cluster.py ``evict_binding`` +
    the engine's ClusterEviction filter: a killed cluster leaves
    spec.clusters (prev) AND the candidate set; surviving replicas stay
    credited via prev, and the binding reschedules NON-fresh (scale-up
    cohort: the shortfall tops up from the fallback groups, existing rows
    keep their placements — GracefulEviction's replacement-first shape).
    """
    killed = set()
    for ev in events:
        point = getattr(ev, "point", None) or ev.get("point")
        action = getattr(ev, "action", None) or ev.get("action")
        key = getattr(ev, "key", None) or ev.get("key")
        if point == "cluster.health" and action == "down":
            killed.add(key)
    col = {n: i for i, n in enumerate(names)}
    dead_cols = [col[k] for k in killed if k in col]
    out: dict[str, dict[str, int]] = {}
    for key, placed in placements.items():
        prev_row = np.zeros(len(names), np.int32)
        for n, r in placed.items():
            if n in col and n not in killed:
                prev_row[col[n]] = r
        base = np.asarray(base_feasible[key], bool).copy()
        if dead_cols:
            base[dead_cols] = False  # NoExecute eviction mask
        assignment, _ti, err = solve_one_ordered(
            np.asarray(term_masks[key], bool),
            base,
            int(strategies[key]),
            int(replicas[key]),
            np.asarray(static_w[key], np.int32),
            np.asarray(avail[key], np.int32),
            prev_row,
            fresh=False,
        )
        if assignment is None:
            out[key] = dict(placed)  # unschedulable: placement unchanged
            continue
        out[key] = {
            names[j]: int(assignment[j])
            for j in np.flatnonzero(assignment > 0)
        }
    return out
