"""Continuous descheduler: drift detection + bounded-disruption
re-placement.

The port's own copy of ``karmada_tpu/controllers/rebalance.py``. Ref: the
reference's workload rebalancer is ONE-SHOT — an operator creates a
WorkloadRebalancer naming workloads and the controller stamps
``RescheduleTriggeredAt`` once (workloadrebalancer_controller.go). The
descheduler (descheduler.go:141-241) reclaims unschedulable replicas but
never re-optimizes placements that merely drifted from what a fresh solve
would choose. This tier folds both into a background loop: every round
scores EVERY resident placement against current availability/spread/caps by
running one batched DRY solve through the scheduler's own engine (the same
device-resident tables, batch-identity caches and quota admission as a real
wave, so a drift score can never recommend a placement the real solve would
not produce), then re-places the worst-drifted bindings through the standard
``RescheduleTriggeredAt`` machinery, bounded by
``KARMADA_TPU_DESCHEDULE_MAX_DISRUPTION`` per round.

Drift of one binding = the L1 replica distance between its resident
``spec.clusters`` and the fresh-solve ideal. Rounds are bounded-disruption by
construction: at most ``budget`` bindings are stamped, highest drift first
with arrival order breaking ties, and a binding whose previous trigger is
still unconsumed (``reschedule_triggered_at`` newer than
``last_scheduled_time``) is never re-stamped — the trigger is exactly-once
per drift episode. The numpy oracle (``refimpl.preempt_np.rebalance_np``)
re-derives the trigger set with per-binding divides sharing no selection
code.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from ..utils import Store

#: disruption budget env knob
BUDGET_ENV = "KARMADA_TPU_DESCHEDULE_MAX_DISRUPTION"
_DEFAULT_BUDGET = 64


def disruption_budget() -> int:
    """The per-round trigger cap; 0 disables the tier entirely."""
    raw = os.environ.get(BUDGET_ENV, "").strip()
    if not raw:
        return _DEFAULT_BUDGET
    try:
        return max(int(raw), 0)
    except ValueError:
        return _DEFAULT_BUDGET


class ContinuousDescheduler:
    """Background drift detector over the whole binding plane.

    Constructed with the SchedulerController so scoring rides its
    engine (``dry_solve``) — the device-resident packed state, quota
    snapshot and caches are shared, never duplicated."""

    def __init__(
        self,
        store: Store,
        runtime,
        scheduler,
        clock=None,
    ) -> None:
        self.store = store
        self.scheduler = scheduler
        self.clock = clock or time.time
        #: on/off switch — ticker registration is permanent, so disable
        #: gates the TICKER path; explicit rebalance_once() calls always
        #: run (callers run rounds by hand with the ticker off)
        self.active = True
        #: stats of the last round
        self.last_round: dict = {}
        runtime.add_ticker(self._tick)

    def _tick(self) -> None:
        if self.active:
            self.rebalance_once()

    def _candidates(self):
        """(kind, rb, problem) for every bound binding eligible for a
        drift score: assigned replicas, a real workload, no in-flight
        eviction, and no still-unconsumed reschedule trigger (the
        exactly-once rule)."""
        out = []
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            for rb in self.store.list(kind):
                if (
                    rb.spec.scheduler_name != self.scheduler.scheduler_name
                    or rb.spec.replicas <= 0
                    or not rb.spec.clusters
                    or rb.spec.graceful_eviction_tasks
                ):
                    continue
                if rb.spec.reschedule_triggered_at is not None and (
                    rb.status.last_scheduled_time is None
                    or rb.spec.reschedule_triggered_at
                    > rb.status.last_scheduled_time
                ):
                    continue  # previous trigger not consumed yet
                key = rb.meta.namespaced_name
                problem = self.scheduler._problem_for(key, rb, True)
                out.append((kind, rb, problem))
        return out

    def rebalance_once(self) -> Optional[dict]:
        """One bounded-disruption drift round. Returns the round stats
        (also kept as ``last_round``) or None when disabled/empty."""
        budget = disruption_budget()
        from ..utils.metrics import (
            desched_disruption_budget,
            desched_disruption_used,
        )

        desched_disruption_budget.set(budget)
        if budget <= 0:
            return None
        cands = self._candidates()
        if not cands:
            desched_disruption_used.set(0)
            return None
        results = self.scheduler.dry_solve([p for _, _, p in cands])
        drifts = []  # (drift, arrival index, kind, rb)
        for idx, ((kind, rb, problem), res) in enumerate(
            zip(cands, results)
        ):
            if not res.success:
                continue  # nowhere better to go: no drift trigger
            current = {tc.name: tc.replicas for tc in rb.spec.clusters}
            moved = 0
            for name in set(current) | set(res.clusters):
                moved += abs(
                    int(res.clusters.get(name, 0))
                    - int(current.get(name, 0))
                )
            if moved > 0:
                drifts.append((moved, idx, kind, rb))
        drifts.sort(key=lambda t: (-t[0], t[1]))
        triggered = drifts[:budget]
        if not triggered:
            desched_disruption_used.set(0)
            stats = {
                "scored": len(cands),
                "drifted": len(drifts),
                "budget": budget,
                "triggered": [],
            }
            self.last_round = stats
            return stats
        now = self.clock()
        changed = []
        prior_by_id = {}
        for _moved, _idx, _kind, rb in triggered:
            prior_by_id[id(rb)] = rb.spec.reschedule_triggered_at
            rb.spec.reschedule_triggered_at = now
            rb.meta.generation += 1
            changed.append(rb)
        rejected_ids: set = set()
        for rb, err in self.store.apply_many(changed):
            # rejected stamp: roll back so the next round retries (the
            # prior consumed trigger is restored, not zeroed)
            rb.meta.generation -= 1
            rb.spec.reschedule_triggered_at = prior_by_id[id(rb)]
            rejected_ids.add(id(rb))
            print(
                f"# descheduler: trigger rejected for "
                f"{rb.meta.namespaced_name}: {err}",
                flush=True,
            )
        # stats/gauges/counters report what COMMITTED: a rejected stamp
        # was rolled back and never disrupted anything
        committed = [rb for rb in changed if id(rb) not in rejected_ids]
        desched_disruption_used.set(len(committed))
        from ..utils.metrics import preemptions_total
        from ..utils.reasons import REASONS

        reason = REASONS["RebalanceTriggered"].code
        for rb in committed:
            # once per trigger episode: the stamp itself is exactly-once
            # (unconsumed triggers are filtered above), so the counter
            # dedups on the binding's NEW generation — a re-listed
            # binding in the same episode never double-counts
            if self.scheduler._reason_dedup.observe(
                ("rebalance", rb.meta.namespaced_name),
                reason,
                rb.meta.generation,
            ):
                preemptions_total.inc(reason=reason)
        stats = {
            "scored": len(cands),
            "drifted": len(drifts),
            "budget": budget,
            "triggered": [rb.meta.namespaced_name for rb in committed],
        }
        self.last_round = stats
        return stats
