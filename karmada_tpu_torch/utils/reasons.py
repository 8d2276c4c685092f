"""Reason codes of the scheduling pipeline: the port's copy of the part of
``karmada_tpu/utils/reasons.py`` the engine and the scheduler process emit.

The decision stages are listed in exclusion-bit order (``STAGE_REASONS[i]``
is bit ``i`` of the explain plane's per-cluster mask), then the
``Scheduled`` condition codes and the descheduler's event code, and
``classify_error`` maps an engine ``ScheduleResult.error`` onto them. The
quota plane takes its ``QuotaExceeded`` code from here; ``TransitionDedup``
gates the scheduler process's per-transition counters.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Reason:
    """One registered reason code; ``stage_bit`` is the exclusion-mask bit
    of a ``kind="stage"`` reason (None otherwise)."""

    code: str
    #: "stage" | "condition" | "event"
    kind: str
    description: str
    stage_bit: Optional[int] = None


#: the decision-stage order; the index is the exclusion-mask bit
STAGE_REASONS: tuple[str, ...] = (
    "AffinityMismatch",  # bit 0
    "TaintUntolerated",  # bit 1
    "ApiNotEnabled",  # bit 2
    "NoAvailableReplicas",  # bit 3
    "QuotaCapExceeded",  # bit 4
    "QuotaExceeded",  # bit 5
    "SpreadConstraintUnsatisfied",  # bit 6
    "PreemptedByHigherPriority",  # bit 7
)

_STAGE_TEXT = {
    "AffinityMismatch": "cluster is outside the binding's selected "
                        "ClusterAffinities group",
    "TaintUntolerated": "cluster carries an untolerated NoSchedule/NoExecute "
                        "taint or an active graceful-eviction task",
    "ApiNotEnabled": "cluster does not enable the workload's API/GVK",
    "NoAvailableReplicas": "merged estimator availability is zero for this "
                           "cluster",
    "QuotaCapExceeded": "a FederatedResourceQuota static-assignment hard cap "
                        "answers zero replicas for this cluster",
    "QuotaExceeded": "binding denied by batched FIFO quota admission — also "
                     "the Scheduled=False condition code",
    "SpreadConstraintUnsatisfied": "cluster dropped by spread-constraint "
                                   "group selection",
    "PreemptedByHigherPriority": "the binding holds a preemption "
                                 "graceful-eviction task from this cluster",
}

REASONS: dict[str, Reason] = {
    r.code: r
    for r in (
        *(Reason(code, "stage", _STAGE_TEXT[code], bit)
          for bit, code in enumerate(STAGE_REASONS)),
        Reason("Success", "condition", "binding scheduled successfully"),
        Reason("NoClusterFit", "condition",
               "no cluster survives the filter stages for any affinity group"),
        Reason("InsufficientReplicas", "condition",
               "candidate clusters' summed availability cannot cover the "
               "requested replicas"),
        Reason("NoAffinityGroupFits", "condition",
               "every ordered ClusterAffinities fallback group was tried and "
               "none schedules"),
        Reason("Unschedulable", "condition",
               "binding not scheduled for an unclassified engine reason"),
        Reason("RebalanceTriggered", "event",
               "continuous-descheduler drift re-placement: the binding's "
               "resident placement scored worse than a fresh solve and a "
               "RescheduleTriggeredAt was stamped within the disruption "
               "budget — also a karmada_tpu_preemptions_total reason label"),
    )
}

#: engine error texts -> reason codes
_ERROR_REASONS: tuple[tuple[str, str], ...] = (
    ("namespace quota exceeded", "QuotaExceeded"),
    ("no clusters fit the placement", "NoClusterFit"),
    ("clusters available replicas are not enough", "InsufficientReplicas"),
    ("no affinity group fits", "NoAffinityGroupFits"),
)


def classify_error(error: str) -> str:
    """Reason code for an engine ``ScheduleResult.error`` ("" answers
    ``Success``; unknown text answers ``Unschedulable``)."""
    if not error:
        return "Success"
    for needle, code in _ERROR_REASONS:
        if needle in error:
            return code
    return "Unschedulable"


class TransitionDedup:
    """Once-per-transition counter gate.

    ``observe(key, reason, generation)`` answers True exactly when the
    (reason, generation) pair differs from the last observation for
    ``key`` — so a parked binding re-enqueued across passes within one
    generation can never double-increment ``quota_denied_total`` /
    ``unschedulable_total``, while a NEW generation (quota moved, spec
    changed) counts again. Bounded by ``cap`` (full = wholesale reset —
    counters over-count once rather than grow without bound)."""

    def __init__(self, cap: int = 1 << 20):
        self.cap = cap
        self._lock = threading.Lock()
        self._last: dict = {}

    def observe(self, key, reason: str, generation=None) -> bool:
        state = (reason, generation)
        with self._lock:
            if self._last.get(key) == state:
                return False
            if len(self._last) >= self.cap and key not in self._last:
                self._last.clear()
            self._last[key] = state
            return True

    def forget(self, key) -> None:
        with self._lock:
            self._last.pop(key, None)
