"""Observability: counters, gauges and histograms with a Prometheus registry.

The port's own copy of the metric types of ``karmada_tpu/utils/metrics.py``
and of the families the scheduler process, the propagation path, the FRQ
status controller, the estimator and solver channels (their servers, the
registry's wire traffic), the store bus (``bus_*``: fan-out, subscribers,
queue depth and age, batch sizes) and the unified channel resilience
(``utils.backoff``) move. Ref:
pkg/scheduler/metrics/metrics.go:61-115 (schedule_attempts_total,
e2e_scheduling_duration_seconds) and pkg/metrics (controller metrics). Text
exposition follows the Prometheus format (``Registry.render``). The JAX
module's ``/metrics`` server and the families of the planes the port does
not carry yet are not part of this copy.

Thread-safety: ``inc()``/``set()``/``observe()`` mutate under the
per-metric lock, and every read path snapshots the sample dicts under that
same lock before iterating.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Iterable, Optional

_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)

#: end-to-end bucket set for whole-wave / settle-pass latencies: a storm's
#: settle pass runs seconds and a cold wave can run minutes, past the
#: default buckets' +Inf. Scrapers still get sub-second resolution at the
#: fast end.
E2E_BUCKETS = (
    0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 15.0, 30.0, 60.0,
    120.0, 300.0,
)


def _label_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped inside the quoted label value."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(key: tuple) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)


def _help_line(name: str, help_: str) -> str:
    # HELP text escaping: backslash and newline (the text format's rules
    # for HELP differ from label values — no quote escaping)
    escaped = help_.replace("\\", "\\\\").replace("\n", "\\n")
    return f"# HELP {name} {escaped}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] += amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> dict[tuple, float]:
        """Label-set -> value snapshot."""
        with self._lock:
            return dict(self._values)

    def render(self) -> Iterable[str]:
        if self.help:
            yield _help_line(self.name, self.help)
        yield f"# TYPE {self.name} counter"
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            label_s = _label_str(key)
            yield f"{self.name}{{{label_s}}} {v}" if label_s else f"{self.name} {v}"


class Gauge:
    """A settable sample (queue depth, subscriber count). Same lock
    contract as Counter: set/add mutate and every read snapshots under the
    lock."""

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> dict[tuple, float]:
        """Label-set -> value snapshot."""
        with self._lock:
            return dict(self._values)

    def remove_matching(self, **labels) -> None:
        """Drop every sample whose label set CONTAINS these pairs — the
        cleanup hook for gauges keyed by a deleted object (e.g. a removed
        FederatedResourceQuota's per-resource limit/used samples)."""
        match = set(labels.items())
        with self._lock:
            for key in [k for k in self._values if match <= set(k)]:
                del self._values[key]

    def render(self) -> Iterable[str]:
        if self.help:
            yield _help_line(self.name, self.help)
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            label_s = _label_str(key)
            yield f"{self.name}{{{label_s}}} {v}" if label_s else f"{self.name} {v}"


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def summary(self, **labels) -> Optional[dict]:
        key = _label_key(labels)
        with self._lock:
            if key not in self._totals:
                return None
            total = self._totals[key]
            s = self._sums[key]
        return {"count": total, "sum": s, "avg": s / max(total, 1)}

    def render(self) -> Iterable[str]:
        if self.help:
            yield _help_line(self.name, self.help)
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            # consistent snapshot of all three sample dicts: counts lists
            # are copied so a concurrent observe cannot mutate a row
            # mid-render (the totals/sums pair for a key stays coherent
            # because both are written under this same lock)
            keys = sorted(self._totals)
            counts_snap = {k: list(self._counts[k]) for k in keys}
            sums_snap = {k: self._sums[k] for k in keys}
            totals_snap = {k: self._totals[k] for k in keys}
        for key in keys:
            label_s = _label_str(key)
            prefix = f"{self.name}_bucket{{{label_s}" if label_s else f"{self.name}_bucket{{"
            counts = counts_snap[key]  # already cumulative (observe adds to
            # every bucket whose bound covers the value)
            sep = "," if label_s else ""
            for i, bound in enumerate(self.buckets):
                yield f'{prefix}{sep}le="{bound}"}} {counts[i]}'
            yield f'{prefix}{sep}le="+Inf"}} {totals_snap[key]}'
            base = f"{self.name}_sum{{{label_s}}}" if label_s else f"{self.name}_sum"
            yield f"{base} {sums_snap[key]}"
            base = f"{self.name}_count{{{label_s}}}" if label_s else f"{self.name}_count"
            yield f"{base} {totals_snap[key]}"


class Registry:
    def __init__(self) -> None:
        self._metrics: list = []

    def counter(self, name: str, help_: str = "") -> Counter:
        c = Counter(name, help_)
        self._metrics.append(c)
        return c

    def gauge(self, name: str, help_: str = "") -> Gauge:
        g = Gauge(name, help_)
        self._metrics.append(g)
        return g

    def histogram(self, name: str, help_: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        h = Histogram(name, help_, buckets)
        self._metrics.append(h)
        return h

    def render(self) -> str:
        lines: list[str] = []
        for m in self._metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# the global registry and the families of the scheduler process and the
# propagation path
registry = Registry()

schedule_attempts = registry.counter(
    "karmada_scheduler_schedule_attempts_total",
    "scheduling attempts by result and type",
)
e2e_scheduling_duration = registry.histogram(
    "karmada_scheduler_e2e_scheduling_duration_seconds",
    "end-to-end schedule latency",
    buckets=E2E_BUCKETS,
)
scheduler_pass_seconds = registry.histogram(
    "karmada_tpu_scheduler_pass_seconds",
    "one engine pass over a queued binding batch (batched drain of the "
    "scheduler worker)",
    buckets=E2E_BUCKETS,
)
settle_seconds = registry.histogram(
    "karmada_tpu_settle_seconds",
    "one run_until_settled drain of the whole controller fleet (a storm "
    "wave is one settle)",
    buckets=E2E_BUCKETS,
)
works_rendered = registry.counter(
    "karmada_tpu_controller_works_rendered_total",
    "Work objects created or updated by the binding controller (the "
    "work-render throughput of a propagation wave)",
)
worker_reconciles = registry.counter(
    "karmada_tpu_worker_reconciles_total",
    "reconciles drained, by worker queue",
)
worker_queue_depth = registry.gauge(
    "karmada_tpu_worker_queue_depth",
    "keys still queued per worker after its last drain",
)
unschedulable_total = registry.counter(
    "karmada_tpu_unschedulable_total",
    "bindings transitioning to Scheduled=False, by REASONS-taxonomy "
    "code (QuotaExceeded, NoClusterFit, InsufficientReplicas, ...) — "
    "one increment per (binding, reason, generation) transition; a "
    "parked binding re-enqueued within one generation never "
    "double-counts (utils.reasons.TransitionDedup)",
)
preemptions_total = registry.counter(
    "karmada_tpu_preemptions_total",
    "bindings displaced by the scarcity plane, by REASONS-taxonomy code "
    "(PreemptedByHigherPriority = victim of the batched preemption "
    "kernel, RebalanceTriggered = continuous-descheduler drift "
    "re-placement) — one increment per (binding, reason, generation) "
    "transition via utils.reasons.TransitionDedup",
)
desched_disruption_budget = registry.gauge(
    "karmada_tpu_desched_disruption_budget",
    "the continuous descheduler's per-round disruption budget "
    "(KARMADA_TPU_DESCHEDULE_MAX_DISRUPTION): the maximum bindings one "
    "drift-rebalance round may stamp RescheduleTriggeredAt on; 0 = tier "
    "disabled",
)
desched_disruption_used = registry.gauge(
    "karmada_tpu_desched_disruption_used",
    "bindings the LAST drift-rebalance round actually re-placed (always "
    "<= the published budget)",
)
quota_denied = registry.counter(
    "karmada_tpu_quota_denied_total",
    "bindings newly denied admission by FederatedResourceQuota "
    "enforcement, by namespace (incremented when the QuotaExceeded "
    "condition lands on the binding; a denied binding retries on the "
    "next quota generation, not every pass)",
)
quota_limit = registry.gauge(
    "karmada_tpu_quota_limit",
    "FederatedResourceQuota spec.overall limit by namespace and resource "
    "(canonical integer units; set by the FRQ status controller)",
)
quota_used = registry.gauge(
    "karmada_tpu_quota_used",
    "FederatedResourceQuota status.overall_used by namespace and "
    "resource, recomputed live from bound ResourceBindings",
)
estimator_rpcs = registry.counter(
    "karmada_tpu_estimator_rpcs_total",
    "scheduler-side estimator wire traffic by kind (batch matrix RPCs, "
    "per-profile unary fallback calls, generation pings)",
)
estimator_delta_requeries = registry.counter(
    "karmada_tpu_estimator_delta_requery_total",
    "clusters whose availability was re-fetched after a generation "
    "movement (the delta half of the generation-gated refresh)",
)
estimator_refresh_seconds = registry.histogram(
    "karmada_tpu_estimator_refresh_seconds",
    "wall time of one registry refresh (pings + grouped fan-out)",
)
estimator_server_requests = registry.counter(
    "karmada_tpu_estimator_server_requests_total",
    "estimator-server RPCs served, by method",
)
solver_requests = registry.counter(
    "karmada_tpu_solver_requests_total",
    "solver-sidecar RPCs served, by method",
)
circuit_state = registry.gauge(
    "karmada_tpu_circuit_state",
    "per-channel circuit-breaker state (0 closed, 1 open, 2 half-open) — "
    "the unified resilience policy of utils.backoff; an open estimator or "
    "solver breaker marks every pass it shadows as degraded",
)
channel_retries = registry.counter(
    "karmada_tpu_channel_retries_total",
    "RPC attempts retried under the unified backoff policy, by channel "
    "(each is one decorrelated-jitter sleep inside one deadline budget)",
)
degraded_passes = registry.counter(
    "karmada_tpu_degraded_passes_total",
    "passes served on a channel's degraded path, by channel: solver = "
    "in-proc fallback solve, estimator = at least one registered cluster "
    "answered UnauthenticReplica (such a pass never arms batch-identity "
    "replay)",
)
bus_events = registry.counter(
    "karmada_tpu_bus_events_total",
    "store-bus watch events fanned out to subscribers (dropped = a slow "
    "subscriber's stream was closed for re-list)",
)
bus_subscribers = registry.gauge(
    "karmada_tpu_bus_subscribers",
    "live store-bus watch subscribers",
)
bus_queue_depth = registry.gauge(
    "karmada_tpu_bus_queue_depth",
    "deepest subscriber queue at the last fan-out (backpressure signal)",
)
bus_event_age_seconds = registry.histogram(
    "karmada_tpu_bus_event_age_seconds",
    "time a watch event waited in a subscriber queue before the stream "
    "picked it up (recorded PER EVENT even under frame coalescing, so "
    "batching cannot fake a low queue age)",
)
bus_batch_size = registry.histogram(
    "karmada_tpu_bus_batch_size",
    "items per batched bus message: ops per ApplyBatch RPC served and "
    "events per WatchBatch frame flushed (count histogram — a value of "
    "1 means the channel is effectively unary)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
)
