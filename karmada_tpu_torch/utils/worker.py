"""Reconcile runtime: work queues + a deterministic cooperative loop.

The port's own copy of ``karmada_tpu/utils/worker.py``. Ref:
pkg/util/worker.go:33-140 (util.AsyncWorker — workqueue + reconcile loop).
The same enqueue/reconcile contract, driven cooperatively by
``Runtime.run_until_settled`` so the plane runs in-process without sleeping
threads, and the same two requeue disciplines: immediate (the default) and
wall-clock backoff (``runtime.realtime``, which the serve processes set).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import time
from typing import Callable, Hashable, Optional

log = logging.getLogger("karmada_tpu_torch")

# Reconcile results
DONE = "done"
REQUEUE = "requeue"


class Worker:
    """A named reconcile queue. ``reconcile(key)`` returns DONE or REQUEUE
    (or raises — treated as REQUEUE with backoff count).

    Two requeue disciplines (pkg/util/worker.go wraps a rate-limiting
    workqueue — DefaultControllerRateLimiter: per-item exponential backoff
    5ms..1000s):

    - cooperative (default): REQUEUE re-enqueues immediately and drops the
      key after MAX_RETRIES — deterministic, for ``run_until_settled``
      drivers where wall-clock delays would just burn the step budget.
    - wall-clock (``runtime.realtime = True``, the serve deployments):
      REQUEUE parks the key for ``backoff_base * 2^(retries-1)`` seconds
      (capped at ``backoff_max``) and retries indefinitely — a persistently
      failing key costs one reconcile per backoff window instead of 16
      hot-loop attempts followed by a permanent drop.

    Ownership sharding: keys route to per-ownership-token queues drained
    round-robin (the detector and binding workers shard by namespace; by
    default every key has one token, and the worker drains in enqueue
    order), and a batch drain holds keys of one token only — so one
    namespace's storm never head-of-line-blocks another's drain, and each
    batched write set stays within one ownership domain."""

    MAX_RETRIES = 16

    def __init__(
        self,
        name: str,
        reconcile: Callable[[Hashable], Optional[str]],
        *,
        reconcile_batch: Optional[
            Callable[[list[Hashable]], dict[Hashable, Optional[str]]]
        ] = None,
        batch_size: int = 1024,
        runtime: Optional["Runtime"] = None,
        backoff_base: float = 0.005,
        backoff_max: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
        shard_fn: Callable[[Hashable], Hashable] = lambda key: None,
    ):
        self.name = name
        self.reconcile = reconcile
        # optional vectorized drain: given up to batch_size queued keys,
        # returns per-key results (missing keys count as DONE). Lets batch
        # engines (the tensor scheduler) amortize one pass over every
        # queued item instead of paying per-key packing/dispatch.
        self.reconcile_batch = reconcile_batch
        self.batch_size = batch_size
        self.runtime = runtime
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.clock = clock
        # key -> ownership token; tokens materialize shard queues lazily
        self.shard_fn = shard_fn
        self._shards: dict[Hashable, collections.deque] = {}
        self._shard_rr: collections.deque = collections.deque()
        self._queued: set[Hashable] = set()
        self._retries: collections.Counter = collections.Counter()
        self._delayed: list[tuple] = []  # (not_before, seq, key) heap
        #: live parked entry per key: key -> (not_before, seq). Heap entries
        #: not matching this map are stale and skipped on promote
        #: (client-go's delaying queue keeps ONE ready-time per item — the
        #: earliest)
        self._parked: dict[Hashable, tuple] = {}
        self._seq = itertools.count()

    def enqueue(self, key: Hashable) -> None:
        # a direct enqueue supersedes any parked retry of the same key
        self._parked.pop(key, None)
        if key in self._queued:
            return
        self._queued.add(key)
        token = self.shard_fn(key)
        q = self._shards.get(token)
        if q is None:
            q = self._shards[token] = collections.deque()
            self._shard_rr.append(token)
        q.append(key)

    def _pop_batch(self, limit: int) -> list:
        """Pop up to ``limit`` queued keys of ONE ownership token
        (round-robin across tokens), so a batch never mixes ownership
        domains."""
        keys: list = []
        while self._shard_rr and not keys:
            token = self._shard_rr.popleft()
            q = self._shards.get(token)
            if not q:
                self._shards.pop(token, None)
                continue
            while q and len(keys) < limit:
                k = q.popleft()
                self._queued.discard(k)
                keys.append(k)
            if q:
                self._shard_rr.append(token)  # remainder: back of rotation
            else:
                self._shards.pop(token, None)
        return keys

    def enqueue_after(self, key: Hashable, delay: float) -> None:
        """Park ``key`` until ``delay`` seconds from now (workqueue
        AddAfter): the EARLIEST pending ready-time per key wins, and a
        direct enqueue while parked wins outright (retries sooner)."""
        due = self.clock() + delay
        live = self._parked.get(key)
        if live is not None and live[0] <= due:
            return
        entry = (due, next(self._seq), key)
        self._parked[key] = (due, entry[1])
        heapq.heappush(self._delayed, entry)

    def _promote_due(self) -> None:
        now = self.clock()
        while self._delayed and self._delayed[0][0] <= now:
            due, seq, key = heapq.heappop(self._delayed)
            if self._parked.get(key) != (due, seq):
                continue  # superseded by a direct enqueue or earlier park
            del self._parked[key]
            self.enqueue(key)

    def __len__(self) -> int:
        return len(self._queued)

    @property
    def delayed(self) -> int:
        """Keys parked in a backoff window (not yet due)."""
        return len(self._parked)

    def next_due(self) -> Optional[float]:
        """Seconds until the earliest parked key is due (<= 0 if due now),
        or None when nothing is parked."""
        while self._delayed and (
            self._parked.get(self._delayed[0][2])
            != (self._delayed[0][0], self._delayed[0][1])
        ):
            heapq.heappop(self._delayed)  # drop stale heads lazily
        if not self._delayed:
            return None
        return self._delayed[0][0] - self.clock()

    def process_one(self) -> bool:
        """Pop and reconcile one key (or one batch when a batch reconciler
        is installed and multiple keys are queued). Returns True if work was
        done."""
        if self._delayed:
            self._promote_due()
        if not self._queued:
            return False
        if self.reconcile_batch is not None and len(self._queued) > 1:
            keys = self._pop_batch(self.batch_size)
            results = self._drain_batch(keys)
            for k in keys:
                self._finish(k, results.get(k, DONE))
            return True
        key = self._pop_batch(1)[0]
        try:
            result = self.reconcile(key)
        except Exception:  # noqa: BLE001 — reconcile errors requeue, like workqueue
            log.exception("worker %s: reconcile %r failed", self.name, key)
            result = REQUEUE
        self._finish(key, result)
        return True

    #: poisoned keys tolerated per drain before the failure is treated as
    #: systemic (whole engine down, not bad keys); each poisoned key costs
    #: ~log2(batch) failing sub-batch calls down its bisect path
    POISON_TOLERANCE = 4

    def _drain_batch(self, keys: list[Hashable]) -> dict[Hashable, Optional[str]]:
        """Run reconcile_batch with poisoned-key isolation: a failing batch
        is bisected, so healthy halves stay batched and only genuinely
        failing keys pay a retry. A failure budget caps the fan-out when
        the failure is systemic (every sub-call failing)."""
        results: dict[Hashable, Optional[str]] = {}
        failures = 0
        budget = self.POISON_TOLERANCE * max(1, len(keys).bit_length())

        def run(ks: list[Hashable]) -> None:
            nonlocal failures
            if failures > budget:
                for k in ks:
                    results[k] = REQUEUE
                return
            try:
                if len(ks) == 1:
                    results[ks[0]] = self.reconcile(ks[0])
                else:
                    results.update(self.reconcile_batch(ks))
                return
            except Exception:  # noqa: BLE001
                failures += 1
                if failures == 1:
                    log.exception(
                        "worker %s: batch reconcile failed; bisecting", self.name
                    )
                else:
                    log.error(
                        "worker %s: reconcile of %d key(s) failed (failure %d)",
                        self.name, len(ks), failures,
                    )
                if len(ks) == 1:
                    results[ks[0]] = REQUEUE
                    return
            mid = len(ks) // 2
            run(ks[:mid])
            run(ks[mid:])

        run(keys)
        return results

    def _finish(self, key: Hashable, result: Optional[str]) -> None:
        if result == REQUEUE:
            self._retries[key] += 1
            if self.runtime is not None and self.runtime.realtime:
                # exponent is capped: retries grow without bound in
                # realtime mode and 2**1025 overflows float conversion
                delay = min(
                    self.backoff_base * (2 ** min(self._retries[key] - 1, 30)),
                    self.backoff_max,
                )
                self.enqueue_after(key, delay)
            elif self._retries[key] <= self.MAX_RETRIES:
                self.enqueue(key)
            else:
                log.error("worker %s: dropping %r after max retries", self.name, key)
                del self._retries[key]
        else:
            self._retries.pop(key, None)


class Runtime:
    """Holds all workers of a control plane and drives them cooperatively.

    ``run_until_settled`` round-robins workers until every queue is empty
    (i.e. the control plane reached a fixed point) or the step budget is hit.
    """

    def __init__(self) -> None:
        self.workers: list[Worker] = []
        self._tickers: list[Callable[[], None]] = []
        #: wall-clock mode (serve deployments): failing keys back off
        #: exponentially instead of hot-looping; see Worker._finish
        self.realtime = False
        #: set when a heartbeat answered False during the last drain
        self.deposed = False

    def new_worker(self, name: str, reconcile, **kw) -> Worker:
        w = Worker(name, reconcile, runtime=self, **kw)
        self.workers.append(w)
        return w

    def next_due(self) -> Optional[float]:
        """Seconds until the earliest backed-off key anywhere is due, or
        None — the serve loop's sleep bound."""
        dues = [d for w in self.workers if (d := w.next_due()) is not None]
        return min(dues) if dues else None

    def add_ticker(self, fn: Callable[[], None]) -> None:
        """Periodic function run at the start of each run_until_settled call
        (descheduler sweep, etc. — the analogue of wait.Until loops)."""
        self._tickers.append(fn)

    def tick(self) -> None:
        for fn in self._tickers:
            fn()

    def pending(self) -> int:
        return sum(len(w) for w in self.workers)

    # called every HEARTBEAT_EVERY drained items mid-settle (None = off).
    # Returning False aborts the drain with work still queued — the seam a
    # leader-elected plane uses to renew its lease during a storm settle and
    # to stop reconciling the moment it is deposed
    heartbeat = None
    HEARTBEAT_EVERY = 256

    def beat(self) -> bool:
        """Ask the heartbeat (True when there is none). A False answer marks
        the runtime deposed: the current drain stops after the item that
        asked, and ``ControlPlane.settle`` runs no further drain. The
        scheduler's lease write barrier asks here after each engine pass, so
        a deposed plane neither writes that pass nor runs it again."""
        if self.heartbeat is None:
            return True
        if self.heartbeat() is False:
            self.deposed = True
            return False
        self.deposed = False
        return True

    def run_until_settled(self, max_steps: int = 100_000, *, tick: bool = True) -> int:
        """Process queued work until quiescent. Returns steps executed.

        Tickers run once at the start (not per pass — a ticker that always
        enqueues would never settle). ``heartbeat`` (if set) is invoked
        every HEARTBEAT_EVERY items; a False return aborts the drain
        (remaining keys stay queued for the next call).

        Wave tracing: a settle with queued work is one wave — a ``settle``
        root span wraps the drain, with one ``controller.<worker>`` child
        span per contiguous worker drain (not per key), and the wave closes
        at quiescence. Per-worker drain counts feed the
        karmada_tpu_worker_* metric families once per drain."""
        if tick:
            self.tick()
        if self.pending() == 0:
            due = self.next_due()
            if due is None or due > 0:
                return 0  # quiescent (no queued keys, no due-parked keys)
        from .metrics import settle_seconds, worker_queue_depth, worker_reconciles
        from .tracing import tracer

        tracer.ensure_wave("settle")
        steps = 0
        next_beat = self.HEARTBEAT_EVERY
        self.deposed = aborted = False
        with tracer.span("settle") as root:
            while steps < max_steps and not aborted:
                progressed = False
                for w in self.workers:
                    drained = 0
                    # an idle poll discards the span so quiescent workers
                    # leave no trace
                    with tracer.span(f"controller.{w.name}") as sp:
                        while (
                            steps < max_steps
                            and not aborted
                            and w.process_one()
                        ):
                            steps += 1
                            drained += 1
                            if self.deposed:
                                aborted = True  # a barrier's beat said so
                            elif (
                                self.heartbeat is not None
                                and steps >= next_beat
                            ):
                                next_beat = steps + self.HEARTBEAT_EVERY
                                aborted = not self.beat()
                        sp.attrs["items"] = drained
                        if not drained:
                            sp.attrs["_discard"] = True
                    if not drained:
                        continue
                    progressed = True
                    worker_reconciles.inc(drained, worker=w.name)
                    worker_queue_depth.set(len(w), worker=w.name)
                    if aborted or steps >= max_steps:
                        break
                if not progressed:
                    break
            root.attrs["steps"] = steps
        settle_seconds.observe(root.duration)
        if self.pending() == 0:
            tracer.end_wave()
        return steps
