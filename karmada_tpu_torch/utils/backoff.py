"""Unified channel resilience: one retry/deadline/breaker policy for every
RPC channel. The port's own copy of ``karmada_tpu/utils/backoff.py``.

Each channel shares:

- ``Deadline`` — ONE overall budget threaded through a multi-step call
  (score -> re-sync -> retry pays one budget, not three stacked timeouts).
- ``BackoffPolicy`` — decorrelated-jitter sleeps (AWS architecture-blog
  form: ``sleep = min(cap, uniform(base, prev * 3))``), seeded per policy
  so chaos runs replay deterministically.
- ``CircuitBreaker`` — the closed/open/half-open machine per channel, with
  ``karmada_tpu_circuit_state`` / ``karmada_tpu_channel_retries_total``
  metrics and a breaker-transition span in the wave trace so a degraded
  pass is attributable after the fact. Half-open admits ONE probe; its
  success closes the breaker without operator action.
- ``call_with_resilience`` — the retry loop composing all three.

Degraded-mode rules (who falls back to what) stay with the channel owners:
a broken estimator channel answers UnauthenticReplica and never arms the
batch-identity replay (estimator/accurate.py), and a broken solver sidecar
fails over to the in-process engine (controllers/scheduler_controller.py).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

# env knobs of the unified policy (utils.flags ENV_FLAGS)
BACKOFF_BASE_ENV = "KARMADA_TPU_BACKOFF_BASE"
BACKOFF_CAP_ENV = "KARMADA_TPU_BACKOFF_CAP"
BREAKER_RESET_ENV = "KARMADA_TPU_BREAKER_RESET_SECONDS"


def _as_float(raw: str, default: float) -> float:
    try:
        return float(raw or default)
    except ValueError:
        return default


# breaker states (the gauge's value encoding)
CLOSED = 0
OPEN = 1
HALF_OPEN = 2

_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half-open"}


class Deadline:
    """One overall wall-clock budget for a multi-step call."""

    def __init__(self, budget_seconds: float, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self.budget = float(budget_seconds)

    def remaining(self) -> float:
        return max(self.budget - (self._clock() - self._t0), 0.0)

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def attempt_timeout(self, per_attempt: Optional[float] = None) -> float:
        """Per-RPC timeout: the remaining budget, capped by the policy's
        per-attempt bound so one black-holed attempt cannot eat the whole
        budget (raised as a floor of 1 ms so gRPC never sees 0)."""
        rem = self.remaining()
        if per_attempt is not None:
            rem = min(rem, per_attempt)
        return max(rem, 0.001)


class DeadlineExceeded(Exception):
    """The overall budget ran out before an attempt succeeded. ``cause``
    carries the last transport error (None when the budget expired before
    any attempt ran, e.g. breaker-open fast-fail)."""

    def __init__(self, message: str, cause: Optional[Exception] = None):
        super().__init__(message)
        self.cause = cause


class CircuitBreakerOpen(Exception):
    """Fast-fail: the channel's breaker is open — the caller should take
    its degraded path immediately instead of burning a doomed RPC."""


@dataclass(frozen=True)
class BackoffPolicy:
    """Decorrelated-jitter retry schedule + attempt bounds."""

    base: float = 0.05  # first sleep (and jitter floor)
    cap: float = 2.0  # max sleep between attempts
    attempt_timeout: Optional[float] = None  # per-RPC bound (None = budget)
    max_attempts: int = 4

    def sleeps(self, rng: random.Random):
        """Yields the decorrelated-jitter sleep sequence."""
        prev = self.base
        while True:
            prev = min(self.cap, rng.uniform(self.base, prev * 3))
            yield prev


def default_policy(
    *,
    attempt_timeout: Optional[float] = None,
    max_attempts: int = 4,
) -> BackoffPolicy:
    """The env-tuned policy every channel starts from (one knob surface,
    three channels — the whole point of the unification)."""
    import os

    return BackoffPolicy(
        base=_as_float(os.environ.get(BACKOFF_BASE_ENV, ""), 0.05),
        cap=_as_float(os.environ.get(BACKOFF_CAP_ENV, ""), 2.0),
        attempt_timeout=attempt_timeout,
        max_attempts=max_attempts,
    )


def default_breaker(
    channel: str,
    *,
    failure_threshold: int = 3,
    reset_default: float = 5.0,
    clock=time.monotonic,
) -> "CircuitBreaker":
    """``reset_default`` is the channel owner's reset window when the env
    knob is unset — the bus uses a short one (its single cheap probe is
    an agent's lifeline back to the plane), the estimator/solver channels
    the standard 5 s. KARMADA_TPU_BREAKER_RESET_SECONDS overrides all."""
    import os

    return CircuitBreaker(
        channel,
        failure_threshold=failure_threshold,
        reset_seconds=_as_float(
            os.environ.get(BREAKER_RESET_ENV, ""), reset_default
        ),
        clock=clock,
    )


class CircuitBreaker:
    """Per-channel closed/open/half-open machine.

    - CLOSED: calls flow; ``failure_threshold`` consecutive failures open.
    - OPEN: ``allow()`` answers False until ``reset_seconds`` elapse.
    - HALF_OPEN: exactly one probe is admitted; success closes, failure
      re-opens (and restarts the reset window).

    Transitions move the ``karmada_tpu_circuit_state`` gauge and record a
    zero-duration ``channel.breaker`` span so a wave trace shows WHEN the
    channel degraded/recovered. All state mutates under one lock —
    ``allow``/``record_*`` race from fan-out executors.
    """

    def __init__(
        self,
        channel: str,
        *,
        failure_threshold: int = 3,
        reset_seconds: float = 5.0,
        clock=time.monotonic,
    ):
        self.channel = channel
        self.failure_threshold = failure_threshold
        self.reset_seconds = reset_seconds
        self._clock = clock
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._lock = threading.Lock()
        self._publish(CLOSED)

    # -- state surface -----------------------------------------------------

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def engaged(self) -> bool:
        """Non-consuming: are calls currently being rejected? Unlike
        ``allow()`` this never takes the half-open probe slot, so routing
        layers (the estimator fan-out) can skip a dead connection without
        starving the probe that would heal it."""
        with self._lock:
            if self._state == OPEN:
                return self._clock() - self._opened_at < self.reset_seconds
            if self._state == HALF_OPEN:
                return self._probing
            return False

    def allow(self) -> bool:
        """May a call proceed right now? OPEN past the reset window flips
        to HALF_OPEN and admits one probe; concurrent callers during the
        probe stay rejected (one canary, not a thundering herd)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_seconds:
                    return False
                self._transition(HALF_OPEN)
                self._probing = True
                return True
            # HALF_OPEN: the single probe slot
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                self._probing = False
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self._state == OPEN:
                # a failure while already open restarts the reset window:
                # paths that gate on engaged() alone (future callbacks —
                # no allow()-driven HALF_OPEN transition ever runs there)
                # must stay protected while failures keep arriving, and
                # heal one reset window after they STOP
                self._opened_at = self._clock()
            elif (
                self._state == CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(OPEN)

    # -- internals ---------------------------------------------------------

    def _transition(self, to: int) -> None:
        """Called with the lock held."""
        frm, self._state = self._state, to
        self._publish(to, frm)

    def _publish(self, to: int, frm: Optional[int] = None) -> None:
        from .metrics import circuit_state
        from .tracing import tracer

        circuit_state.set(to, channel=self.channel)
        if frm is not None and frm != to:
            tracer.record(
                "channel.breaker", 0.0, channel=self.channel,
                from_state=_STATE_NAMES[frm], to_state=_STATE_NAMES[to],
            )


def call_with_resilience(
    fn: Callable[[float], object],
    *,
    channel: str,
    policy: BackoffPolicy,
    breaker: Optional[CircuitBreaker] = None,
    deadline: Optional[Deadline] = None,
    retryable: tuple = (Exception,),
    rng: Optional[random.Random] = None,
    sleep=time.sleep,
):
    """Run ``fn(attempt_timeout_seconds)`` under the unified policy.

    - breaker open -> ``CircuitBreakerOpen`` immediately (no RPC burned).
    - each attempt gets ``deadline.attempt_timeout(policy.attempt_timeout)``
      as its timeout; retries sleep decorrelated jitter, clamped to the
      remaining budget.
    - retries feed ``karmada_tpu_channel_retries_total{channel}``; the
      budget running out raises ``DeadlineExceeded`` wrapping the last
      transport error. Non-retryable exceptions propagate untouched.
    """
    from .metrics import channel_retries

    if breaker is not None and not breaker.allow():
        raise CircuitBreakerOpen(f"{channel} channel breaker is open")
    deadline = deadline or Deadline(
        policy.attempt_timeout
        if policy.attempt_timeout is not None
        else 60.0
    )
    rng = rng or random.Random()
    sleeps = policy.sleeps(rng)
    last: Optional[Exception] = None
    for attempt in range(policy.max_attempts):
        if deadline.expired:
            break
        try:
            result = fn(deadline.attempt_timeout(policy.attempt_timeout))
        except retryable as exc:  # noqa: PERF203 — retry loop
            last = exc
            if breaker is not None:
                breaker.record_failure()
                # non-consuming check: allow() here could take the half-
                # open probe slot and then leak it if the loop exits on
                # max_attempts/deadline without another fn() call —
                # wedging the breaker (nothing left to record)
                if breaker.engaged():
                    break  # opened mid-call: stop burning the budget
            if attempt + 1 >= policy.max_attempts:
                break
            channel_retries.inc(channel=channel)
            pause = min(next(sleeps), deadline.remaining())
            if pause > 0:
                sleep(pause)
            continue
        except BaseException:
            # non-retryable failure still resolves the breaker admission
            # (an unresolved half-open probe slot would wedge the breaker)
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return result
    raise DeadlineExceeded(
        f"{channel} call failed within {deadline.budget:.3f}s budget "
        f"({type(last).__name__ if last else 'no attempt ran'})",
        cause=last,
    )
