"""The port's ``utils/backoff.py`` against the JAX package's.

The scenarios of ``tests/test_backoff.py`` (the deadline budget, the
decorrelated-jitter policy and its environment knobs, the circuit breaker's
closed / open / half-open machine and its gauge, ``call_with_resilience``'s
retries, budget and breaker admission), each run on both packages'
modules and metric families; and the same seed draws the same sleeps in
both. Tolerance: exact equality.
"""

from __future__ import annotations

import importlib
import random
import threading

import pytest

import karmada_tpu
import karmada_tpu_torch

PKGS = (karmada_tpu, karmada_tpu_torch)


@pytest.fixture(params=PKGS, ids=lambda p: p.__name__)
def mods(request):
    """(backoff, circuit_state, channel_retries) of one package."""
    metrics = importlib.import_module(f"{request.param.__name__}.utils.metrics")
    return (importlib.import_module(f"{request.param.__name__}.utils.backoff"),
            metrics.circuit_state, metrics.channel_retries)


def test_same_seed_same_sleeps():
    sleeps = [
        [s for s, _ in zip(importlib.import_module(f"{p.__name__}.utils.backoff")
                           .BackoffPolicy(base=0.05, cap=2.0).sleeps(random.Random(7)),
                           range(40))]
        for p in PKGS
    ]
    assert sleeps[0] == sleeps[1]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class TestDeadline:
    def test_budget_counts_down(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        d = backoff.Deadline(10.0, clock=clk)
        assert d.remaining() == 10.0
        clk.t = 4.0
        assert d.remaining() == 6.0
        assert not d.expired
        clk.t = 11.0
        assert d.expired and d.remaining() == 0.0

    def test_attempt_timeout_caps_and_floors(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        d = backoff.Deadline(10.0, clock=clk)
        assert d.attempt_timeout(3.0) == 3.0
        clk.t = 8.5
        assert d.attempt_timeout(3.0) == pytest.approx(1.5)
        clk.t = 20.0
        assert d.attempt_timeout(3.0) == 0.001  # floor, never 0


class TestBackoffPolicy:
    def test_decorrelated_jitter_bounds(self, mods):
        backoff, circuit_state, channel_retries = mods
        policy = backoff.BackoffPolicy(base=0.1, cap=1.0)
        sleeps = policy.sleeps(random.Random(42))
        prev = policy.base
        for _ in range(50):
            s = next(sleeps)
            assert policy.base <= s <= min(policy.cap, max(prev * 3, policy.base))
            prev = s

    def test_env_tuned_default_policy(self, mods, monkeypatch):
        backoff, circuit_state, channel_retries = mods
        monkeypatch.setenv("KARMADA_TPU_BACKOFF_BASE", "0.2")
        monkeypatch.setenv("KARMADA_TPU_BACKOFF_CAP", "7.5")
        p = backoff.default_policy()
        assert p.base == 0.2 and p.cap == 7.5
        monkeypatch.setenv("KARMADA_TPU_BACKOFF_BASE", "junk")
        assert backoff.default_policy().base == 0.05  # bad value -> default


class TestCircuitBreaker:
    def _breaker(self, backoff, clk, threshold=3, reset=5.0):
        return backoff.CircuitBreaker(
            "test-chan", failure_threshold=threshold, reset_seconds=reset,
            clock=clk,
        )

    def test_closed_to_open_to_half_open_to_closed(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = self._breaker(backoff, clk)
        assert b.state == backoff.CLOSED and b.allow()
        for _ in range(3):
            b.record_failure()
        assert b.state == backoff.OPEN
        assert not b.allow() and b.engaged()
        assert circuit_state.value(channel="test-chan") == backoff.OPEN
        clk.t = 6.0  # past the reset window
        assert not b.engaged()  # non-consuming: probe still available
        assert b.allow()  # takes the single probe slot
        assert b.state == backoff.HALF_OPEN
        assert not b.allow()  # concurrent callers stay rejected
        b.record_success()
        assert b.state == backoff.CLOSED
        assert circuit_state.value(channel="test-chan") == backoff.CLOSED

    def test_half_open_failure_reopens_and_restarts_window(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = self._breaker(backoff, clk)
        for _ in range(3):
            b.record_failure()
        clk.t = 6.0
        assert b.allow()
        b.record_failure()
        assert b.state == backoff.OPEN
        clk.t = 10.0  # window restarted at t=6: still open
        assert not b.allow()
        clk.t = 11.5
        assert b.allow()
        b.record_success()
        assert b.state == backoff.CLOSED

    def test_success_resets_failure_streak(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = self._breaker(backoff, clk)
        b.record_failure()
        b.record_failure()
        b.record_success()
        b.record_failure()
        b.record_failure()
        assert b.state == backoff.CLOSED  # never 3 consecutive

    def test_engaged_never_consumes_the_probe(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = self._breaker(backoff, clk)
        for _ in range(3):
            b.record_failure()
        clk.t = 6.0
        for _ in range(10):
            assert not b.engaged()
        assert b.allow()  # probe still there after 10 engaged() checks

    def test_thread_safety_smoke(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = self._breaker(backoff, clk, threshold=5)

        def hammer():
            for i in range(200):
                if b.allow():
                    (b.record_success if i % 3 else b.record_failure)()

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert b.state in (backoff.CLOSED, backoff.OPEN, backoff.HALF_OPEN)


class TestCallWithResilience:
    def test_retries_then_succeeds_and_counts(self, mods):
        backoff, circuit_state, channel_retries = mods
        calls = []
        before = channel_retries.value(channel="retry-chan")

        def fn(timeout):
            calls.append(timeout)
            if len(calls) < 3:
                raise ValueError("flaky")
            return "ok"

        out = backoff.call_with_resilience(
            fn,
            channel="retry-chan",
            policy=backoff.BackoffPolicy(
                base=0.001, cap=0.002, attempt_timeout=0.5, max_attempts=4
            ),
            deadline=backoff.Deadline(5.0),
            retryable=(ValueError,),
            sleep=lambda s: None,
        )
        assert out == "ok" and len(calls) == 3
        assert channel_retries.value(channel="retry-chan") == before + 2

    def test_budget_exhaustion_wraps_last_error(self, mods):
        backoff, circuit_state, channel_retries = mods
        def fn(timeout):
            raise ValueError("down")

        with pytest.raises(backoff.DeadlineExceeded) as exc:
            backoff.call_with_resilience(
                fn,
                channel="x",
                policy=backoff.BackoffPolicy(
                    base=0.001, cap=0.001, attempt_timeout=0.1,
                    max_attempts=2,
                ),
                deadline=backoff.Deadline(1.0),
                retryable=(ValueError,),
                sleep=lambda s: None,
            )
        assert isinstance(exc.value.cause, ValueError)

    def test_breaker_open_fast_fails_without_attempt(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = backoff.CircuitBreaker("fast", clock=clk, failure_threshold=1)
        b.record_failure()
        calls = []
        with pytest.raises(backoff.CircuitBreakerOpen):
            backoff.call_with_resilience(
                lambda t: calls.append(t),
                channel="fast",
                policy=backoff.BackoffPolicy(attempt_timeout=0.1),
                breaker=b,
            )
        assert not calls

    def test_non_retryable_resolves_breaker_admission(self, mods):
        backoff, circuit_state, channel_retries = mods
        clk = FakeClock()
        b = backoff.CircuitBreaker("probe", clock=clk, failure_threshold=1)
        b.record_failure()
        clk.t = 10.0  # half-open window

        with pytest.raises(KeyError):
            backoff.call_with_resilience(
                lambda t: (_ for _ in ()).throw(KeyError("bug")),
                channel="probe",
                policy=backoff.BackoffPolicy(attempt_timeout=0.1),
                breaker=b,
                retryable=(ValueError,),
            )
        # the probe slot was resolved (as failure), not leaked
        assert b.state == backoff.OPEN
        clk.t = 20.0
        assert b.allow()  # a fresh probe is available
