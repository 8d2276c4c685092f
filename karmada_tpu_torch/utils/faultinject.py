"""Deterministic fault injection: every failure scenario is a replayable seed.

The port's own copy of ``karmada_tpu/utils/faultinject.py``: a seeded
registry of *fault rules* armed from the environment
(``KARMADA_TPU_FAULT_SPEC`` + ``KARMADA_TPU_FAULT_SEED``) or
programmatically (``arm()``), consulted at fixed *injection points*.
Disarmed (the default) an injection point costs ONE module-global ``is
None`` check and allocates nothing; armed, every firing decision derives
from ``blake2b(seed, point, invocation-index)``, so a failure storm replays
bit-identically from its seed and the fired-event log is itself the replay
script a numpy oracle consumes (``refimpl/failover_np.replay_failover``).
The registry is process-global state of this package: the JAX package
keeps its own.

Spec grammar (semicolon-separated rules)::

    point=action[,rate=R][,count=N][,after=K][,match=SUBSTR][,delay=S]

    cluster.health=down,match=member3          # flip member3 NotReady

Actions: ``error``, ``drop``, ``delay``, ``sever`` (the transport seams'
actions) and ``down`` (the cluster model reads the member as unreachable;
``cluster.health`` only). The port's injection points are
``cluster.health`` in ``ClusterStatusController.collect`` and the RPC seams
of the transports, ``estimator.rpc`` (``GrpcEstimatorConnection``),
``solver.rpc`` (``RemoteSolver``), ``bus.rpc`` (a ``StoreReplica``'s
Apply, Delete and ApplyBatch, once per wire attempt) and ``bus.watch`` (a
``StoreReplica``'s watch stream, once per connect), which ``apply_fault``
interprets.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

#: spec + seed environment knobs
FAULT_SPEC_ENV = "KARMADA_TPU_FAULT_SPEC"
FAULT_SEED_ENV = "KARMADA_TPU_FAULT_SEED"

_ACTIONS = ("error", "drop", "delay", "sever", "down")


class FaultError(Exception):
    """Base of every injected failure (seams re-dress it as the channel's
    natural error type via ``injected_error`` so retry paths engage)."""


_grpc_fault_cls = None


def injected_error(point: str, key: str = "") -> Exception:
    """An exception that is BOTH ``FaultError`` and ``grpc.RpcError`` with
    ``code() == UNAVAILABLE`` — the gRPC seams raise this so their callers'
    ``except grpc.RpcError`` retry/failover paths treat an injected fault
    exactly like a real channel failure."""
    global _grpc_fault_cls
    if _grpc_fault_cls is None:
        import grpc  # lazy: the module imports without grpc

        class _InjectedRpcError(FaultError, grpc.RpcError):
            def __init__(self, message: str):
                super().__init__(message)

            def code(self):
                return grpc.StatusCode.UNAVAILABLE

            def details(self):
                return str(self)

        _grpc_fault_cls = _InjectedRpcError
    return _grpc_fault_cls(f"injected fault at {point} ({key})")


@dataclass
class FaultRule:
    point: str
    action: str
    rate: float = 1.0  # firing probability per eligible invocation
    count: Optional[int] = None  # max firings (None = unbounded)
    after: int = 0  # eligible only from this invocation index on
    match: str = ""  # substring filter over the call-site key
    delay_s: float = 0.05  # sleep for ``delay`` (and pre-error for ``drop``)
    fired: int = 0

    def eligible(self, key: str, invocation: int) -> bool:
        if self.match and self.match not in key:
            return False
        if invocation < self.after:
            return False
        return self.count is None or self.fired < self.count


@dataclass
class FaultEvent:
    """One fired fault — the registry's log is the replay script."""

    seq: int
    point: str
    action: str
    key: str


class FaultInjector:
    """Seeded rule registry. Thread-safe: the per-point invocation counters
    (the determinism source) mutate under one lock."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules: dict[str, list[FaultRule]] = {}
        for r in rules:
            self.rules.setdefault(r.point, []).append(r)
        self.seed = seed
        self.log: list[FaultEvent] = []
        self._invocations: dict[str, int] = {}
        self._lock = threading.Lock()

    def _decide(self, point: str, invocation: int, rate: float) -> bool:
        if rate >= 1.0:
            return True
        h = hashlib.blake2b(
            f"{self.seed}:{point}:{invocation}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "little") / 2**64 < rate

    def fire(self, point: str, key: str = "") -> Optional[FaultRule]:
        """The armed half of ``fault_point``: returns the first rule that
        fires for this invocation (and logs it), else None."""
        rules = self.rules.get(point)
        if not rules:
            return None
        with self._lock:
            inv = self._invocations.get(point, 0)
            self._invocations[point] = inv + 1
            for rule in rules:
                if not rule.eligible(key, inv):
                    continue
                if not self._decide(point, inv, rule.rate):
                    continue
                rule.fired += 1
                self.log.append(
                    FaultEvent(len(self.log), point, rule.action, key)
                )
                return rule
        return None


#: the armed injector; None = disarmed (the zero-overhead steady state)
_INJECTOR: Optional[FaultInjector] = None


def parse_spec(spec: str) -> list[FaultRule]:
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, opts = part.partition(",")
        point, _, action = head.partition("=")
        point, action = point.strip(), action.strip()
        if not point or action not in _ACTIONS:
            raise ValueError(
                f"fault rule {part!r}: want point=action with action in "
                f"{_ACTIONS}"
            )
        rule = FaultRule(point=point, action=action)
        for opt in opts.split(","):
            opt = opt.strip()
            if not opt:
                continue
            k, _, v = opt.partition("=")
            if k == "rate":
                rule.rate = float(v)
            elif k == "count":
                rule.count = int(v)
            elif k == "after":
                rule.after = int(v)
            elif k == "match":
                rule.match = v
            elif k == "delay":
                rule.delay_s = float(v)
            else:
                raise ValueError(f"fault rule {part!r}: unknown option {k!r}")
        rules.append(rule)
    return rules


def arm(spec: str, seed: int = 0) -> FaultInjector:
    """Install (replace) the process-wide injector from a spec string."""
    global _INJECTOR
    _INJECTOR = FaultInjector(parse_spec(spec), seed=seed)
    return _INJECTOR


def disarm() -> None:
    global _INJECTOR
    _INJECTOR = None


def injector() -> Optional[FaultInjector]:
    return _INJECTOR


def arm_from_env() -> Optional[FaultInjector]:
    """Arm from KARMADA_TPU_FAULT_SPEC / KARMADA_TPU_FAULT_SEED (process
    entrypoints call this once at boot; empty spec leaves it disarmed)."""
    spec = os.environ.get(FAULT_SPEC_ENV, "")
    if not spec:
        return None
    try:
        seed = int(os.environ.get(FAULT_SEED_ENV, "0") or 0)
    except ValueError:
        seed = 0
    return arm(spec, seed)


def fault_point(point: str, key: str = "") -> Optional[FaultRule]:
    """THE injection-point call. Disarmed: one global load + ``is None``
    test, no allocation — safe on every hot path."""
    if _INJECTOR is None:
        return None
    return _INJECTOR.fire(point, key)


def apply_fault(
    rule: Optional[FaultRule], point: str, key: str = "", *, channel=None
) -> None:
    """Standard action interpreter for RPC seams: sleep for delay/drop,
    close the channel for sever, raise the injected transport error for
    error/drop/sever. ``delay`` returns normally (the call proceeds)."""
    if rule is None:
        return
    import time as _time

    if rule.action == "delay":
        _time.sleep(rule.delay_s)
        return
    if rule.action == "drop":
        _time.sleep(rule.delay_s)
    if rule.action == "sever" and channel is not None:
        try:
            channel.close()
        except Exception:  # noqa: BLE001 — sever teardown is best-effort
            pass
    raise injected_error(point, key)
