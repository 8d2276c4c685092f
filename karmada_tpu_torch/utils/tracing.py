"""Wave-scoped span tracing: the port's copy of the wave/span core of
``karmada_tpu/utils/tracing.py``.

A monotonic WAVE id is stamped when new work enters the plane
(``begin_wave``/``ensure_wave``) and closed at quiescence (``end_wave``);
every instrumented region records a ``Span`` carrying that wave id and its
parent span id, in a bounded ring. ``Runtime.run_until_settled`` opens the
wave of a settle and records its ``settle`` span with one
``controller.<worker>`` child per worker drain; the scheduler process records
one ``scheduler.pass`` span per engine pass under it (attrs ``bindings``,
``dirty_rows``, ``preempted``). The engine reads
``tracer.current_context().wave`` to stamp its provenance captures and
records ``scheduler.explain`` and ``scheduler.preempt`` spans.

Across processes, the trace context rides gRPC invocation metadata
(``trace_metadata`` on the client, ``decode_trace_metadata`` in the server
handler) and a handler records its span under the caller's wave with
``server_span``; ``activate`` and ``ContextPropagatingExecutor`` carry the
context onto fan-out threads, and ``open_manual``/``close_manual`` time a
window that closes on another thread. The solver sidecar and the estimator
servers record their ``solver.*`` and ``estimator.*`` spans this way.

What the JAX module adds on top (the wave-history sampler and the slow-wave
flight recorder that ``end_wave`` runs, the peer registry, stitching and
flight files) belongs to the control plane's observability and is not part
of this copy (ROADMAP A17).

Thread-safety: the ring and the wave bookkeeping mutate under one lock; the
open-span parent chain is thread-local.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("karmada_tpu_torch.trace")

TRACE_CAPACITY_ENV = "KARMADA_TPU_TRACE_CAPACITY"
_DEFAULT_CAPACITY = 8192


@dataclass(frozen=True)
class TraceContext:
    """The (wave, trace id, span id) triple and the caller's process name."""

    wave: int
    trace_id: str
    span_id: Optional[int]
    proc: str


@dataclass
class Span:
    """One timed region of one wave; ``attrs`` may be filled while open."""

    name: str
    wave: int
    span_id: int
    parent_id: Optional[int]
    start: float  # perf_counter
    wall: float  # time.time at open
    end: Optional[float] = None
    attrs: dict = field(default_factory=dict)
    trace_id: str = ""

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.perf_counter()) - self.start

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "wave": self.wave,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start": round(self.start, 6),
            "wall": round(self.wall, 6),
            "duration_s": round(self.duration, 6),
            "attrs": dict(self.attrs),
        }


#: gRPC metadata keys carrying the context (lowercase per gRPC rules)
MD_WAVE = "karmada-tpu-wave"
MD_TRACE = "karmada-tpu-trace"
MD_SPAN = "karmada-tpu-span"
MD_PROC = "karmada-tpu-proc"


def trace_metadata(ctx: Optional[TraceContext]) -> tuple:
    """``ctx`` as gRPC invocation metadata pairs (empty when no context —
    callers splice this into the stub call unconditionally)."""
    if ctx is None or not ctx.trace_id:
        return ()
    return (
        (MD_WAVE, str(ctx.wave)),
        (MD_TRACE, ctx.trace_id),
        (MD_SPAN, "" if ctx.span_id is None else str(ctx.span_id)),
        (MD_PROC, ctx.proc),
    )


def decode_trace_metadata(pairs) -> Optional[TraceContext]:
    """Decode a server handler's invocation metadata back to a context.
    Tolerant: absent or malformed values answer None (an untraced caller
    must never fail the RPC)."""
    if not pairs:
        return None
    md = {}
    try:
        for k, v in pairs:
            md[str(k).lower()] = v
    except (TypeError, ValueError):
        return None
    trace_id = md.get(MD_TRACE, "")
    if not trace_id:
        return None
    try:
        wave = int(md.get(MD_WAVE, "0") or 0)
    except ValueError:
        return None
    raw_span = md.get(MD_SPAN, "")
    span_id: Optional[int] = None
    if raw_span:
        try:
            span_id = int(raw_span)
        except ValueError:
            return None
    return TraceContext(
        wave=wave, trace_id=str(trace_id), span_id=span_id,
        proc=str(md.get(MD_PROC, "") or "peer"),
    )


def _env_capacity() -> int:
    raw = os.environ.get(TRACE_CAPACITY_ENV, "").strip()
    if not raw:
        return _DEFAULT_CAPACITY
    try:
        return max(int(raw), 16)
    except ValueError:
        log.warning("bad %s=%r; using %d", TRACE_CAPACITY_ENV, raw, _DEFAULT_CAPACITY)
        return _DEFAULT_CAPACITY


class WaveTracer:
    """Ring-buffered, thread-safe, nestable span recorder keyed by wave.

    ``ensure_wave(reason)`` opens a wave if none is open and ``end_wave()``
    closes it, so one storm is one wave id however it was triggered. Every
    wave mints a trace id; a span stamps (wave, trace id) once, at open."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = _env_capacity() if capacity is None else capacity
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque()
        self._wave_seq = itertools.count(1)
        self._span_seq = itertools.count(1)
        self._local = threading.local()
        self.current_wave = 0
        self._wave_open = False
        self.proc = "plane"
        self._trace_ids: dict[int, str] = {}
        self._dropped_total = 0

    def set_process(self, name: str) -> None:
        """The process name spans propagate as their caller (``solver``,
        ``estimator``); set once at an entry point's boot."""
        with self._lock:
            self.proc = name

    # -- waves -------------------------------------------------------------

    def _begin_wave_locked(self) -> int:
        self.current_wave = next(self._wave_seq)
        self._wave_open = True
        self._trace_ids[self.current_wave] = uuid.uuid4().hex[:16]
        if len(self._trace_ids) > 512:
            for w in sorted(self._trace_ids)[:-256]:
                del self._trace_ids[w]
        return self.current_wave

    def begin_wave(self, reason: str = "") -> int:
        with self._lock:
            return self._begin_wave_locked()

    def ensure_wave(self, reason: str = "") -> int:
        # one critical section for check-and-open: racing threads agree on
        # a single wave id for one burst
        with self._lock:
            if self._wave_open:
                return self.current_wave
            return self._begin_wave_locked()

    def open_wave(self) -> Optional[int]:
        """The wave currently open, or None."""
        with self._lock:
            return self.current_wave if self._wave_open else None

    def end_wave(self) -> int:
        """Close the open wave and return its id."""
        with self._lock:
            self._wave_open = False
            return self.current_wave

    # -- spans -------------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _open_ctx(self) -> tuple[int, str, Optional[int]]:
        """(wave, trace id, parent span id) for a span opening now on this
        thread: the innermost open span, then the thread's ambient context
        (executor tasks, server handlers), else the process-wide current
        wave."""
        stack = self._stack()
        if stack:
            top = stack[-1]
            return top.wave, top.trace_id, top.span_id
        amb = getattr(self._local, "ambient", None)
        if amb is not None:
            return amb.wave, amb.trace_id, amb.span_id
        with self._lock:
            return self.current_wave, self._trace_ids.get(self.current_wave, ""), None

    def current_context(self) -> TraceContext:
        """The context a client seam propagates: the innermost open span
        (or ambient context) of this thread, else the current wave."""
        wave, trace_id, parent = self._open_ctx()
        return TraceContext(wave=wave, trace_id=trace_id, span_id=parent, proc=self.proc)

    @contextmanager
    def activate(self, ctx: Optional[TraceContext]):
        """Install ``ctx`` as this thread's ambient context: spans opened
        with no local parent nest under ``ctx.span_id``'s wave and trace.
        Fan-out executors capture ``current_context()`` before submit and
        activate it in the task."""
        if ctx is None:
            yield
            return
        prev = getattr(self._local, "ambient", None)
        self._local.ambient = ctx
        try:
            yield
        finally:
            self._local.ambient = prev

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                self._dropped_total += 1
            self._spans.append(sp)

    def _new_span(self, name, wave, trace_id, parent_id, attrs, *,
                  start: Optional[float] = None, end: Optional[float] = None) -> Span:
        now = time.perf_counter()
        start = now if start is None else start
        return Span(name=name, wave=wave, span_id=next(self._span_seq),
                    parent_id=parent_id, start=start, wall=time.time() - (now - start),
                    end=end, attrs=attrs, trace_id=trace_id)

    @contextmanager
    def span(self, name: str, **attrs):
        """Record a span under the current wave, nested under this thread's
        innermost open span; yields the ``Span`` so callers can stamp
        attrs. A span whose attrs hold ``_discard=True`` at close never
        reaches the ring."""
        wave, trace_id, parent = self._open_ctx()
        with self._span_at(name, wave, trace_id, parent, dict(attrs)) as sp:
            yield sp

    @contextmanager
    def server_span(self, name: str, ctx: Optional[TraceContext], **attrs):
        """The server half of context propagation: record a handler span
        under the CALLER's wave and trace. A remote caller's span id cannot
        be a local parent (ids are per process), so it lands in
        ``remote_parent`` (with ``caller``); an in-process caller (same
        ``proc``) nests naturally."""
        if ctx is None or ctx.proc == self.proc:
            with self.span(name, **attrs) as sp:
                yield sp
            return
        attrs = dict(attrs)
        attrs["remote_parent"] = ctx.span_id
        attrs["caller"] = ctx.proc
        with self._span_at(name, ctx.wave, ctx.trace_id, None, attrs) as sp:
            yield sp

    @contextmanager
    def _span_at(self, name: str, wave: int, trace_id: str, parent: Optional[int],
                 attrs: dict):
        sp = self._new_span(name, wave, trace_id, parent, attrs)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.end = time.perf_counter()
            stack.pop()
            if not sp.attrs.pop("_discard", False):
                self._append(sp)

    def record(self, name: str, duration: float, **attrs) -> Span:
        """Append an already-measured region as a completed span ending
        now, nested under this thread's innermost open span."""
        wave, trace_id, parent = self._open_ctx()
        now = time.perf_counter()
        sp = self._new_span(name, wave, trace_id, parent, dict(attrs),
                            start=now - duration, end=now)
        self._append(sp)
        return sp

    def open_manual(self, name: str, ctx: Optional[TraceContext] = None,
                    **attrs) -> Span:
        """Allocate an OPEN span without pushing it on this thread's stack,
        for an in-flight window that closes on another thread (the
        pipelined ``call_future`` seam closes its client span from the grpc
        done callback). Close with ``close_manual``; until then the span is
        not in the ring."""
        if ctx is None:
            wave, trace_id, parent = self._open_ctx()
        else:
            wave, trace_id, parent = ctx.wave, ctx.trace_id, ctx.span_id
        return self._new_span(name, wave, trace_id, parent, dict(attrs))

    def close_manual(self, sp: Span) -> None:
        sp.end = time.perf_counter()
        self._append(sp)

    # -- export ------------------------------------------------------------

    def dump(self, wave: Optional[int] = None) -> list[dict]:
        with self._lock:
            spans = list(self._spans)
        if wave is not None:
            spans = [s for s in spans if s.wave == wave]
        return [s.to_json() for s in spans]

    @property
    def dropped_total(self) -> int:
        """Spans evicted from the full ring (counted, never silent)."""
        with self._lock:
            return self._dropped_total


#: the process-wide tracer
tracer = WaveTracer()


class ContextPropagatingExecutor:
    """Submit-side context propagation over any executor: each task runs
    under the SUBMITTER's trace context (innermost open span at submit
    time), so fan-out RPC spans land in the wave that fanned them out.
    Wraps only ``submit`` (the estimator fan-out pools use nothing else)
    and delegates the rest."""

    def __init__(self, executor, tracer_obj: Optional[WaveTracer] = None):
        self._executor = executor
        self._tracer = tracer_obj or tracer

    def submit(self, fn, *args, **kwargs):
        tr = self._tracer
        ctx = tr.current_context()

        def run():
            with tr.activate(ctx):
                return fn(*args, **kwargs)

        return self._executor.submit(run)

    def shutdown(self, wait: bool = True) -> None:
        self._executor.shutdown(wait=wait)

    def __getattr__(self, name):
        return getattr(self._executor, name)
