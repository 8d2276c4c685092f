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

What the JAX module adds on top (the wave-history sampler and the slow-wave
flight recorder that ``end_wave`` runs, cross-process peers, stitching and
flight files) belongs to the control plane's observability and is not part
of this copy.

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
        thread: the innermost open span, else the process-wide current
        wave."""
        stack = self._stack()
        if stack:
            top = stack[-1]
            return top.wave, top.trace_id, top.span_id
        with self._lock:
            return self.current_wave, self._trace_ids.get(self.current_wave, ""), None

    def current_context(self) -> TraceContext:
        """The innermost open span of this thread, else the current wave."""
        wave, trace_id, parent = self._open_ctx()
        return TraceContext(wave=wave, trace_id=trace_id, span_id=parent, proc=self.proc)

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
        sp = self._new_span(name, wave, trace_id, parent, dict(attrs))
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
