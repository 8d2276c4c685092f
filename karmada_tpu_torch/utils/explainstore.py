"""ExplainStore: ring-capped per-wave placement-provenance captures.

The port's copy of ``karmada_tpu/utils/explainstore.py`` (numpy only). The
engine's armed-only explain launch (``ops.explain_pass``, K14) answers, for
every binding x cluster of a pass, a packed EXCLUSION BITMASK — one bit per
decision stage, in ``utils.reasons.STAGE_REASONS`` order — plus a
per-binding top-k candidate summary (availability, credited prev, final
assignment) and the selected affinity-group rank. This module is where
those captures live: a lock-disciplined, ring-capped store (a capture
enters the ring complete, evictions are counted), decoded per binding as a
decision chain and summarised per wave.

Mask rows are interned (np.unique over the [B, C] byte matrix): storms
carry few unique placements, so a 100k-binding capture stores U unique
rows + one int32 index instead of the dense grid.

Arming: ``KARMADA_TPU_EXPLAIN=1`` arms every engine built in the process
(disarmed = one ``is None`` check per pass); ``KARMADA_TPU_EXPLAIN_CAP``
bounds the ring in WAVES (0 disables the store even when armed).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from .reasons import STAGE_REASONS, classify_error

EXPLAIN_ENV = "KARMADA_TPU_EXPLAIN"
EXPLAIN_CAP_ENV = "KARMADA_TPU_EXPLAIN_CAP"

_DEFAULT_CAP = 8

#: clusters listed per stage in a decoded explanation (the full count is
#: always reported; the name list is a sample, not the set)
_STAGE_NAME_CAP = 16


def explain_armed() -> bool:
    """The process-wide arm switch (read once per engine construction —
    the hot path costs one ``is None`` check, not an env read)."""
    return os.environ.get(EXPLAIN_ENV, "").strip().lower() in (
        "1", "true", "yes",
    )


def _env_cap() -> int:
    raw = os.environ.get(EXPLAIN_CAP_ENV, "").strip()
    if not raw:
        return _DEFAULT_CAP
    try:
        return max(int(raw), 0)
    except ValueError:
        return _DEFAULT_CAP


def intern_rows(masks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(masks, axis=0, return_inverse=True)`` of a uint8[B, C]
    matrix (the inverse as int32), by each row's bytes: the same unique
    rows in the same lexicographic order and the same inverse, without the
    sort over a C-field structured dtype that ``np.unique``'s axis form
    runs (seconds for one 4096 x 5000 chunk of mostly equal rows)."""
    masks = np.ascontiguousarray(masks, dtype=np.uint8)
    if masks.ndim != 2 or 0 in masks.shape:
        uniq, inv = np.unique(masks, axis=0, return_inverse=True)
        return uniq, inv.reshape(-1).astype(np.int32)
    rows = [r.tobytes() for r in masks]
    first: dict[bytes, int] = {}
    for i, key in enumerate(rows):
        first.setdefault(key, i)
    order = sorted(first)  # bytes compare as unsigned, like the field-wise sort
    rank = {key: u for u, key in enumerate(order)}
    inv = np.fromiter((rank[key] for key in rows), np.int32, len(rows))
    return masks[[first[key] for key in order]], inv


class ExplainCapture:
    """One engine pass's provenance: interned exclusion-mask rows + the
    top-k candidate summary. Built COMPLETELY before entering the ring."""

    __slots__ = (
        "wave", "at", "names", "keys", "index", "uniq_masks", "mask_inv",
        "topk", "group_rank", "reasons", "errors",
        "asg_rows", "asg_cols", "asg_vals",
    )

    def __init__(
        self,
        *,
        wave: int,
        names: tuple,
        keys: list,
        masks: np.ndarray,  # uint8[B, C] packed stage-exclusion bits
        topk: np.ndarray,  # int32[B, K, 5]: cluster, avail, prev, assigned, mask
        group_rank: np.ndarray,  # int32[B] selected affinity-group index
        errors: list,  # per-binding ScheduleResult.error ("" = scheduled)
        assignment: np.ndarray,  # int32[B, C] the pass's final assignment
    ):
        b = len(keys)
        assert masks.shape[0] == b and topk.shape[0] == b
        assert assignment.shape[0] == b
        self.wave = int(wave)
        self.at = time.time()
        self.names = tuple(names)
        self.keys = list(keys)
        self.index = {k: i for i, k in enumerate(keys)}
        # intern mask rows: storms repeat placements, so U << B
        self.uniq_masks, self.mask_inv = intern_rows(masks)
        self.topk = np.ascontiguousarray(topk, dtype=np.int32)
        self.group_rank = np.ascontiguousarray(group_rank, dtype=np.int32)
        self.errors = list(errors)
        self.reasons = [classify_error(e) for e in errors]
        # the FULL assignment, stored sparse (CSR-ish: np.nonzero answers
        # row-major order, so asg_rows is sorted): the top-k summary caps
        # at k candidates, but a wide placement (Duplicated over hundreds
        # of clusters) must still decode its complete final assignment
        rows, cols = np.nonzero(np.asarray(assignment) > 0)
        self.asg_rows = rows.astype(np.int32)
        self.asg_cols = cols.astype(np.int32)
        self.asg_vals = np.asarray(assignment)[rows, cols].astype(np.int32)

    @property
    def bindings(self) -> int:
        return len(self.keys)

    def nbytes(self) -> int:
        return int(
            self.uniq_masks.nbytes + self.mask_inv.nbytes
            + self.topk.nbytes + self.group_rank.nbytes
            + self.asg_rows.nbytes + self.asg_cols.nbytes
            + self.asg_vals.nbytes
        )

    def mask_row(self, row: int) -> np.ndarray:
        return self.uniq_masks[self.mask_inv[row]]

    def decode(self, row: int) -> dict:
        """One binding's decision chain: per-stage excluded clusters,
        the top-k candidate table, the selected group, and the final
        verdict (classified reason + assignment)."""
        mask = self.mask_row(row)
        stages: dict[str, dict] = {}
        for bit, code in enumerate(STAGE_REASONS):
            hit = np.flatnonzero((mask >> np.uint8(bit)) & np.uint8(1))
            if hit.size:
                stages[code] = {
                    "clusters": [
                        self.names[j] for j in hit[:_STAGE_NAME_CAP]
                    ],
                    "count": int(hit.size),
                }
        candidates = []
        for j, avail, prev, assigned, m in self.topk[row].tolist():
            if j < 0:
                continue
            candidates.append({
                "cluster": self.names[j],
                "available": int(avail),
                "prev": int(prev),
                "assigned": int(assigned),
                "excluded_by": [
                    code for bit, code in enumerate(STAGE_REASONS)
                    if (int(m) >> bit) & 1
                ],
            })
        # the COMPLETE assignment off the sparse store — never the top-k
        # slice (a wide placement assigns more clusters than k)
        lo = int(np.searchsorted(self.asg_rows, row))
        hi = int(np.searchsorted(self.asg_rows, row + 1))
        assignment = {
            self.names[int(j)]: int(v)
            for j, v in zip(self.asg_cols[lo:hi], self.asg_vals[lo:hi])
        }
        feasible = int((mask == 0).sum())
        return {
            "binding": self.keys[row],
            "wave": self.wave,
            "at": self.at,
            "reason": self.reasons[row],
            "error": self.errors[row],
            "scheduled": not self.errors[row],
            "group_rank": int(self.group_rank[row]),
            "clusters_total": len(self.names),
            "clusters_feasible": feasible,
            "stages": stages,
            "candidates": candidates,
            "assignment": assignment,
        }


class ExplainStore:
    """PER-WAVE ring of ``ExplainCapture``s — the process-wide
    provenance memory behind ``/debug/explain`` (the history-ring
    discipline: complete rows, one lock, counted evictions). A pass is
    captured as one capture per engine chunk; the cap counts WAVES, so
    a many-chunk storm pass can never evict its own early chunks."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = _env_cap() if cap is None else cap
        self._lock = threading.Lock()
        self._captures: deque = deque()
        self._evicted = 0
        self._added = 0

    @property
    def enabled(self) -> bool:
        return self.cap > 0

    def add(self, capture: ExplainCapture) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._captures.append(capture)
            self._added += 1
            waves: list = []
            for c in self._captures:
                if c.wave not in waves:
                    waves.append(c.wave)
            while len(waves) > self.cap:
                drop = waves.pop(0)
                while self._captures and self._captures[0].wave == drop:
                    self._captures.popleft()
                    self._evicted += 1

    def captures(self, wave: Optional[int] = None) -> list:
        with self._lock:
            caps = list(self._captures)
        if wave is not None:
            caps = [c for c in caps if c.wave == wave]
        return caps

    @property
    def evicted(self) -> int:
        with self._lock:
            return self._evicted

    @property
    def added(self) -> int:
        with self._lock:
            return self._added

    def clear(self) -> None:
        with self._lock:
            self._captures.clear()
            self._evicted = 0
            self._added = 0

    # -- queries -----------------------------------------------------------

    def explain_binding(
        self, key: str, wave: Optional[int] = None
    ) -> Optional[dict]:
        """Newest explanation for ``key`` (optionally pinned to one
        wave). Accepts both the engine's problem key and a bare
        ``ns/name``."""
        for cap in reversed(self.captures(wave)):
            row = cap.index.get(key)
            if row is None and "/" in key:
                # problem keys are namespaced names already; tolerate a
                # kind-prefixed form (``ResourceBinding/ns/name``)
                for k, r in cap.index.items():
                    if k == key or k.endswith("/" + key):
                        row = r
                        break
            if row is not None:
                return cap.decode(row)
        return None

    def wave_summary(self, wave: Optional[int] = None) -> dict:
        """Per-reason verdict counts + per-stage exclusion totals over
        one wave's captures (default: the newest captured wave)."""
        caps = self.captures(wave)
        if wave is None and caps:
            wave = caps[-1].wave
            caps = [c for c in caps if c.wave == wave]
        verdicts: dict[str, int] = {}
        stage_excluded: dict[str, int] = {}
        bindings = 0
        for cap in caps:
            bindings += cap.bindings
            for r in cap.reasons:
                verdicts[r] = verdicts.get(r, 0) + 1
            counts = np.bincount(
                cap.mask_inv, minlength=len(cap.uniq_masks)
            )
            for bit, code in enumerate(STAGE_REASONS):
                rows = (
                    (cap.uniq_masks >> np.uint8(bit)) & np.uint8(1)
                ).sum(axis=1)
                total = int((rows * counts).sum())
                if total:
                    stage_excluded[code] = (
                        stage_excluded.get(code, 0) + total
                    )
        return {
            "wave": wave,
            "captures": len(caps),
            "bindings": bindings,
            "verdicts": dict(sorted(verdicts.items())),
            "stage_excluded_cells": dict(sorted(stage_excluded.items())),
        }

    def worst(self, wave: Optional[int] = None, k: int = 8) -> list[dict]:
        """The K worst bindings of a wave, decoded: denied/unschedulable
        rows first (newest capture wins a key), then displaced rows that
        fell back to a later affinity group. The flight recorder
        attaches exactly this to a breaching wave's record."""
        caps = self.captures(wave)
        if wave is None and caps:
            caps = [c for c in caps if c.wave == caps[-1].wave]
        seen: set = set()
        ranked: list[tuple] = []
        for cap in reversed(caps):
            for row, key in enumerate(cap.keys):
                if key in seen:
                    continue
                # newest capture wins the key UNCONDITIONALLY: a binding
                # denied in an early pass but scheduled by a later pass
                # of the same wave must not surface its stale denial
                seen.add(key)
                if cap.errors[row]:
                    badness = 0
                elif int(cap.group_rank[row]) > 0:
                    badness = 1  # displaced onto a fallback group
                else:
                    continue
                ranked.append((badness, len(ranked), cap, row))
        ranked.sort(key=lambda t: (t[0], t[1]))
        return [cap.decode(row) for _, _, cap, row in ranked[:k]]

    def worst_context(
        self, wave: Optional[int] = None, k: int = 8
    ) -> Optional[dict]:
        """The flight recorder's attachment: worst-binding explanations
        plus the wave's verdict summary (None when nothing captured —
        the record stays explain-free rather than carrying an empty
        shell)."""
        worst = self.worst(wave, k)
        if not worst:
            return None
        return {"summary": self.wave_summary(wave), "worst": worst}

    # -- documents ---------------------------------------------------------

    def debug_doc(
        self,
        binding: Optional[str] = None,
        wave: Optional[int] = None,
        proc: str = "",
    ) -> dict:
        """THE ``/debug/explain`` document (one builder so the HTTP
        endpoint, the CLI and the flight recorder can never drift on
        shape)."""
        doc: dict = {
            "proc": proc,
            "cap": self.cap,
            "added": self.added,
            "evicted": self.evicted,
            "waves": sorted({c.wave for c in self.captures()}),
        }
        if binding is not None:
            doc["binding"] = self.explain_binding(binding, wave)
        else:
            doc["summary"] = self.wave_summary(wave)
            doc["worst"] = self.worst(wave)
        return doc


_STORE: Optional[ExplainStore] = None
_STORE_LOCK = threading.Lock()


def store() -> ExplainStore:
    """The process-wide store (the tracer/registry pattern): armed
    engines write it, ``/debug/explain`` and the flight recorder read
    it."""
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = ExplainStore()
    return _STORE


def reset_store() -> None:
    """Test/bench hook: drop the singleton so the next ``store()`` call
    re-reads the env cap."""
    global _STORE
    with _STORE_LOCK:
        _STORE = None


# --------------------------------------------------------------------------
# rendering (karmadactl-tpu explain, trace analyze)
# --------------------------------------------------------------------------


def render_explanation(doc: dict) -> str:
    """One binding's decision chain as text (the CLI view; the JSON doc
    stays the machine surface)."""
    if doc is None:
        return "(no explanation captured)"
    lines = [
        f"binding {doc.get('binding')} wave {doc.get('wave')} -> "
        + (
            "SCHEDULED" if doc.get("scheduled")
            else f"{doc.get('reason')} ({doc.get('error')})"
        ),
        f"affinity group rank {doc.get('group_rank', 0)}; "
        f"{doc.get('clusters_feasible', 0)}/{doc.get('clusters_total', 0)} "
        f"clusters feasible",
    ]
    stages = doc.get("stages") or {}
    if stages:
        lines.append("excluded by stage:")
        for code in STAGE_REASONS:
            st = stages.get(code)
            if not st:
                continue
            names = ", ".join(st.get("clusters", []))
            more = st.get("count", 0) - len(st.get("clusters", []))
            tail = f" (+{more} more)" if more > 0 else ""
            lines.append(f"  {code:<28} {st.get('count', 0):>6}  "
                         f"{names}{tail}")
    cands = doc.get("candidates") or []
    if cands:
        lines.append(
            f"{'candidate':<20} {'avail':>10} {'prev':>6} {'assigned':>9}"
            "  excluded_by"
        )
        for cd in cands:
            lines.append(
                f"{cd.get('cluster', '?'):<20} "
                f"{cd.get('available', 0):>10} {cd.get('prev', 0):>6} "
                f"{cd.get('assigned', 0):>9}  "
                + (",".join(cd.get("excluded_by", [])) or "-")
            )
    asg = doc.get("assignment") or {}
    if asg:
        lines.append(
            "assignment: "
            + ", ".join(f"{k}={v}" for k, v in sorted(asg.items()))
        )
    return "\n".join(lines)


def render_worst_table(ctx: dict) -> str:
    """The flight-record attachment as text — what ``trace analyze``
    appends when a breaching wave carried worst-binding explanations."""
    summary = ctx.get("summary") or {}
    verdicts = summary.get("verdicts") or {}
    lines = [
        f"explain: wave {summary.get('wave')} — "
        + (
            ", ".join(f"{k} x{v}" for k, v in sorted(verdicts.items()))
            or "no verdicts"
        ),
    ]
    for doc in ctx.get("worst") or []:
        top_stage = max(
            (doc.get("stages") or {}).items(),
            key=lambda kv: kv[1].get("count", 0),
            default=(None, None),
        )[0]
        lines.append(
            f"  {doc.get('binding'):<40} {doc.get('reason'):<24} "
            f"group={doc.get('group_rank', 0)} feasible="
            f"{doc.get('clusters_feasible', 0)}"
            + (f" top_stage={top_stage}" if top_stage else "")
        )
    return "\n".join(lines)
