"""In-memory API store with watch bus — the control-plane state hub.

The port's own copy of ``karmada_tpu/utils/store.py``: typed buckets keyed by
(kind, namespace/name), resource-version bumping, watch handlers,
finalizer-aware deletion. Controllers subscribe and reconcile; the plane is
driven deterministically with ``Runtime.run_until_settled``
(``utils.worker``); ``checkpoint`` and ``restore`` are the plane's resume.
``rv``, ``advance_rv``, ``kinds`` and ``unwatch_all`` are the seams of the
store bus (``bus/service.py``): its server lists and watches a primary, and
its replicas mirror the primary's resource versions.

Ref analogues: client-go informers / fedinformer managers (pkg/util/fedinformer)
and the apiserver REST semantics the reference assumes.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..api.core import ObjectMeta, new_uid

ADDED = "Added"
MODIFIED = "Modified"
DELETED = "Deleted"


class ConflictError(RuntimeError):
    """Optimistic-concurrency precondition failed (the apiserver's 409):
    the object's resource_version moved under the caller. Re-read and
    retry, or give up the claim."""


@dataclass(frozen=True)
class Event:
    type: str  # Added | Modified | Deleted
    kind: str
    key: str  # namespace/name or name
    obj: Any


WatchHandler = Callable[[Event], None]


def obj_key(obj: Any) -> str:
    meta: ObjectMeta = obj.meta
    return meta.namespaced_name


def obj_kind(obj: Any) -> str:
    return type(obj).KIND if hasattr(type(obj), "KIND") else type(obj).__name__


class Store:
    """Typed object store. Mutations are thread-safe; watch handlers run
    synchronously on the mutating thread, outside the lock (so handlers may
    re-enter the store). Cross-thread event *ordering* is therefore not
    guaranteed — the deterministic runtime (utils.worker) is
    single-threaded, which is the supported concurrency model."""

    def __init__(
        self,
        admission: Optional[Callable[[str, Any], None]] = None,
        delete_admission: Optional[Callable[[str, Any], None]] = None,
    ) -> None:
        self._lock = threading.RLock()
        self._buckets: dict[str, dict[str, Any]] = {}
        self._watchers: dict[str, list[WatchHandler]] = {}
        self._all_watchers: list[WatchHandler] = []
        self._rv = 0
        # admission(kind, obj) raises to reject an apply (webhook seam);
        # delete_admission likewise guards Delete operations
        self._admission = admission
        self._delete_admission = delete_admission

    @property
    def rv(self) -> int:
        """Current resource-version counter (public read for change-gated
        periodic checkpoints and diagnostics)."""
        with self._lock:
            return self._rv

    def advance_rv(self, rv: int) -> None:
        """Advance the resource-version counter to at least ``rv - 1`` so the
        NEXT apply stamps ``rv``. The seam for replicas mirroring a primary's
        version stream (bus ``StoreReplica``): the replica aligns the counter
        before each replayed apply so its objects carry the primary's rvs."""
        with self._lock:
            self._rv = max(self._rv, rv - 1)

    # -- mutation ----------------------------------------------------------

    def apply(self, obj: Any, *, expected_rv: Optional[int] = None) -> Any:
        """Create-or-update. Bumps resource_version (callers that mutate
        spec in place bump ``meta.generation`` themselves).

        ``expected_rv`` is the apiserver's optimistic-concurrency
        precondition: the write succeeds only if the CURRENT object's
        resource_version equals it (0 = the object must not exist yet);
        otherwise ConflictError (HTTP 409)."""
        kind = obj_kind(obj)
        key = obj_key(obj)
        if self._admission is not None:
            self._admission(kind, obj)
        with self._lock:
            bucket = self._buckets.setdefault(kind, {})
            existing = bucket.get(key)
            if expected_rv is not None:
                current_rv = (
                    existing.meta.resource_version
                    if existing is not None
                    else 0
                )
                if current_rv != expected_rv:
                    raise ConflictError(
                        f"{kind} {key!r}: resource_version is "
                        f"{current_rv}, precondition {expected_rv}"
                    )
            self._rv += 1
            obj.meta.resource_version = self._rv
            if not obj.meta.uid:
                obj.meta.uid = existing.meta.uid if existing else new_uid()
            if existing is None and not obj.meta.creation_timestamp:
                obj.meta.creation_timestamp = time.time()
            bucket[key] = obj
            event = Event(MODIFIED if existing is not None else ADDED, kind, key, obj)
        self._deliver(event)
        return obj

    def apply_many(self, objs: list) -> list:
        """Batched create-or-update for INDEPENDENT objects: admission runs
        per object (against pre-batch state — use only for sweeps whose
        objects don't admit against each other, like a storm writeback
        over distinct bindings), then one lock acquisition commits every
        ACCEPTED mutation, then one delivery sweep fans the events out.

        Admission rejections do NOT abort the batch: rejected objects are
        skipped (no rv bump, no event) and returned as
        ``[(obj, exception), ...]`` for the caller to surface. No
        ``expected_rv`` support: CAS writers want the single-object path."""
        if not objs:
            return []
        errors: list = []
        keyed = []
        for obj in objs:
            kind = obj_kind(obj)
            key = obj_key(obj)
            if self._admission is not None:
                try:
                    self._admission(kind, obj)
                except Exception as e:  # noqa: BLE001 — per-object verdict
                    errors.append((obj, e))
                    continue
            keyed.append((kind, key, obj))
        events = []
        with self._lock:
            for kind, key, obj in keyed:
                bucket = self._buckets.setdefault(kind, {})
                existing = bucket.get(key)
                self._rv += 1
                obj.meta.resource_version = self._rv
                if not obj.meta.uid:
                    obj.meta.uid = existing.meta.uid if existing else new_uid()
                if existing is None and not obj.meta.creation_timestamp:
                    obj.meta.creation_timestamp = time.time()
                bucket[key] = obj
                events.append(
                    Event(
                        MODIFIED if existing is not None else ADDED,
                        kind, key, obj,
                    )
                )
        for ev in events:
            self._deliver(ev)
        return errors

    def delete(self, kind: str, key: str, *, force: bool = False) -> Optional[Any]:
        """Delete an object. With finalizers present (and not force), only
        marks deletion_timestamp and emits MODIFIED — controllers must strip
        finalizers, after which the delete completes (kube semantics).
        ``force`` is the internal finalizer-completion path and skips delete
        admission, like a direct etcd removal."""
        if not force and self._delete_admission is not None:
            existing = self.get(kind, key)
            if existing is not None:
                self._delete_admission(kind, existing)
        with self._lock:
            bucket = self._buckets.get(kind, {})
            obj = bucket.get(key)
            if obj is None:
                return None
            if obj.meta.finalizers and not force:
                if obj.meta.deletion_timestamp is None:
                    obj.meta.deletion_timestamp = time.time()
                    self._rv += 1
                    obj.meta.resource_version = self._rv
                    event = Event(MODIFIED, kind, key, obj)
                else:
                    return obj
            else:
                del bucket[key]
                event = Event(DELETED, kind, key, obj)
        self._deliver(event)
        return obj

    def finalize(self, obj: Any) -> None:
        """Re-evaluate a deleting object: if finalizers are now empty, remove
        it for real."""
        if obj.meta.deletion_timestamp is not None and not obj.meta.finalizers:
            self.delete(obj_kind(obj), obj_key(obj), force=True)
        else:
            self.apply(obj)

    # -- reads -------------------------------------------------------------

    def get(self, kind: str, key: str) -> Optional[Any]:
        with self._lock:
            return self._buckets.get(kind, {}).get(key)

    def list(self, kind: str, namespace: Optional[str] = None) -> list[Any]:
        with self._lock:
            objs = list(self._buckets.get(kind, {}).values())
        if namespace is not None:
            objs = [o for o in objs if o.meta.namespace == namespace]
        return objs

    # -- durability (checkpoint/resume) -------------------------------------

    def checkpoint(self, path: str) -> int:
        """Serialize every object to ``path`` (the etcd-snapshot analogue:
        the store is the single source of truth, controllers and the solver
        are stateless, so a snapshot + replay IS resume). Returns the number
        of objects written."""
        # Serialize while holding the lock: the bucket copies are shallow
        # and delete()/finalize mutate stored objects' meta IN PLACE under
        # the lock, so pickling after release could tear the snapshot
        # (tests/test_torch_checkpoint.py pins this under concurrent
        # writers).
        with self._lock:
            payload = {
                kind: dict(bucket) for kind, bucket in self._buckets.items()
            }
            blob = pickle.dumps({"rv": self._rv, "buckets": payload})
        # atomic replace: a crash (or SIGKILL) mid-write must never leave a
        # truncated snapshot that bricks the next restore
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return sum(len(b) for b in payload.values())

    def restore(self, path: str) -> int:
        """Load a checkpoint into this (fresh) store, replaying every object
        through the watch bus as Added so already-registered controllers
        rebuild their working state — the reconcile-from-listing pattern the
        reference relies on after an apiserver restart. Admission is NOT
        re-run: the snapshot was admitted when it was written. A checkpoint
        holds the classes of the package that wrote it: the port restores
        its own checkpoints."""
        with open(path, "rb") as f:
            snap = pickle.load(f)
        events = []
        with self._lock:
            self._rv = max(self._rv, snap["rv"])
            for kind, bucket in snap["buckets"].items():
                dst = self._buckets.setdefault(kind, {})
                for key, obj in bucket.items():
                    dst[key] = obj
                    events.append(Event(ADDED, kind, key, obj))
        for event in events:
            self._deliver(event)
        return len(events)

    def kinds(self) -> list[str]:
        with self._lock:
            return list(self._buckets.keys())

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler, *, replay: bool = True) -> None:
        """Subscribe to events for one kind. With replay, synthesizes ADDED
        events for existing objects (informer initial-list semantics)."""
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)
            existing = list(self._buckets.get(kind, {}).items()) if replay else []
        for key, obj in existing:
            handler(Event(ADDED, kind, key, obj))

    def watch_all(self, handler: WatchHandler) -> None:
        with self._lock:
            self._all_watchers.append(handler)

    def unwatch_all(self, handler: WatchHandler) -> None:
        """Unregister a watch_all handler (long-lived stores outlive bus
        servers; a dead server's handler must not stay on the write path)."""
        with self._lock:
            self._all_watchers = [h for h in self._all_watchers if h is not handler]

    def _deliver(self, event: Event) -> None:
        # snapshot the handler lists under the lock, call OUTSIDE it — a
        # handler mutating watchers mid-delivery must not tear the
        # iteration, and delivery under the lock would hold it across
        # arbitrary handler code
        with self._lock:
            handlers = list(self._watchers.get(event.kind, ()))
            handlers += list(self._all_watchers)
        for handler in handlers:
            handler(event)
