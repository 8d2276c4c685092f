"""Networked store watch bus: the plane's watch/apply surface, over gRPC or
an in-process channel. The port's own copy of ``karmada_tpu/bus/service.py``.

Ref: the reference's control plane is nine binaries around a shared
API server whose informer/watch channel carries all state
(pkg/util/fedinformer; the agent consumes it over DCN). This runtime's
Store is in-proc; the bus exports the same two primitives — a watch
(replay + live events, the informer list-then-watch contract) and
Apply/Delete write-through — so agents and out-of-process controllers can
run a ``StoreReplica``: a local Store mirror fed by the stream whose writes
round-trip to the primary.

Objects travel as canonical JSON of the API dataclasses (``utils/codec``);
decode resolves classes from the kind registry below. Unknown kinds
degrade to generic Resource manifests rather than failing the stream
(forward compatibility across component versions).

The batched protocol: ``ApplyBatch`` carries a write SET per call with
per-op resourceVersion/CAS results, and the batched watch streams coalesced
event frames flushed by count (KARMADA_TPU_BUS_BATCH) or a few-ms timer
(KARMADA_TPU_BUS_FLUSH_MS). Both are negotiated per connection: an old
server answers UNIMPLEMENTED, the client pins the unary fallback, and a wire
failure resets the pin so the reconnected channel re-probes.

Layers:

- ``StoreBusCore`` serves one Store with no protobuf: watches yield
  ``Event``/``Frame`` records (replay, then the bookmark, then live events),
  writes answer ``BatchResult`` records.
- ``StoreBusServer`` is the gRPC shell over a core: its handlers turn the
  core's records into the ``storebus`` messages and back. The service and
  message names on the wire are the JAX package's
  (``karmada_tpu.bus.StoreBus``), so a process of either package talks to
  the other's.
- ``StoreReplica`` mirrors a primary through a channel: ``GrpcChannel``
  to a ``host:port``, or ``InProcessChannel`` to a core in the same
  process. Every object crosses the in-process channel as the same
  canonical JSON the wire carries, and every replay and event as the same
  records, so a mirror over it runs the same codec, replay, bookmark and
  resource-version rules; only the transport differs, and no object of
  the primary is ever shared with a mirror.

``grpc`` and the ``_pb2`` modules are imported inside the classes that use
them: this module, ``StoreBusCore``, ``InProcessChannel`` and a replica over
it run where grpc and protobuf are absent.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional

from ..api.core import Resource
from ..utils import Store
from ..utils.codec import _FIELD_NAMES, from_jsonable
from ..utils.metrics import (
    bus_batch_size,
    bus_event_age_seconds,
    bus_events,
    bus_queue_depth,
    bus_subscribers,
)
from ..utils.store import ConflictError
from ..utils.store import Event as StoreEvent

SERVICE_NAME = "karmada_tpu.bus.StoreBus"

BUS_BATCH_ENV = "KARMADA_TPU_BUS_BATCH"
BUS_FLUSH_MS_ENV = "KARMADA_TPU_BUS_FLUSH_MS"


def bus_batch_max() -> int:
    """Max ops per ApplyBatch / events per watch frame; 0 disables the
    batched protocol entirely (the mixed-version escape hatch)."""
    raw = os.environ.get(BUS_BATCH_ENV, "").strip()
    try:
        return int(raw) if raw else 4096
    except ValueError:
        return 4096


def bus_flush_ms() -> float:
    """Watch-frame coalescing window: after the first queued event, the
    stream waits up to this long for more before flushing the frame."""
    raw = os.environ.get(BUS_FLUSH_MS_ENV, "").strip()
    try:
        return float(raw) if raw else 2.0
    except ValueError:
        return 2.0


#: gRPC message-size ceiling for the bus channel (both directions): a
#: batched write set / replay frame legitimately reaches tens of MiB.
#: Producers still chunk against BATCH_BYTE_BUDGET so a healthy batch stays
#: far below this hard cap.
MAX_MESSAGE_BYTES = 128 << 20
#: soft per-message byte budget: apply_many cuts a batch and watch streams
#: flush a frame once the accumulated object JSON crosses it — count
#: (KARMADA_TPU_BUS_BATCH) bounds the common case, this bounds the
#: pathological one (few huge manifests)
BATCH_BYTE_BUDGET = 16 << 20

_CHANNEL_OPTIONS = [
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
]


def _kind_registry() -> dict[str, type]:
    """kind string -> dataclass, collected from every API surface that
    stores objects (the scheme registry analogue)."""
    from ..api import autoscaling, cluster, core, networking, policy, work
    from ..controllers import extras
    from ..interpreter import declarative
    from ..search import registry as search_registry

    registry: dict[str, type] = {}
    for module in (
        core, cluster, policy, work, autoscaling, networking, extras,
        declarative, search_registry,
    ):
        for name in dir(module):
            cls = getattr(module, name)
            if (
                isinstance(cls, type)
                and dataclasses.is_dataclass(cls)
                and isinstance(getattr(cls, "KIND", None), str)
            ):
                registry[cls.KIND] = cls
    registry["Resource"] = Resource
    return registry


_REGISTRY: Optional[dict[str, type]] = None


def kind_registry() -> dict[str, type]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _kind_registry()
    return _REGISTRY


def _fields_of(obj):
    """``json``'s hook for a dataclass: its fields as a dict, in
    ``to_jsonable``'s form (the encoder walks the values itself)."""
    names = _FIELD_NAMES.get(type(obj))
    if names is None:
        if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
            raise TypeError(f"{type(obj).__name__} is not JSON serializable")
        names = _FIELD_NAMES[type(obj)] = tuple(f.name for f in dataclasses.fields(obj))
    return {name: getattr(obj, name) for name in names}


def encode_object(obj) -> str:
    """The canonical JSON of ``obj``: ``json.dumps(to_jsonable(obj),
    sort_keys=True, separators=(",", ":"))``, byte for byte, with the
    dataclasses expanded by the encoder's hook instead of copied first."""
    return json.dumps(obj, default=_fields_of, sort_keys=True, separators=(",", ":"))


def decode_object(kind: str, object_json: str):
    cls = kind_registry().get(kind, Resource)
    doc = json.loads(object_json)
    if isinstance(doc, dict) and ("apiVersion" in doc or "api_version" in doc):
        # multi-version seam: a legacy-versioned payload (e.g.
        # work.karmada.io/v1alpha1 bindings) upgrades to the hub shape
        # before decode, so old clients keep working against a hub store
        from ..api.versioning import maybe_upgrade

        doc = maybe_upgrade(kind, doc)
    return from_jsonable(cls, doc)


def _kind_of(obj) -> str:
    return type(obj).KIND if hasattr(type(obj), "KIND") else "Resource"


# -- the records the core speaks (the storebus messages' fields) -----------


class Event(NamedTuple):
    """One watch event (``storebus.Event`` / ``FrameEvent``); ``type`` is
    Added | Modified | Deleted, or Bookmark at the replay boundary of the
    unary watch."""

    type: str
    kind: str = ""
    key: str = ""
    resource_version: int = 0
    object_json: str = ""


class Frame(NamedTuple):
    """One coalesced watch frame (``EventFrame``); ``bookmark`` marks the
    replay boundary."""

    events: tuple = ()
    bookmark: bool = False


class BatchOp(NamedTuple):
    """One write-through operation (``BatchOp``): an apply (optionally
    CAS-conditional) or, with ``delete``, a delete of (kind, key)."""

    kind: str
    object_json: str = ""
    conditional: bool = False
    expected_rv: int = 0
    delete: bool = False
    key: str = ""
    force: bool = False


class BatchResult(NamedTuple):
    """One write's answer (``BatchResult``; an Apply's and a Delete's
    response carry the same fields)."""

    resource_version: int = 0
    error: str = ""
    conflict: bool = False
    deleted: bool = False


class WatchRequest(NamedTuple):
    kinds: tuple = ()
    replay: bool = False


class ApplyRequest(NamedTuple):
    kind: str
    object_json: str = ""
    conditional: bool = False
    expected_rv: int = 0


class DeleteRequest(NamedTuple):
    kind: str
    key: str = ""
    force: bool = False


class ApplyBatchRequest(NamedTuple):
    ops: tuple = ()


class ApplyBatchResponse(NamedTuple):
    results: tuple = ()


class Messages(NamedTuple):
    """The request types a replica builds for its channel: the storebus
    messages on the wire, these records in process."""

    WatchRequest: type
    ApplyRequest: type
    DeleteRequest: type
    BatchOp: type
    ApplyBatchRequest: type


RECORDS = Messages(WatchRequest, ApplyRequest, DeleteRequest, BatchOp, ApplyBatchRequest)


def _always() -> bool:
    return True


class StoreBusCore:
    """Serves one Store's watch/apply surface as records, protobuf-free.

    Subscribers register BEFORE their replay so writes landing mid-replay
    re-deliver (clients dedup on resource_version); the store lock inside
    ``list()`` snapshots each kind. A subscriber whose queue overflows is
    marked dead and its stream ends, forcing a reconnect and re-list."""

    def __init__(self, store: Store):
        self.store = store
        # (queue, kind filter, dead flag) per subscriber
        self._subscribers: list[tuple[queue.Queue, frozenset, list]] = []
        self._lock = threading.Lock()
        store.watch_all(self._fan_out)

    def close(self) -> None:
        self.store.unwatch_all(self._fan_out)

    # -- subscriptions -----------------------------------------------------

    def _subscribe(self, kinds: frozenset):
        q: queue.Queue = queue.Queue(maxsize=100_000)
        dead = [False]  # set when the subscriber overflows (too slow)
        with self._lock:
            self._subscribers.append((q, kinds, dead))
            bus_subscribers.set(len(self._subscribers))
        return q, dead

    def _unsubscribe(self, q) -> None:
        with self._lock:
            self._subscribers = [s for s in self._subscribers if s[0] is not q]
            bus_subscribers.set(len(self._subscribers))

    def _replay_kinds(self, kinds: frozenset):
        # WorkloadTemplates replay FIRST: the Works that follow carry
        # template refs, and a consumer reconciling a replayed Work must
        # find its template already mirrored (alphabetical order would
        # replay "Work" before "WorkloadTemplate")
        for kind in sorted(self.store.kinds(), key=lambda k: (k != "WorkloadTemplate", k)):
            if not kinds or kind in kinds:
                yield kind

    def _fan_out(self, event: StoreEvent) -> None:
        with self._lock:
            subs = [s for s in self._subscribers if not s[1] or event.kind in s[1]]
        if not subs:
            return  # no interested subscriber: stay off the write path
        # encode ONCE per event; queues carry (enqueue stamp, record) and
        # each stream mode builds its own message — the stamp is per event
        # so frame coalescing cannot fake a low queue age
        record = Event(
            event.type, event.kind, event.key,
            getattr(event.obj.meta, "resource_version", 0),
            encode_object(event.obj),
        )
        now = time.monotonic()
        depth = 0
        dropped = 0
        for q, _, dead in subs:
            try:
                q.put_nowait((now, record))
                depth = max(depth, q.qsize())
            except queue.Full:
                # slow subscriber: close its stream so it reconnects and
                # re-lists — silently dropping would leave it stale forever
                dead[0] = True
                dropped += 1
        bus_events.inc(len(subs) - dropped, result="delivered")
        if dropped:
            bus_events.inc(dropped, result="dropped")
        bus_queue_depth.set(depth)

    # -- watches -----------------------------------------------------------

    def watch(self, kinds, replay: bool, active=_always, ctx=None) -> Iterator[Event]:
        """Unary watch: one record per event — the replay (Added), a
        Bookmark, then live events until ``active()`` turns False or the
        subscriber overflows."""
        from ..utils.tracing import tracer

        kinds = frozenset(kinds)
        q, dead = self._subscribe(kinds)
        try:
            # the replay-to-bookmark window is the costly, attributable part
            # of a watch. MANUAL span: a generator suspends mid-replay with
            # the handler thread going on to serve other calls
            sp = tracer.server_open_manual("bus.watch", ctx, kinds=len(kinds))
            try:
                replayed = 0
                if replay:
                    for kind in self._replay_kinds(kinds):
                        for obj in self.store.list(kind):
                            replayed += 1
                            yield Event(
                                "Added", kind, obj.meta.namespaced_name,
                                obj.meta.resource_version, encode_object(obj),
                            )
                sp.attrs["replayed"] = replayed
            finally:
                tracer.close_manual(sp)
            # the Bookmark marks the replay boundary: clients report synced
            # only after it (the list-then-watch initial-sync contract)
            yield Event("Bookmark")
            while active() and not dead[0]:
                try:
                    queued_at, record = q.get(timeout=0.5)
                except queue.Empty:
                    continue
                # queue AGE: how long the event sat behind this subscriber's
                # backlog before the stream drained it
                bus_event_age_seconds.observe(time.monotonic() - queued_at)
                yield record
            # dead: fall through — ending the stream forces the client to
            # reconnect and re-list, healing the dropped-event gap
        finally:
            self._unsubscribe(q)

    def watch_frames(self, kinds, replay: bool, active=_always, ctx=None) -> Iterator[Frame]:
        """Batched watch: coalesced frames instead of one record per event.
        Frames flush at ``bus_batch_max()`` events or after
        ``bus_flush_ms()`` of quiet following the first queued event. Event
        AGE stays per event (each queue entry carries its own enqueue
        stamp) so coalescing cannot fake a low queue age."""
        from ..utils.tracing import tracer

        kinds = frozenset(kinds)
        flush_max = max(bus_batch_max(), 1)
        flush_s = max(bus_flush_ms(), 0.0) / 1000.0
        q, dead = self._subscribe(kinds)
        try:
            sp = tracer.server_open_manual("bus.watch", ctx, kinds=len(kinds), batch=True)
            try:
                replayed = 0
                if replay:
                    frame: list = []
                    frame_bytes = 0
                    for kind in self._replay_kinds(kinds):
                        for obj in self.store.list(kind):
                            replayed += 1
                            doc = encode_object(obj)
                            frame.append(Event(
                                "Added", kind, obj.meta.namespaced_name,
                                obj.meta.resource_version, doc,
                            ))
                            frame_bytes += len(doc)
                            if len(frame) >= flush_max or frame_bytes >= BATCH_BYTE_BUDGET:
                                bus_batch_size.observe(len(frame))
                                yield Frame(tuple(frame))
                                frame = []
                                frame_bytes = 0
                    if frame:
                        bus_batch_size.observe(len(frame))
                        yield Frame(tuple(frame))
                sp.attrs["replayed"] = replayed
            finally:
                tracer.close_manual(sp)
            yield Frame(bookmark=True)
            while active() and not dead[0]:
                try:
                    entry = q.get(timeout=0.5)
                except queue.Empty:
                    continue
                entries = [entry]
                nbytes = len(entry[1].object_json)
                flush_at = time.monotonic() + flush_s
                while len(entries) < flush_max and nbytes < BATCH_BYTE_BUDGET:
                    wait = flush_at - time.monotonic()
                    if wait <= 0:
                        # timer expired: drain whatever is already queued
                        # without blocking, then flush
                        try:
                            while len(entries) < flush_max and nbytes < BATCH_BYTE_BUDGET:
                                e = q.get_nowait()
                                entries.append(e)
                                nbytes += len(e[1].object_json)
                        except queue.Empty:
                            pass
                        break
                    try:
                        e = q.get(timeout=wait)
                        entries.append(e)
                        nbytes += len(e[1].object_json)
                    except queue.Empty:
                        break
                now = time.monotonic()
                for queued_at, _ in entries:
                    # per-EVENT age: a frame of N events records N
                    # observations, not 1
                    bus_event_age_seconds.observe(now - queued_at)
                bus_batch_size.observe(len(entries))
                yield Frame(tuple(record for _, record in entries))
        finally:
            self._unsubscribe(q)

    # -- writes ------------------------------------------------------------

    def apply(self, kind: str, object_json: str, conditional: bool = False,
              expected_rv: int = 0, ctx=None) -> BatchResult:
        from ..utils.tracing import tracer

        with tracer.server_span("bus.apply", ctx, kind=kind) as sp:
            try:
                applied = self.store.apply(
                    decode_object(kind, object_json),
                    expected_rv=expected_rv if conditional else None,
                )
                return BatchResult(resource_version=applied.meta.resource_version)
            except ConflictError as e:
                # typed over the wire — a CAS loser must see a 409, not a
                # 500 (and never by pattern-matching error text)
                sp.attrs["error"] = "conflict"
                return BatchResult(error=str(e), conflict=True)
            except Exception as e:  # noqa: BLE001 — wire surface
                sp.attrs["error"] = type(e).__name__
                return BatchResult(error=str(e))

    def delete(self, kind: str, key: str, force: bool = False, ctx=None) -> BatchResult:
        from ..utils.tracing import tracer

        with tracer.server_span("bus.delete", ctx, kind=kind) as sp:
            try:
                gone = self.store.delete(kind, key, force=force)
                return BatchResult(deleted=gone is not None)
            except Exception as e:  # noqa: BLE001 — wire surface
                sp.attrs["error"] = type(e).__name__
                return BatchResult(error=str(e))

    def apply_batch(self, ops, ctx=None) -> list[BatchResult]:
        """One write SET per call. Plain applies commit through the store's
        batched path (one lock sweep + one delivery sweep); CAS-conditional
        ops and deletes run individually IN op order so a conflict surfaces
        on exactly the conflicting op while the rest of the batch commits
        (the reference's controller writebacks are independent per-object
        patches)."""
        from ..utils.tracing import tracer

        bus_batch_size.observe(len(ops))
        with tracer.server_span("bus.apply_batch", ctx, ops=len(ops)) as sp:
            results: list = [None] * len(ops)
            plain: list[tuple[int, object]] = []

            def flush_plain():
                if not plain:
                    return
                failed = {id(obj): exc for obj, exc in self.store.apply_many(
                    [obj for _, obj in plain])}
                for i, obj in plain:
                    exc = failed.get(id(obj))
                    results[i] = (BatchResult(error=str(exc)) if exc is not None
                                  else BatchResult(resource_version=obj.meta.resource_version))
                plain.clear()

            for i, op in enumerate(ops):
                try:
                    if op.delete:
                        flush_plain()
                        gone = self.store.delete(op.kind, op.key, force=op.force)
                        results[i] = BatchResult(deleted=gone is not None)
                    elif op.conditional:
                        flush_plain()
                        applied = self.store.apply(
                            decode_object(op.kind, op.object_json),
                            expected_rv=op.expected_rv,
                        )
                        results[i] = BatchResult(resource_version=applied.meta.resource_version)
                    else:
                        plain.append((i, decode_object(op.kind, op.object_json)))
                except ConflictError as e:
                    results[i] = BatchResult(error=str(e), conflict=True)
                except Exception as e:  # noqa: BLE001 — wire surface
                    results[i] = BatchResult(error=str(e))
            flush_plain()
            errors = sum(1 for r in results if r.error)
            if errors:
                sp.attrs["errors"] = errors
            return results


class StoreBusServer:
    """Serves one Store's watch/apply surface over gRPC (mTLS contract
    identical to the estimator/solver servers): a thin shell that turns a
    ``StoreBusCore``'s records into the storebus messages. ``core`` is
    the server's core; an ``InProcessChannel`` over it serves in-process
    replicas beside the wire's."""

    def __init__(
        self,
        store: Store,
        address: str = "127.0.0.1:0",
        *,
        server_cert: Optional[bytes] = None,
        server_key: Optional[bytes] = None,
        client_ca: Optional[bytes] = None,
        max_workers: int = 8,
        enable_batch: bool = True,
    ):
        from concurrent import futures

        import grpc

        from ..utils.tracing import decode_trace_metadata
        from .proto import storebus_batch_pb2 as bpb
        from .proto import storebus_pb2 as pb

        self.store = store
        self.core = core = StoreBusCore(store)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[("grpc.so_reuseport", 0)] + _CHANNEL_OPTIONS,
        )

        def _ctx(context):
            return decode_trace_metadata(context.invocation_metadata())

        def watch(request, context):
            for ev in core.watch(request.kinds, request.replay, context.is_active,
                                 _ctx(context)):
                yield pb.Event(type=ev.type, kind=ev.kind, key=ev.key,
                               resource_version=ev.resource_version,
                               object_json=ev.object_json)

        def watch_batch(request, context):
            for frame in core.watch_frames(request.kinds, request.replay,
                                           context.is_active, _ctx(context)):
                yield bpb.EventFrame(
                    events=[bpb.FrameEvent(type=ev.type, kind=ev.kind, key=ev.key,
                                           resource_version=ev.resource_version,
                                           object_json=ev.object_json)
                            for ev in frame.events],
                    bookmark=frame.bookmark)

        def apply(request, context):
            r = core.apply(request.kind, request.object_json, request.conditional,
                           request.expected_rv, _ctx(context))
            return pb.ApplyResponse(resource_version=r.resource_version, error=r.error,
                                    conflict=r.conflict)

        def delete(request, context):
            r = core.delete(request.kind, request.key, request.force, _ctx(context))
            return pb.DeleteResponse(deleted=r.deleted, error=r.error)

        def apply_batch(request, context):
            results = core.apply_batch(list(request.ops), _ctx(context))
            return bpb.ApplyBatchResponse(results=[bpb.BatchResult(**r._asdict())
                                                   for r in results])

        handlers = {
            "Watch": grpc.unary_stream_rpc_method_handler(
                watch,
                request_deserializer=pb.WatchRequest.FromString,
                response_serializer=pb.Event.SerializeToString,
            ),
            "Apply": grpc.unary_unary_rpc_method_handler(
                apply,
                request_deserializer=pb.ApplyRequest.FromString,
                response_serializer=pb.ApplyResponse.SerializeToString,
            ),
            "Delete": grpc.unary_unary_rpc_method_handler(
                delete,
                request_deserializer=pb.DeleteRequest.FromString,
                response_serializer=pb.DeleteResponse.SerializeToString,
            ),
        }
        # the batched protocol ships behind a registration toggle: an
        # old-server shape (enable_batch=False, the mixed-version tests)
        # leaves ApplyBatch/WatchBatch unregistered so clients get
        # UNIMPLEMENTED and negotiate the unary fallback per connection
        if enable_batch:
            handlers["ApplyBatch"] = grpc.unary_unary_rpc_method_handler(
                apply_batch,
                request_deserializer=bpb.ApplyBatchRequest.FromString,
                response_serializer=bpb.ApplyBatchResponse.SerializeToString,
            )
            handlers["WatchBatch"] = grpc.unary_stream_rpc_method_handler(
                watch_batch,
                request_deserializer=pb.WatchRequest.FromString,
                response_serializer=bpb.EventFrame.SerializeToString,
            )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        if bool(server_cert) != bool(server_key) or (
            client_ca and not (server_cert and server_key)
        ):
            raise ValueError(
                "incomplete server TLS config: server_cert and server_key are "
                "both required (and client_ca implies them)"
            )
        if server_cert and server_key:
            creds = grpc.ssl_server_credentials(
                [(server_key, server_cert)],
                root_certificates=client_ca,
                require_client_auth=client_ca is not None,
            )
            self.port = self._server.add_secure_port(address, creds)
        else:
            self.port = self._server.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"store bus failed to bind {address}")

    def start(self) -> int:
        self._server.start()
        return self.port

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self.core.close()
        self._server.stop(grace)


# -- the replica's channels -------------------------------------------------
#
# A channel offers the storebus stubs as callables — ``watch(request)`` and
# ``watch_batch(request)`` (streams of events / frames), ``apply``,
# ``delete`` and ``apply_batch`` (``(request, timeout=, metadata=)``) —
# the request types to build for them (``messages``), the exceptions that
# mean a wire failure (``wire_errors``), ``unimplemented(exc)`` and
# ``close()``.


class GrpcChannel:
    """The replica's channel to a bus server at ``target`` (``host:port``),
    with optional mTLS: the generated stubs over the storebus messages."""

    def __init__(self, target: str, *, root_ca: Optional[bytes] = None,
                 client_cert: Optional[bytes] = None, client_key: Optional[bytes] = None):
        import grpc

        from .proto import storebus_batch_pb2 as bpb
        from .proto import storebus_pb2 as pb

        if (client_cert or client_key) and not (root_ca and client_cert and client_key):
            raise ValueError(
                "incomplete client TLS config: client_cert/client_key require "
                "each other and root_ca"
            )
        if root_ca is not None:
            creds = grpc.ssl_channel_credentials(
                root_certificates=root_ca,
                private_key=client_key,
                certificate_chain=client_cert,
            )
            self._channel = grpc.secure_channel(target, creds, options=_CHANNEL_OPTIONS)
        else:
            self._channel = grpc.insecure_channel(target, options=_CHANNEL_OPTIONS)
        self._grpc = grpc
        self.target = target
        self.wire_errors = (grpc.RpcError,)
        self.messages = Messages(pb.WatchRequest, pb.ApplyRequest, pb.DeleteRequest,
                                 bpb.BatchOp, bpb.ApplyBatchRequest)
        self.watch = self._channel.unary_stream(
            f"/{SERVICE_NAME}/Watch",
            request_serializer=pb.WatchRequest.SerializeToString,
            response_deserializer=pb.Event.FromString,
        )
        self.apply = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Apply",
            request_serializer=pb.ApplyRequest.SerializeToString,
            response_deserializer=pb.ApplyResponse.FromString,
        )
        self.delete = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Delete",
            request_serializer=pb.DeleteRequest.SerializeToString,
            response_deserializer=pb.DeleteResponse.FromString,
        )
        self.apply_batch = self._channel.unary_unary(
            f"/{SERVICE_NAME}/ApplyBatch",
            request_serializer=bpb.ApplyBatchRequest.SerializeToString,
            response_deserializer=bpb.ApplyBatchResponse.FromString,
        )
        self.watch_batch = self._channel.unary_stream(
            f"/{SERVICE_NAME}/WatchBatch",
            request_serializer=pb.WatchRequest.SerializeToString,
            response_deserializer=bpb.EventFrame.FromString,
        )

    def unimplemented(self, exc: Exception) -> bool:
        """The server answered UNIMPLEMENTED: a negotiation answer (an old
        build without the batched protocol), not a wire failure."""
        return exc.code() == self._grpc.StatusCode.UNIMPLEMENTED

    def close(self) -> None:
        self._channel.close()


class ChannelClosed(Exception):
    """A call on a closed in-process channel (the wire's closed channel)."""


class InProcessChannel:
    """The replica's channel to a ``StoreBusCore`` in the same process: the
    same stubs as ``GrpcChannel``, over the records. Objects cross as
    canonical JSON both ways, so the mirror never shares an object with the
    primary. ``writes`` counts the write operations the channel carried to
    the primary (one per apply or delete, batched or not)."""

    messages = RECORDS

    def __init__(self, core: StoreBusCore, target: str = "in-process"):
        from ..utils.faultinject import FaultError

        self.core = core
        self.target = target
        self.writes = 0
        self._closed = threading.Event()
        # an injected bus.rpc fault is a FaultError: retried like a wire
        # failure, as the gRPC channel retries it as an RpcError
        self.wire_errors = (ChannelClosed, FaultError)

    def unimplemented(self, exc: Exception) -> bool:
        return False

    def _open(self) -> None:
        if self._closed.is_set():
            raise ChannelClosed(f"channel to {self.target} is closed")

    def _active(self) -> bool:
        return not self._closed.is_set()

    @staticmethod
    def _ctx(metadata):
        from ..utils.tracing import decode_trace_metadata

        return decode_trace_metadata(metadata)

    def watch(self, request: WatchRequest):
        self._open()
        return self.core.watch(request.kinds, request.replay, self._active)

    def watch_batch(self, request: WatchRequest):
        self._open()
        return self.core.watch_frames(request.kinds, request.replay, self._active)

    def apply(self, request: ApplyRequest, timeout=None, metadata=()):
        self._open()
        self.writes += 1
        return self.core.apply(request.kind, request.object_json, request.conditional,
                               request.expected_rv, self._ctx(metadata))

    def delete(self, request: DeleteRequest, timeout=None, metadata=()):
        self._open()
        self.writes += 1
        return self.core.delete(request.kind, request.key, request.force,
                                self._ctx(metadata))

    def apply_batch(self, request: ApplyBatchRequest, timeout=None, metadata=()):
        self._open()
        self.writes += len(request.ops)
        return ApplyBatchResponse(tuple(self.core.apply_batch(list(request.ops),
                                                              self._ctx(metadata))))

    def close(self) -> None:
        self._closed.set()


class StoreReplica:
    """Agent-side mirror: a local Store kept consistent by the bus stream;
    writes round-trip through the primary (never applied locally first —
    the echo from the stream is the commit signal, so the replica can never
    diverge from the primary's admission decisions).

    ``target`` is a bus server's ``host:port`` (a ``GrpcChannel``, with the
    TLS options) or a channel object (``InProcessChannel``)."""

    def __init__(
        self,
        target,
        *,
        kinds: tuple[str, ...] = (),
        root_ca: Optional[bytes] = None,
        client_cert: Optional[bytes] = None,
        client_key: Optional[bytes] = None,
        timeout_seconds: float = 10.0,
    ):
        if isinstance(target, str):
            channel = GrpcChannel(target, root_ca=root_ca, client_cert=client_cert,
                                  client_key=client_key)
        else:
            channel = target
        self._channel = channel
        self._target = channel.target
        self._msg = channel.messages
        self._wire_errors = channel.wire_errors
        self.store = Store()
        self.kinds = kinds
        self._watch = channel.watch
        self._apply = channel.apply
        self._delete = channel.delete
        self._apply_batch = channel.apply_batch
        self._watch_batch = channel.watch_batch
        # batched-protocol negotiation, one pin per surface: None until the
        # first call, False after an UNIMPLEMENTED answer (old server), True
        # after a batched success. A WIRE failure resets the pin to None so
        # the reconnected channel re-probes before reuse (the returning
        # server may be a different build).
        self.supports_batch: Optional[bool] = None
        self._watch_supports_batch: Optional[bool] = None
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: events the stream has applied to the mirror (replay duplicates
        #: included), and the highest resource version among them: both
        #: move only once an event's watch handlers have run
        self.events = 0
        self._seen_rv = 0
        self._seen = threading.Condition()
        # unified channel resilience (utils.backoff): write-through calls
        # carry ONE overall deadline budget with decorrelated-jitter
        # retries; consecutive transport failures open the breaker so a
        # dead bus fast-fails writers (backpressure — the worker queue
        # parks the key) instead of stacking full timeouts
        from ..utils.backoff import default_breaker, default_policy

        self.timeout = timeout_seconds
        # short reset window: a restarted bus must re-admit writers within
        # about a second
        self.breaker = default_breaker(f"bus@{self._target}", reset_default=1.0)
        self._policy = default_policy(attempt_timeout=timeout_seconds / 2, max_attempts=3)
        self._policy_once = default_policy(attempt_timeout=timeout_seconds, max_attempts=1)

    # -- replication -------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import random

        from ..utils.backoff import BackoffPolicy
        from ..utils.faultinject import apply_fault, fault_point

        # reconnect schedule: decorrelated jitter, capped LOW — the watch
        # stream is how an agent finds out about the whole world
        policy = BackoffPolicy(base=0.05, cap=0.5)
        rng = random.Random()
        sleeps = policy.sleeps(rng)
        while not self._stop.is_set():
            use_batch = bus_batch_max() > 0 and self._watch_supports_batch is not False
            try:
                apply_fault(fault_point("bus.watch", "Watch"), "bus.watch", "Watch")
                req = self._msg.WatchRequest(kinds=list(self.kinds), replay=True)
                if use_batch:
                    # frames drain WHOLE: every event of a frame applies
                    # before the loop returns to the wire, so a consumer
                    # settling the runtime sees the coalesced burst as one
                    # enqueue wave rather than N stream wakeups
                    for frame in self._watch_batch(req):
                        if self._stop.is_set():
                            return
                        self._watch_supports_batch = True
                        for ev in frame.events:
                            self._apply_event(ev)
                        if frame.bookmark:
                            self._synced.set()
                            sleeps = policy.sleeps(rng)
                else:
                    for ev in self._watch(req):
                        if self._stop.is_set():
                            return
                        if ev.type == "Bookmark":
                            # replay fully consumed: NOW synced; a healthy
                            # stream resets the reconnect schedule
                            self._synced.set()
                            sleeps = policy.sleeps(rng)
                            continue
                        self._apply_event(ev)
            except self._wire_errors as exc:
                if self._stop.is_set():
                    return
                if use_batch and self._channel.unimplemented(exc):
                    # old server: pin the unary fallback for this connection
                    # and retry at once (the server ANSWERED — no backoff)
                    self._watch_supports_batch = False
                    continue
                # wire failure: reset the negotiation pin so the reconnected
                # channel re-probes (the returning server may be a
                # different build)
                self._watch_supports_batch = None
                self._synced.clear()
                self._stop.wait(next(sleeps))

    def _apply_event(self, ev) -> None:
        self._mirror(ev)
        with self._seen:
            self.events += 1
            self._seen_rv = max(self._seen_rv, ev.resource_version)
            self._seen.notify_all()

    def _mirror(self, ev) -> None:
        if ev.type == "Deleted":
            self.store.delete(ev.kind, ev.key, force=True)
            return
        obj = decode_object(ev.kind, ev.object_json)
        current = self.store.get(ev.kind, ev.key)
        if current is not None and current.meta.resource_version >= ev.resource_version:
            return  # replay duplicate after reconnect
        # the replica mirrors the PRIMARY's resource versions so controllers
        # comparing rvs across restarts agree with the source of truth. The
        # local counter is aligned BEFORE apply so the watch event this
        # apply delivers already carries the primary rv (the stream thread
        # is the store's only writer)
        self.store.advance_rv(ev.resource_version)
        self.store.apply(obj)
        obj.meta.resource_version = ev.resource_version

    def wait_synced(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    def wait_rv(self, rv: int, timeout: float = 30.0) -> bool:
        """Wait until the stream has applied an event at resource version
        ``rv`` or later, its watch handlers included: a write's echo (the
        primary's ``store.rv`` after the write) has reached the mirror's
        controllers."""
        with self._seen:
            return self._seen.wait_for(lambda: self._seen_rv >= rv, timeout)

    # -- write-through -----------------------------------------------------

    def _resilient(self, method: str, stub, req, *, retry: bool = True):
        """One write-through call under the unified policy: overall deadline
        budget = ``self.timeout``, decorrelated-jitter retries on transport
        errors only (admission rejections come back in the response body
        and never retry), breaker fast-fail when the bus is down.
        ``retry=False`` is for conditional writes: retrying one after a
        commit-then-timeout would surface the caller's OWN committed write
        as a false ConflictError, so those get one bounded attempt."""
        from ..utils.backoff import Deadline, call_with_resilience
        from ..utils.faultinject import apply_fault, fault_point
        from ..utils.tracing import trace_metadata, tracer

        def attempt(timeout: float):
            # one client span per wire ATTEMPT (retries open fresh spans)
            with tracer.span("bus.rpc", remote=True, peer=self._target, method=method):
                md = trace_metadata(tracer.current_context())
                apply_fault(fault_point("bus.rpc", method), "bus.rpc", method)
                try:
                    return stub(req, timeout=timeout, metadata=md)
                except self._wire_errors:
                    # a wire failure on the UNARY path also resets the batch
                    # negotiation pin: a replica pinned to the unary fallback
                    # by an old server must re-probe after the reconnect
                    self.supports_batch = None
                    raise

        return call_with_resilience(
            attempt,
            channel="bus",
            policy=self._policy if retry else self._policy_once,
            breaker=self.breaker,
            deadline=Deadline(self.timeout),
            retryable=self._wire_errors,
        )

    _UNSUPPORTED = object()  # sentinel: server answered UNIMPLEMENTED

    def _resilient_batch(self, req, n_ops: int, *, retry: bool = True):
        """One ApplyBatch call under the unified policy: ONE Deadline budget
        for the whole batch, retries only when every op is an idempotent
        unconditional apply/delete. UNIMPLEMENTED is a NEGOTIATION answer,
        not a failure: the attempt returns the sentinel so the breaker
        records a healthy channel and the caller falls back."""
        from ..utils.backoff import Deadline, call_with_resilience
        from ..utils.faultinject import apply_fault, fault_point
        from ..utils.tracing import trace_metadata, tracer

        def attempt(timeout: float):
            # the client span carries the batch size
            with tracer.span("bus.rpc", remote=True, peer=self._target,
                             method="ApplyBatch", batch=n_ops):
                md = trace_metadata(tracer.current_context())
                # the injection point fires once per BATCH attempt (the
                # batch is the wire unit)
                apply_fault(fault_point("bus.rpc", "ApplyBatch"), "bus.rpc", "ApplyBatch")
                try:
                    return self._apply_batch(req, timeout=timeout, metadata=md)
                except self._wire_errors as exc:
                    if self._channel.unimplemented(exc):
                        self.supports_batch = False
                        return self._UNSUPPORTED
                    self.supports_batch = None  # wire failure: re-probe
                    raise

        return call_with_resilience(
            attempt,
            channel="bus",
            policy=self._policy if retry else self._policy_once,
            breaker=self.breaker,
            deadline=Deadline(self.timeout),
            retryable=self._wire_errors,
        )

    def _op_for(self, obj, expected_rv=None):
        return self._msg.BatchOp(
            kind=_kind_of(obj),
            object_json=encode_object(obj),
            conditional=expected_rv is not None,
            expected_rv=expected_rv or 0,
        )

    def apply_many(self, objs, *, expected_rvs=None) -> list:
        """Batched write-through: ships the whole write set as ApplyBatch
        calls of at most ``bus_batch_max()`` ops each. Returns ``[(obj,
        exc), ...]`` for per-object failures (the Store.apply_many contract
        — one rejected object must not void the batch). ``expected_rvs``
        (aligned with ``objs``, None entries unconditional) carries CAS
        preconditions; conflicts come back as ConflictError on exactly the
        conflicting object. Old servers negotiate the per-object unary
        fallback transparently.

        Unlike the in-proc ``Store.apply_many``, the primary's new
        resource_version is NOT stamped onto the caller's objects: the
        caller's object is often THE mirror object (facade writers mutate
        in place), and pre-stamping it would make ``_apply_event``'s replay
        dedup swallow the write's own echo — the commit signal every
        watching controller converges on."""
        objs = list(objs)
        if not objs:
            return []
        rvs = list(expected_rvs) if expected_rvs is not None else [None] * len(objs)
        batch_max = bus_batch_max()
        errors: list = []
        # index of the first object NOT yet committed batched: an
        # UNIMPLEMENTED answer mid-set must fall back for the REMAINDER
        # only — replaying committed chunks unary would duplicate writes
        pending_from = 0
        if batch_max > 0 and self.supports_batch is not False:
            i = 0
            while i < len(objs):
                # cut a batch on COUNT (the env knob) or accumulated
                # object-JSON BYTES
                chunk: list = []
                chunk_rvs: list = []
                ops: list = []
                nbytes = 0
                while i < len(objs) and len(ops) < batch_max and (
                        not ops or nbytes < BATCH_BYTE_BUDGET):
                    op = self._op_for(objs[i], rvs[i])
                    ops.append(op)
                    chunk.append(objs[i])
                    chunk_rvs.append(rvs[i])
                    nbytes += len(op.object_json)
                    i += 1
                resp = self._resilient_batch(
                    self._msg.ApplyBatchRequest(ops=ops), len(ops),
                    retry=all(rv is None for rv in chunk_rvs),
                )
                if resp is self._UNSUPPORTED:
                    break  # negotiated: the rest goes unary
                self.supports_batch = True
                pending_from = i
                for obj, res in zip(chunk, resp.results):
                    if res.error:
                        errors.append((obj, ConflictError(res.error) if res.conflict
                                       else RuntimeError(res.error)))
            else:
                return errors
        # unary fallback (old server or batching disabled by env) for the
        # not-yet-committed remainder
        for obj, rv in zip(objs[pending_from:], rvs[pending_from:]):
            try:
                self.apply(obj, expected_rv=rv)
            except Exception as exc:  # noqa: BLE001 — per-object verdict
                errors.append((obj, exc))
        return errors

    def delete_many(self, keys) -> list:
        """Batched deletes: ``keys`` is an iterable of (kind, key) or
        (kind, key, force) tuples; returns per-key failures as
        ``[((kind, key), exc), ...]``."""
        keys = [k if len(k) == 3 else (k[0], k[1], False) for k in keys]
        if not keys:
            return []
        batch_max = bus_batch_max()
        errors: list = []
        pending_from = 0  # first key not yet committed batched
        if batch_max > 0 and self.supports_batch is not False:
            for start in range(0, len(keys), batch_max):
                chunk = keys[start:start + batch_max]
                req = self._msg.ApplyBatchRequest(ops=[
                    self._msg.BatchOp(kind=kind, key=key, delete=True, force=force)
                    for kind, key, force in chunk
                ])
                resp = self._resilient_batch(req, len(chunk))
                if resp is self._UNSUPPORTED:
                    break  # negotiated: the rest goes unary
                self.supports_batch = True
                pending_from = start + len(chunk)
                for (kind, key, _f), res in zip(chunk, resp.results):
                    if res.error:
                        errors.append(((kind, key), RuntimeError(res.error)))
            else:
                return errors
        for kind, key, force in keys[pending_from:]:
            try:
                self.delete(kind, key, force=force)
            except Exception as exc:  # noqa: BLE001
                errors.append(((kind, key), exc))
        return errors

    def apply(self, obj, *, expected_rv=None) -> int:
        resp = self._resilient(
            "Apply",
            self._apply,
            self._msg.ApplyRequest(
                kind=_kind_of(obj),
                object_json=encode_object(obj),
                conditional=expected_rv is not None,
                expected_rv=expected_rv or 0,
            ),
            retry=expected_rv is None,
        )
        if resp.error:
            if resp.conflict:
                raise ConflictError(resp.error)
            raise RuntimeError(resp.error)
        return resp.resource_version

    def delete(self, kind: str, key: str, force: bool = False) -> bool:
        resp = self._resilient(
            "Delete", self._delete, self._msg.DeleteRequest(kind=kind, key=key, force=force)
        )
        if resp.error:
            raise RuntimeError(resp.error)
        return resp.deleted

    def close(self) -> None:
        self._stop.set()
        self._channel.close()
        if self._thread is not None:
            self._thread.join(timeout=2)
