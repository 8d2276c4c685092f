"""Messages for storebus_batch.proto, built without protoc.

grpc_tools/protoc are not in the image (see estimator_batch_pb2.py for the
precedent), so the FileDescriptorProto is constructed programmatically and
registered in the default pool — byte-for-byte the wire format protoc
would emit for karmada_tpu/bus/proto/storebus_batch.proto, which remains
the human-readable contract. KEEP THE TWO IN SYNC.

The columnar bus protocol: ``ApplyBatch`` carries many
write-through operations per RPC (per-op resourceVersion/CAS results
back), and ``WatchBatch`` streams ``EventFrame`` messages — coalesced
watch events flushed by count or a few-ms timer — instead of one gRPC
message per event. Both are negotiated per connection exactly like the
estimator batch protocol: old servers answer UNIMPLEMENTED and the client
pins the unary fallback until the channel reconnects.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_PKG = "karmada_tpu.bus"
_FILE = "karmada_tpu/bus/proto/storebus_batch.proto"

_F = descriptor_pb2.FieldDescriptorProto


def _message(fdp, name: str, *fields):
    msg = fdp.message_type.add()
    msg.name = name
    for number, fname, ftype, repeated in fields:
        f = msg.field.add()
        f.name = fname
        f.number = number
        f.label = _F.LABEL_REPEATED if repeated else _F.LABEL_OPTIONAL
        if isinstance(ftype, str):  # message-typed field
            f.type = _F.TYPE_MESSAGE
            f.type_name = f".{_PKG}.{ftype}"
        else:
            f.type = ftype
    return msg


def _build() -> "descriptor_pool.DescriptorPool":
    pool = descriptor_pool.Default()
    try:  # already registered (re-import through a second path)
        pool.FindFileByName(_FILE)
        return pool
    except KeyError:
        pass
    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = _FILE
    fdp.package = _PKG
    fdp.syntax = "proto3"
    # one write-through operation: an apply (optionally CAS-conditional)
    # or, with delete=true, a delete of (kind, key). A batch MUST NOT
    # carry two ops for the same (kind, key): per-op results are keyed by
    # position and the server does not define cross-op ordering within
    # one batch (producers flush deduplicated write sets).
    _message(
        fdp, "BatchOp",
        (1, "kind", _F.TYPE_STRING, False),
        (2, "object_json", _F.TYPE_STRING, False),
        (3, "conditional", _F.TYPE_BOOL, False),
        (4, "expected_rv", _F.TYPE_UINT64, False),
        (5, "delete", _F.TYPE_BOOL, False),
        (6, "key", _F.TYPE_STRING, False),
        (7, "force", _F.TYPE_BOOL, False),
    )
    _message(
        fdp, "ApplyBatchRequest",
        (1, "ops", "BatchOp", True),
    )
    # positionally aligned with the request ops; CAS losers come back as
    # conflict=true on exactly the conflicting op (the rest of the batch
    # commits — the reference's controller writebacks are independent
    # per-object patches)
    _message(
        fdp, "BatchResult",
        (1, "resource_version", _F.TYPE_UINT64, False),
        (2, "error", _F.TYPE_STRING, False),
        (3, "conflict", _F.TYPE_BOOL, False),
        (4, "deleted", _F.TYPE_BOOL, False),
    )
    _message(
        fdp, "ApplyBatchResponse",
        (1, "results", "BatchResult", True),
    )
    # one coalesced watch frame: same fields as storebus.proto Event,
    # self-contained so the batch file has no cross-file descriptor
    # dependency. bookmark=true marks the replay boundary (the frame may
    # carry the tail of the replay in the same message).
    _message(
        fdp, "FrameEvent",
        (1, "type", _F.TYPE_STRING, False),
        (2, "kind", _F.TYPE_STRING, False),
        (3, "key", _F.TYPE_STRING, False),
        (4, "resource_version", _F.TYPE_UINT64, False),
        (5, "object_json", _F.TYPE_STRING, False),
    )
    _message(
        fdp, "EventFrame",
        (1, "events", "FrameEvent", True),
        (2, "bookmark", _F.TYPE_BOOL, False),
    )
    pool.Add(fdp)
    return pool


def _cls(pool, name: str):
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"{_PKG}.{name}")
    )


_pool = _build()

BatchOp = _cls(_pool, "BatchOp")
ApplyBatchRequest = _cls(_pool, "ApplyBatchRequest")
BatchResult = _cls(_pool, "BatchResult")
ApplyBatchResponse = _cls(_pool, "ApplyBatchResponse")
FrameEvent = _cls(_pool, "FrameEvent")
EventFrame = _cls(_pool, "EventFrame")
