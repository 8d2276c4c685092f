"""Messages for estimator_batch.proto, built without protoc.

grpc_tools/protoc are not in the image (see estimator.proto's regen note),
and unlike the seed messages these did not ship with a pre-generated
module, so the FileDescriptorProto is constructed programmatically and
registered in the default pool — byte-for-byte the wire format protoc
would emit for karmada_tpu/estimator/proto/estimator_batch.proto, which
remains the human-readable contract. KEEP THE TWO IN SYNC.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_PKG = "karmada_tpu.estimator"
_FILE = "karmada_tpu/estimator/proto/estimator_batch.proto"

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
    _message(fdp, "Int64Row", (1, "values", _F.TYPE_INT64, True))
    _message(
        fdp, "MaxAvailableReplicasBatchRequest",
        (1, "clusters", _F.TYPE_STRING, True),
        (2, "dims", _F.TYPE_STRING, True),
        (3, "rows", "Int64Row", True),
        # one namespace per row (quota-plugin parity with the unary
        # path); proto3 repeated fields are backward/forward compatible —
        # empty on old clients, ignored by old servers
        (4, "namespaces", _F.TYPE_STRING, True),
    )
    _message(
        fdp, "ClusterBatchResult",
        (1, "cluster", _F.TYPE_STRING, False),
        (2, "max_replicas", _F.TYPE_INT32, True),
        (3, "generation", _F.TYPE_INT64, False),
    )
    _message(
        fdp, "MaxAvailableReplicasBatchResponse",
        (1, "results", "ClusterBatchResult", True),
    )
    _message(
        fdp, "GetGenerationsRequest",
        (1, "clusters", _F.TYPE_STRING, True),
    )
    _message(
        fdp, "GenerationEntry",
        (1, "cluster", _F.TYPE_STRING, False),
        (2, "generation", _F.TYPE_INT64, False),
    )
    _message(
        fdp, "GetGenerationsResponse",
        (1, "generations", "GenerationEntry", True),
    )
    pool.Add(fdp)
    return pool


def _cls(pool, name: str):
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"{_PKG}.{name}")
    )


_pool = _build()

Int64Row = _cls(_pool, "Int64Row")
MaxAvailableReplicasBatchRequest = _cls(
    _pool, "MaxAvailableReplicasBatchRequest"
)
ClusterBatchResult = _cls(_pool, "ClusterBatchResult")
MaxAvailableReplicasBatchResponse = _cls(
    _pool, "MaxAvailableReplicasBatchResponse"
)
GetGenerationsRequest = _cls(_pool, "GetGenerationsRequest")
GenerationEntry = _cls(_pool, "GenerationEntry")
GetGenerationsResponse = _cls(_pool, "GetGenerationsResponse")
