"""Byte-identical copies of the JAX package's estimator wire contract
(``estimator.proto``, ``estimator_batch.proto`` and their generated
messages). Protobuf's default pool accepts one file registered twice only
when its serialized bytes are identical, so both packages' messages import
into one process and share one descriptor; keep the copies byte for byte."""

from . import estimator_batch_pb2, estimator_pb2  # noqa: F401
