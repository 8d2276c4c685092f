"""A copy of the JAX package's store-bus wire contract (``storebus.proto``,
``storebus_batch.proto`` and their ``_pb2`` modules): protobuf's default
pool accepts one file registered twice only when its serialized descriptors
are identical, so both packages' messages import into one process; keep
the ``.proto`` files and the descriptors the ``_pb2`` modules build byte
for byte the JAX package's."""

from . import storebus_pb2  # noqa: F401
