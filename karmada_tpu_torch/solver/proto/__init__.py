"""Byte-identical copy of the JAX package's solver wire contract
(``solver.proto`` and ``solver_pb2.py``): protobuf's default pool accepts
one file registered twice only when its serialized bytes are identical, so
both packages' messages import into one process; keep the copy byte for
byte."""

from . import solver_pb2  # noqa: F401
