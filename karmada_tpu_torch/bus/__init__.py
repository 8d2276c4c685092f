"""Networked store watch bus (watch/apply surface over gRPC or an in-process
channel, and the agent's replica)."""

from .service import (  # noqa: F401
    InProcessChannel,
    StoreBusCore,
    StoreBusServer,
    StoreReplica,
    decode_object,
    encode_object,
    kind_registry,
)
