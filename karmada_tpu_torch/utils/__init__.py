"""Shared utilities: quantities, the feature gate, object builders, reason
codes, the wave tracer (``tracing``), the provenance store
(``explainstore``), the metric registry (``metrics``), the control plane's
object store (``store``) and cooperative worker runtime (``worker``), the
member-cluster clients (``member``), and the manifest clone and JSON codec
of the propagation path (``clone``, ``codec``)."""

from .quantity import (  # noqa: F401
    CPU,
    MEMORY,
    PODS,
    parse_quantity,
    parse_resource_list,
)
from .store import ADDED, DELETED, MODIFIED, Event, Store, obj_key, obj_kind  # noqa: F401
from .worker import DONE, REQUEUE, Runtime, Worker  # noqa: F401
