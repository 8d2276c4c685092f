"""Shared utilities: quantities, the feature gate, object builders, reason
codes, the wave tracer (``tracing``) and the provenance store
(``explainstore``)."""

from .quantity import (  # noqa: F401
    CPU,
    MEMORY,
    PODS,
    parse_quantity,
    parse_resource_list,
)
