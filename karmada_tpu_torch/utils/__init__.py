"""Shared utilities: quantities, the feature gate, object builders."""

from .quantity import (  # noqa: F401
    CPU,
    MEMORY,
    PODS,
    parse_quantity,
    parse_resource_list,
)
