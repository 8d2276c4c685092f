"""Constants of the reference's replica-division semantics.

The port keeps only the constants of ``karmada_tpu/refimpl/divider.py`` (the
pure-Python oracle stays in the JAX package, which the tests use as the
referent). Strategy identifiers follow assignment.go:40-50; the integer codes
are shared with ``karmada_tpu_torch.ops.divide``.
"""

from __future__ import annotations

MAX_INT32 = 2**31 - 1

DUPLICATED = 0
STATIC_WEIGHT = 1
DYNAMIC_WEIGHT = 2
AGGREGATED = 3

STRATEGY_NAMES = {
    DUPLICATED: "Duplicated",
    STATIC_WEIGHT: "StaticWeight",
    DYNAMIC_WEIGHT: "DynamicWeight",
    AGGREGATED: "Aggregated",
}

