"""Resource quantity parsing and canonical units.

The reference uses k8s ``resource.Quantity`` everywhere. We canonicalize every
resource into a plain ``int`` in a fixed per-resource unit so that capacity
math is exact integer arithmetic (and packs into int32/int64 tensors):

- ``cpu``  -> millicores ("1" == 1000, "250m" == 250)
- ``memory``/storage-like -> bytes ("1Gi" == 2**30)
- everything else (``pods``, extended resources) -> absolute count

Division semantics mirror the reference estimator (integer floor division,
cpu compared in milli, others in absolute value):
pkg/estimator/client/general.go:156-196.
"""

from __future__ import annotations

import re
from typing import Mapping

# Binary (Ki/Mi/...) and decimal (k/M/...) suffix multipliers.
_BIN = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "": 1.0, "k": 1e3, "M": 1e6, "G": 1e9,
        "T": 1e12, "P": 1e15, "E": 1e18}

# sign + digits + optional exponent ("1e9", "100e-3" are legal Quantity
# serializations), then an optional unit suffix. A bare trailing E is the
# decimal exa suffix; E followed by digits is an exponent (k8s semantics).
_QTY_RE = re.compile(r"^\s*([+-]?[0-9.]+(?:[eE][-+]?[0-9]+)?)\s*([A-Za-z]*)\s*$")

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"


def parse_quantity(value: "int | float | str", resource: str = "") -> int:
    """Parse a quantity into its canonical integer unit.

    ``resource`` selects the canonical unit (cpu -> milli). Numbers are taken
    to be in the resource's natural unit (cores for cpu, bytes for memory).
    """
    if isinstance(value, bool):  # bool is an int subclass; reject explicitly
        raise TypeError(f"invalid quantity: {value!r}")
    if isinstance(value, (int, float)):
        base = float(value)
    else:
        m = _QTY_RE.match(value)
        if not m:
            raise ValueError(f"invalid quantity: {value!r}")
        num, suffix = m.groups()
        if suffix in _BIN:
            base = float(num) * _BIN[suffix]
        elif suffix in _DEC:
            base = float(num) * _DEC[suffix]
        else:
            raise ValueError(f"invalid quantity suffix: {value!r}")
    if resource == CPU:
        return int(round(base * 1000))
    return int(round(base))


def parse_resource_list(resources: Mapping[str, "int | float | str"]) -> dict[str, int]:
    """Canonicalize a resource map, e.g. {"cpu": "250m", "memory": "1Gi"}."""
    return {name: parse_quantity(v, name) for name, v in resources.items()}
