"""Typed dataclass <-> JSON-able codec for API objects.

The port's own copy of ``karmada_tpu/utils/codec.py``. ``to_jsonable``
flattens dataclasses into plain dict/list/scalar trees; ``from_jsonable``
rebuilds them from the declared field types (handles Optional, list[...],
dict[...], tuple[...], and nested dataclasses). Unknown keys are ignored on
decode (forward compatibility, the CRD contract); missing keys fall back to
field defaults. The binding controller stores a template-delta Work's
manifest in this form (``WorkloadTemplate.manifest``).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Union, get_args, get_origin, get_type_hints

_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = to_jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    return obj


def _hints(cls: type) -> dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    return hints


def _decode(value: Any, tp: Any) -> Any:
    if value is None:
        return None
    origin = get_origin(tp)
    if origin is Union:  # Optional[X] and unions: first matching arm wins
        for arm in get_args(tp):
            if arm is type(None):
                continue
            try:
                return _decode(value, arm)
            except (TypeError, ValueError, KeyError):
                continue
        return value
    if origin in (list, tuple):
        args = get_args(tp)
        elem = args[0] if args else Any
        seq = [_decode(v, elem) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        args = get_args(tp)
        vt = args[1] if len(args) == 2 else Any
        return {k: _decode(v, vt) for k, v in value.items()}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return from_jsonable(tp, value)
    return value


def from_jsonable(cls: type, data: Optional[dict]) -> Any:
    """Rebuild dataclass ``cls`` from a jsonable dict (None passes through)."""
    if data is None:
        return None
    hints = _hints(cls)
    kwargs = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in names:
            continue  # forward compatibility: unknown fields are dropped
        kwargs[key] = _decode(value, hints.get(key, Any))
    return cls(**kwargs)
