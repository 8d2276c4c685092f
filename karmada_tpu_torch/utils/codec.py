"""Typed dataclass <-> JSON-able codec for API objects.

The port's own copy of ``karmada_tpu/utils/codec.py``. ``to_jsonable``
flattens dataclasses into plain dict/list/scalar trees; ``from_jsonable``
rebuilds them from the declared field types (handles Optional, list[...],
dict[...], tuple[...], and nested dataclasses). Unknown keys are ignored on
decode (forward compatibility, the CRD contract); missing keys fall back to
field defaults. The binding controller stores a template-delta Work's
manifest in this form (``WorkloadTemplate.manifest``), and the store bus
carries every object as its canonical JSON. The rules are the JAX module's;
the port resolves them once per type (each dataclass's field names, and a
decoder per declared type) instead of on every call, since a bus mirror
decodes every event it applies.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Union, get_args, get_origin, get_type_hints

_HINTS_CACHE: dict[type, dict[str, Any]] = {}
#: dataclass -> its field names in declaration order (``to_jsonable``)
_FIELD_NAMES: dict[type, tuple] = {}
#: dataclass -> {field name: decoder of its declared type} (``from_jsonable``)
_FIELD_DECODERS: dict[type, dict[str, Any]] = {}
#: declared type -> decoder (``_decoder``)
_DECODERS: dict[Any, Any] = {}


#: types ``to_jsonable`` returns as they are
_LEAVES = frozenset((str, int, float, bool, type(None)))


def to_jsonable(obj: Any) -> Any:
    tp = type(obj)
    if tp in _LEAVES:
        return obj
    names = _FIELD_NAMES.get(tp)
    if names is None:
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            names = _FIELD_NAMES[tp] = tuple(f.name for f in dataclasses.fields(obj))
        elif isinstance(obj, dict):
            return {k: v if type(v) in _LEAVES else to_jsonable(v) for k, v in obj.items()}
        elif isinstance(obj, (list, tuple)):
            return [v if type(v) in _LEAVES else to_jsonable(v) for v in obj]
        else:
            return obj
    out = {}
    for name in names:
        v = getattr(obj, name)
        out[name] = v if type(v) in _LEAVES else to_jsonable(v)
    return out


def _hints(cls: type) -> dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    return hints


def _identity(value: Any) -> Any:
    return value


def _decoder(tp: Any):
    """The decoder of declared type ``tp``, built once per type: a function
    of a non-None jsonable value (``_decode``'s rules, resolved ahead)."""
    try:
        fn = _DECODERS.get(tp)
    except TypeError:  # an unhashable annotation: resolve it every time
        return _build_decoder(tp)
    if fn is None:
        fn = _DECODERS[tp] = _build_decoder(tp)
    return fn


def _build_decoder(tp: Any):
    origin = get_origin(tp)
    if origin is Union:  # Optional[X] and unions: first matching arm wins
        arms = [arm for arm in get_args(tp) if arm is not type(None)]

        def union(value):
            for arm in arms:
                try:
                    return _decode(value, arm)
                except (TypeError, ValueError, KeyError):
                    continue
            return value

        return union
    if origin in (list, tuple):
        args = get_args(tp)
        elem = args[0] if args else Any
        if origin is tuple:
            return lambda value: tuple([_decode(v, elem) for v in value])
        return lambda value: [_decode(v, elem) for v in value]
    if origin is dict:
        args = get_args(tp)
        vt = args[1] if len(args) == 2 else Any
        return lambda value: {k: _decode(v, vt) for k, v in value.items()}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return lambda value: from_jsonable(tp, value)
    return _identity


def _decode(value: Any, tp: Any) -> Any:
    if value is None:
        return None
    return _decoder(tp)(value)


def from_jsonable(cls: type, data: Optional[dict]) -> Any:
    """Rebuild dataclass ``cls`` from a jsonable dict (None passes through)."""
    if data is None:
        return None
    decoders = _FIELD_DECODERS.get(cls)
    if decoders is None:
        hints = _hints(cls)
        decoders = _FIELD_DECODERS[cls] = {
            f.name: _decoder(hints.get(f.name, Any)) for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        dec = decoders.get(key)
        if dec is None:
            continue  # forward compatibility: unknown fields are dropped
        kwargs[key] = value if value is None or dec is _identity else dec(value)
    return cls(**kwargs)
