"""Fast structural clones for the propagation hot path (the port's own copy
of ``karmada_tpu/utils/clone.py``).

The control plane copies workload manifests constantly — template -> Work,
revise-replica, override application, Retain merges, member applies — and
``copy.deepcopy`` was >60% of a 2000-binding propagation storm's wall time
(its per-node memo bookkeeping and reflective dispatch dominate for the
JSON-shaped trees API objects actually are; the reference pays the same
shape of cost in runtime.DeepCopyObject but with generated per-type
copiers, apimachinery codegen). These helpers are the generated-copier
analogue: type-dispatched, memo-free tree copies that fall back to
``copy.deepcopy`` for anything unexpected (aliased graphs are impossible in
manifests parsed from JSON-style input).
"""

from __future__ import annotations

import copy
from dataclasses import replace
from typing import Any

_SCALARS = (str, int, float, bool, type(None))


def clone_json(x: Any) -> Any:
    """Copy a JSON-shaped tree (dict/list/tuple/scalars); deepcopy
    fallback for anything else."""
    tp = type(x)
    if tp in _SCALARS:
        return x
    if tp is dict:
        return {k: clone_json(v) for k, v in x.items()}
    if tp is list:
        return [clone_json(v) for v in x]
    if tp is tuple:
        return tuple(clone_json(v) for v in x)
    return copy.deepcopy(x)


def clone_meta(meta):
    """Copy an ObjectMeta (flat fields + label/annotation dicts)."""
    return replace(
        meta,
        labels=dict(meta.labels),
        annotations=dict(meta.annotations),
        finalizers=list(meta.finalizers),
    )


def clone_resource(obj):
    """Copy a Resource (unstructured manifest): fresh meta + spec/status
    trees. The workhorse of the Work build / override / retain chain."""
    return replace(
        obj,
        meta=clone_meta(obj.meta),
        spec=clone_json(obj.spec),
        status=clone_json(obj.status),
    )
