"""Work API: the replica requirements an estimator answers for.

The port's own copy of the estimator-facing subset of
``karmada_tpu.api.work`` (``NodeClaim``, ``ReplicaRequirements``).

Ref: pkg/apis/work/v1alpha2/binding_types.go — ReplicaRequirements (:193)
and NodeClaim.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class NodeClaim:
    """Node-level scheduling claim carried with replica requirements.
    Ref: binding_types.go NodeClaim (nodeSelector/tolerations/hard node
    affinity)."""

    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Any] = field(default_factory=list)
    hard_node_affinity: Optional[dict] = None


@dataclass
class ReplicaRequirements:
    """Per-replica requirements (canonical int units).
    Ref: binding_types.go:193-213."""

    resource_request: dict[str, int] = field(default_factory=dict)
    node_claim: Optional[NodeClaim] = None
    namespace: str = ""
    priority_class_name: str = ""
