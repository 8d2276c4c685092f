"""Shared API machinery: object metadata, conditions, resource references.

The port's own copy of ``karmada_tpu.api.core``. The reference builds on k8s
apimachinery; here the contract is plain typed records. Ref:
pkg/apis/work/v1alpha2/binding_types.go (ObjectReference),
metav1.ObjectMeta / metav1.Condition semantics.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    uid: str = ""
    generation: int = 1
    resource_version: int = 0
    finalizers: list[str] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    creation_timestamp: float = 0.0

    @property
    def namespaced_name(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Condition:
    """Mirrors metav1.Condition."""

    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time)


def set_condition(conditions: list[Condition], new: Condition) -> bool:
    """Upsert by type; returns True if status changed (transition)."""
    for i, c in enumerate(conditions):
        if c.type == new.type:
            if c.status == new.status:
                # refresh reason/message but keep transition time
                new.last_transition_time = c.last_transition_time
                conditions[i] = new
                return False
            conditions[i] = new
            return True
    conditions.append(new)
    return True


def get_condition(conditions: list[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def is_condition_true(conditions: list[Condition], ctype: str) -> bool:
    c = get_condition(conditions, ctype)
    return c is not None and c.status


@dataclass
class ObjectReference:
    """Reference to a resource template.

    Ref: pkg/apis/work/v1alpha2/binding_types.go:150-176 (ObjectReference).
    """

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    resource_version: str = ""

    @property
    def gvk(self) -> str:
        return f"{self.api_version}/{self.kind}"

    @property
    def namespaced_key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Resource:
    """A plain (unstructured) resource template, kube-style; ``spec`` and
    ``status`` are free-form dicts."""

    api_version: str = "apps/v1"
    kind: str = "Deployment"
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: dict[str, Any] = field(default_factory=dict)
    status: dict[str, Any] = field(default_factory=dict)

    def object_reference(self) -> ObjectReference:
        return ObjectReference(
            api_version=self.api_version,
            kind=self.kind,
            namespace=self.meta.namespace,
            name=self.meta.name,
            uid=self.meta.uid,
        )
