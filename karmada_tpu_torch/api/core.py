"""Shared API machinery: object metadata and conditions.

The scheduler-facing subset of ``karmada_tpu.api.core``, kept as the
port's own copy. The reference builds on k8s apimachinery; here the
contract is plain typed records (metav1.ObjectMeta / metav1.Condition
semantics).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


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
