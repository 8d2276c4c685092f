"""Autoscaling API: FederatedHPA and CronFederatedHPA.

The port's own copy of ``karmada_tpu/api/autoscaling.py``.

Ref: pkg/apis/autoscaling/v1alpha1 — FederatedHPA (scale target + min/max +
metrics, HPA-shaped) and CronFederatedHPA (cron rules scaling a FederatedHPA
or a workload directly).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .core import ObjectMeta


@dataclass
class ScaleTargetRef:
    api_version: str = "apps/v1"
    kind: str = "Deployment"
    name: str = ""


@dataclass
class MetricSpec:
    """HPA metric source (autoscaling/v2 MetricSpec).

    - type "Resource": resource utilization vs request, merged by the
      metrics adapter's resource flavor (target_average_utilization in
      percent, or target_average_value in canonical units per pod);
    - type "Pods": a custom per-pod metric (custom.metrics.k8s.io) named by
      metric_name, optionally filtered by metric_selector, compared against
      target_average_value per pod;
    - type "Object": a metric describing a single cluster object
      (described_object), compared against target_value (Value) or
      target_average_value (AverageValue per pod) —
      federatedhpa_controller.go computeStatusForObjectMetric;
    - type "External": an external series (external.metrics.k8s.io) named
      by metric_name + metric_selector, compared against target_value
      (total) or target_average_value (per pod)."""

    type: str = "Resource"  # Resource | Pods | Object | External
    resource_name: str = "cpu"
    target_average_utilization: Optional[int] = None
    target_average_value: Optional[float] = None
    metric_name: str = ""
    metric_selector: Optional[dict] = None  # label selector (match_labels)
    target_value: Optional[float] = None
    described_object: Optional[ScaleTargetRef] = None  # Object flavor


@dataclass
class FederatedHPASpec:
    scale_target_ref: ScaleTargetRef = field(default_factory=ScaleTargetRef)
    min_replicas: int = 1
    max_replicas: int = 10
    metrics: list[MetricSpec] = field(default_factory=list)
    # scale-down stabilization (behavior.scaleDown.stabilizationWindowSeconds)
    stabilization_window_seconds: int = 300


@dataclass
class FederatedHPAStatus:
    current_replicas: int = 0
    desired_replicas: int = 0
    last_scale_time: Optional[float] = None


@dataclass
class FederatedHPA:
    KIND = "FederatedHPA"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: FederatedHPASpec = field(default_factory=FederatedHPASpec)
    status: FederatedHPAStatus = field(default_factory=FederatedHPAStatus)


@dataclass
class CronFederatedHPARule:
    name: str = ""
    schedule: str = "* * * * *"  # 5-field cron
    target_replicas: Optional[int] = None
    target_min_replicas: Optional[int] = None
    target_max_replicas: Optional[int] = None
    suspend: bool = False


@dataclass
class CronFederatedHPASpec:
    scale_target_ref: ScaleTargetRef = field(default_factory=ScaleTargetRef)
    rules: list[CronFederatedHPARule] = field(default_factory=list)


@dataclass
class ExecutionHistoryItem:
    rule_name: str = ""
    execution_time: float = 0.0
    applied_replicas: Optional[int] = None
    message: str = ""


@dataclass
class CronFederatedHPAStatus:
    execution_histories: list[ExecutionHistoryItem] = field(default_factory=list)


@dataclass
class CronFederatedHPA:
    KIND = "CronFederatedHPA"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CronFederatedHPASpec = field(default_factory=CronFederatedHPASpec)
    status: CronFederatedHPAStatus = field(default_factory=CronFederatedHPAStatus)
