"""Pod-level replica calculator for FederatedHPA.

The port's own copy of ``karmada_tpu/controllers/replica_calculator.py``.

The kube HPA replica calculator re-derived over the federation's merged pod
list, with karmada's calibration twist (results determined by global ready
pods or metrics are divided by ``calibration`` = materialized replicas /
template replicas).

Ref (semantics re-derived, structure redesigned for the store-native plane):
- pkg/controllers/federatedhpa/replica_calculator.go:62-314 (the five
  calculators + usage-ratio count), :316-378 (groupPods / pod requests)
- pkg/controllers/federatedhpa/metrics/utilization.go:26-66 (ratio helpers)
- pkg/controllers/federatedhpa/federatedhpa_controller.go:601 (calibration)

The pod model is a flat ``PodSample`` per federated pod instead of
corev1.Pod + a separate PodMetricsInfo map: one record carries phase,
readiness ages, the resource request, and the (optional) metric sample.
Timestamps are modeled as ages-relative-to-now so tests and controllers
need no wall-clock fixtures.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_TOLERANCE = 0.1
DEFAULT_CPU_INITIALIZATION_PERIOD = 300.0  # --horizontal-pod-autoscaler-*
DEFAULT_INITIAL_READINESS_DELAY = 30.0


class MetricsError(ValueError):
    """Raised where the reference calculator returns an error (no pods, no
    ready metrics, missing requests, disjoint request/metric sets)."""


@dataclass
class PodSample:
    """One pod of the federated pod list (pods + its metric sample).

    ``value`` is the metric sample in milli-units (None = the metrics
    source returned nothing for this pod — the reference's missingPods).
    Ages are seconds relative to "now":
    - start_age: since pod start (None = no startTime recorded, which the
      reference treats as CPU-unready);
    - transition_age: since the Ready condition last transitioned (None =
      no Ready condition recorded — also CPU-unready);
    - sample_age: age of the metric sample; with ``window`` it models the
      reference's metric.Timestamp/metric.Window staleness check.
    Defaults describe a healthy long-running pod so member clusters can
    publish minimal samples.
    """

    name: str
    cluster: str = ""
    phase: str = "Running"  # Running | Pending | Failed | Succeeded
    ready: bool = True
    deleted: bool = False  # deletionTimestamp set
    request: Optional[int] = None  # resource request, milli-units
    value: Optional[int] = None  # metric sample, milli-units
    start_age: Optional[float] = 1e9
    transition_age: Optional[float] = 1e9
    sample_age: float = 0.0
    window: float = 60.0  # metric sample window (metricServerDefault)


@dataclass
class GroupedPods:
    ready_count: int = 0
    unready: set = field(default_factory=set)
    missing: set = field(default_factory=set)
    ignored: set = field(default_factory=set)


def group_pods(
    pods: list[PodSample],
    metrics: dict[str, int],
    resource: str,
    cpu_initialization_period: float,
    delay_of_initial_readiness: float,
) -> GroupedPods:
    """replica_calculator.go:316-360 groupPods. Failed/deleted pods are
    ignored, Pending pods are unready, pods without a metric sample are
    missing, and — for CPU only — pods whose sample predates readiness
    (still initialising, or never-ready within the initial delay) are
    unready."""
    g = GroupedPods()
    for pod in pods:
        if pod.deleted or pod.phase == "Failed":
            g.ignored.add(pod.name)
            continue
        if pod.phase == "Pending":
            g.unready.add(pod.name)
            continue
        if pod.name not in metrics:
            g.missing.add(pod.name)
            continue
        if resource == "cpu":
            if pod.transition_age is None or pod.start_age is None:
                g.unready.add(pod.name)
                continue
            if pod.start_age < cpu_initialization_period:
                # within the initialisation period: drop the sample if the
                # pod is unready or the sample predates one full metric
                # window after the last readiness transition
                # (metric.Timestamp < lastTransition + window  <=>
                #  sample_age > transition_age - window)
                unready = (
                    not pod.ready
                    or pod.sample_age > pod.transition_age - pod.window
                )
            else:
                # past initialisation: ignore only pods that are unready
                # and have never been ready (the transition happened within
                # the initial-readiness delay of pod start:
                # start + delay > lastTransition)
                unready = not pod.ready and (
                    pod.start_age - pod.transition_age
                    < delay_of_initial_readiness
                )
            if unready:
                g.unready.add(pod.name)
                continue
        g.ready_count += 1
    return g


def calculate_pod_requests(
    pods: list[PodSample], resource: str
) -> dict[str, int]:
    """replica_calculator.go:362-378 — every pod must carry a request for
    the scaled resource."""
    requests: dict[str, int] = {}
    for pod in pods:
        if pod.request is None:
            raise MetricsError(
                f"missing request for {resource} in Pod {pod.name}"
            )
        requests[pod.name] = pod.request
    return requests


def resource_utilization_ratio(
    metrics: dict[str, int],
    requests: dict[str, int],
    target_utilization: int,
) -> tuple[float, int, int]:
    """utilization.go:26-52 GetResourceUtilizationRatio ->
    (usage_ratio, current_utilization_pct, raw_average_value). Metrics
    without a matching request are treated as extraneous and skipped."""
    metrics_total = requests_total = entries = 0
    for name, value in metrics.items():
        if name not in requests:
            continue
        metrics_total += value
        requests_total += requests[name]
        entries += 1
    if requests_total == 0:
        raise MetricsError("no metrics returned matched known pods")
    current_utilization = (metrics_total * 100) // requests_total
    return (
        current_utilization / target_utilization,
        current_utilization,
        metrics_total // entries,
    )


def metric_usage_ratio(
    metrics: dict[str, int], target_usage: int
) -> tuple[float, int]:
    """utilization.go:54-66 GetMetricUsageRatio -> (ratio, avg_usage)."""
    current_usage = sum(metrics.values()) // len(metrics)
    return current_usage / target_usage, current_usage


class ReplicaCalculator:
    """replica_calculator.go:41-56 — tolerance dead-band + CPU readiness
    windows, shared by every metric flavor."""

    def __init__(
        self,
        tolerance: float = DEFAULT_TOLERANCE,
        cpu_initialization_period: float = DEFAULT_CPU_INITIALIZATION_PERIOD,
        delay_of_initial_readiness: float = DEFAULT_INITIAL_READINESS_DELAY,
    ) -> None:
        self.tolerance = tolerance
        self.cpu_initialization_period = cpu_initialization_period
        self.delay_of_initial_readiness = delay_of_initial_readiness

    # -- Resource target: Utilization --------------------------------------

    def get_resource_replicas(
        self,
        current_replicas: int,
        target_utilization: int,
        resource: str,
        pods: list[PodSample],
        calibration: float = 1.0,
    ) -> tuple[int, int, int]:
        """replica_calculator.go:62-145 GetResourceReplicas ->
        (replicas, utilization_pct, raw_average_value)."""
        if not pods:
            raise MetricsError(
                "no pods returned by selector while calculating replica count"
            )
        metrics = {p.name: p.value for p in pods if p.value is not None}
        if not metrics:
            raise MetricsError("no metrics returned from resource metrics API")
        g = group_pods(
            pods, metrics, resource,
            self.cpu_initialization_period, self.delay_of_initial_readiness,
        )
        for name in g.ignored | g.unready:
            metrics.pop(name, None)
        requests = calculate_pod_requests(pods, resource)
        if not metrics:
            raise MetricsError("did not receive metrics for any ready pods")

        usage_ratio, utilization, raw_avg = resource_utilization_ratio(
            metrics, requests, target_utilization
        )
        scale_up_with_unready = bool(g.unready) and usage_ratio > 1.0
        if not scale_up_with_unready and not g.missing:
            if abs(1.0 - usage_ratio) <= self.tolerance:
                return current_replicas, utilization, raw_avg
            return (
                math.ceil(usage_ratio * g.ready_count / calibration),
                utilization,
                raw_avg,
            )

        if g.missing:
            if usage_ratio < 1.0:
                # scale-down: missing pods count as using all of the
                # request (or the target for targets above 100%)
                fallback = max(100, target_utilization)
                for name in g.missing:
                    metrics[name] = requests[name] * fallback // 100
            elif usage_ratio > 1.0:
                for name in g.missing:
                    metrics[name] = 0
        if scale_up_with_unready:
            for name in g.unready:
                metrics[name] = 0

        new_ratio, _, _ = resource_utilization_ratio(
            metrics, requests, target_utilization
        )
        if abs(1.0 - new_ratio) <= self.tolerance or (
            usage_ratio < 1.0 < new_ratio
        ) or (usage_ratio > 1.0 > new_ratio):
            return current_replicas, utilization, raw_avg
        new_replicas = math.ceil(new_ratio * len(metrics) / calibration)
        if (new_ratio < 1.0 and new_replicas > current_replicas) or (
            new_ratio > 1.0 and new_replicas < current_replicas
        ):
            return current_replicas, utilization, raw_avg
        return new_replicas, utilization, raw_avg

    # -- Resource target: AverageValue / Pods metric ------------------------

    def get_raw_resource_replicas(
        self,
        current_replicas: int,
        target_usage: int,
        resource: str,
        pods: list[PodSample],
        calibration: float = 1.0,
    ) -> tuple[int, int]:
        """replica_calculator.go:147-157 GetRawResourceReplicas ->
        (replicas, avg_usage)."""
        metrics = {p.name: p.value for p in pods if p.value is not None}
        return self._plain_metric_replicas(
            metrics, current_replicas, target_usage, resource, pods,
            calibration,
        )

    def get_metric_replicas(
        self,
        current_replicas: int,
        target_usage: int,
        metrics: dict[str, int],
        pods: list[PodSample],
        calibration: float = 1.0,
    ) -> tuple[int, int]:
        """replica_calculator.go:159-170 GetMetricReplicas (Pods metric
        flavor: the sample set comes from custom.metrics.k8s.io, the pod
        list from the workload) -> (replicas, avg_usage)."""
        return self._plain_metric_replicas(
            metrics, current_replicas, target_usage, "", pods, calibration
        )

    def _plain_metric_replicas(
        self,
        metrics: dict[str, int],
        current_replicas: int,
        target_usage: int,
        resource: str,
        pods: list[PodSample],
        calibration: float,
    ) -> tuple[int, int]:
        """replica_calculator.go:172-241 calcPlainMetricReplicas."""
        if not pods:
            raise MetricsError(
                "no pods returned by selector while calculating replica count"
            )
        metrics = dict(metrics)
        g = group_pods(
            pods, metrics, resource,
            self.cpu_initialization_period, self.delay_of_initial_readiness,
        )
        for name in g.ignored | g.unready:
            metrics.pop(name, None)
        if not metrics:
            raise MetricsError("did not receive metrics for any ready pods")

        usage_ratio, usage = metric_usage_ratio(metrics, target_usage)
        scale_up_with_unready = bool(g.unready) and usage_ratio > 1.0
        if not scale_up_with_unready and not g.missing:
            if abs(1.0 - usage_ratio) <= self.tolerance:
                return current_replicas, usage
            return (
                math.ceil(usage_ratio * g.ready_count / calibration),
                usage,
            )

        if g.missing:
            if usage_ratio < 1.0:
                # scale-down: missing pods count as using the full target
                for name in g.missing:
                    metrics[name] = target_usage
            elif usage_ratio > 1.0:
                for name in g.missing:
                    metrics[name] = 0
        if scale_up_with_unready:
            for name in g.unready:
                metrics[name] = 0

        new_ratio, _ = metric_usage_ratio(metrics, target_usage)
        if abs(1.0 - new_ratio) <= self.tolerance or (
            usage_ratio < 1.0 < new_ratio
        ) or (usage_ratio > 1.0 > new_ratio):
            return current_replicas, usage
        new_replicas = math.ceil(new_ratio * len(metrics) / calibration)
        if (new_ratio < 1.0 and new_replicas > current_replicas) or (
            new_ratio > 1.0 and new_replicas < current_replicas
        ):
            return current_replicas, usage
        return new_replicas, usage

    # -- Object metric ------------------------------------------------------

    def get_object_metric_replicas(
        self,
        current_replicas: int,
        target_usage: int,
        object_usage: int,
        pods: list[PodSample],
        calibration: float = 1.0,
    ) -> tuple[int, int]:
        """replica_calculator.go:243-254 GetObjectMetricReplicas (Value
        target on a described object) -> (replicas, usage)."""
        usage_ratio = object_usage / target_usage
        return (
            self.get_usage_ratio_replica_count(
                current_replicas, usage_ratio, pods, calibration
            ),
            object_usage,
        )

    def get_object_per_pod_metric_replicas(
        self,
        status_replicas: int,
        target_average_usage: int,
        object_usage: int,
        calibration: float = 1.0,
    ) -> tuple[int, int]:
        """replica_calculator.go:256-273 GetObjectPerPodMetricReplicas
        (AverageValue target on a described object) -> (replicas,
        per_pod_usage)."""
        replica_count = status_replicas
        usage_ratio = object_usage / (target_average_usage * replica_count)
        if abs(1.0 - usage_ratio) > self.tolerance:
            replica_count = math.ceil(
                object_usage / target_average_usage / calibration
            )
        usage = math.ceil(object_usage / status_replicas)
        return math.ceil(replica_count / calibration), usage

    def get_usage_ratio_replica_count(
        self,
        current_replicas: int,
        usage_ratio: float,
        pods: list[PodSample],
        calibration: float = 1.0,
    ) -> int:
        """replica_calculator.go:275-295 — ready-pod-scaled count, with the
        scale-to-zero special case bypassing tolerance."""
        if current_replicas != 0:
            if abs(1.0 - usage_ratio) <= self.tolerance:
                return current_replicas
            ready = self.get_ready_pods_count(pods)
            return math.ceil(usage_ratio * ready / calibration)
        return math.ceil(usage_ratio)

    @staticmethod
    def get_ready_pods_count(pods: list[PodSample]) -> int:
        """replica_calculator.go:300-314."""
        if not pods:
            raise MetricsError(
                "no pods returned by selector while calculating replica count"
            )
        return sum(
            1 for p in pods if p.phase == "Running" and p.ready
        )
