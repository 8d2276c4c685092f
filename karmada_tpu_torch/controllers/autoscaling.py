"""FederatedHPA + CronFederatedHPA controllers and the metrics path.

The port's own copy of ``karmada_tpu/controllers/autoscaling.py``.

Ref:
- FederatedHPA (pkg/controllers/federatedhpa/, 2,402 LoC): the kube HPA loop
  ported to multi-cluster — target the binding's clusters, pull pod metrics
  through the karmada-metrics-adapter, calibrate by ready-pod ratio, apply
  the stabilization window, write the scale subresource on the template
  (federatedhpa_controller.go:406-467, replica_calculator.go, :921-960).
- CronFederatedHPA (pkg/controllers/cronfederatedhpa/, gocron): cron rules
  scale a FederatedHPA's bounds or a workload's replicas directly.

Metrics transport: member clusters expose per-workload utilization samples
(MemberCluster.pod_metrics, the stand-in for metrics.k8s.io served by the
karmada-metrics-adapter — see ``metricsadapter``); the replica
calculator merges them across the binding's clusters weighted by pod count.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ..api.autoscaling import CronFederatedHPA, ExecutionHistoryItem, FederatedHPA
from ..metricsadapter import MetricsAdapter
from ..utils import DONE, Runtime, Store
from ..utils.cron import cron_matches
from .detector import binding_name
from .replica_calculator import MetricsError, PodSample, ReplicaCalculator


def _resource_plural(kind: str) -> str:
    """Kube-style lowercase plural resource name for a kind (the custom
    metrics API keys series by resource, e.g. Ingress -> ingresses)."""
    k = kind.lower()
    if not k:
        return k
    if k.endswith(("s", "x", "z", "ch", "sh")):
        return k + "es"
    if k.endswith("y") and k[-2:-1] not in "aeiou":
        return k[:-1] + "ies"
    return k + "s"


class FederatedHPAController:
    def __init__(
        self, store: Store, runtime: Runtime, members, clock=time.time
    ) -> None:
        self.store = store
        self.members = members
        self.clock = clock
        # scale-down stabilization: (hpa key) -> [(t, recommendation)]
        self._recommendations: dict[str, list[tuple[float, int]]] = {}
        # kube HPA sync period: evaluations are at least this far apart, so
        # stale metric samples cannot compound within one settle pass
        self.sync_period_seconds = 15.0
        self._last_eval: dict[str, float] = {}
        self.worker = runtime.new_worker("federated-hpa", self._reconcile)
        store.watch("FederatedHPA", lambda e: self.worker.enqueue(e.key))
        runtime.add_ticker(self._sweep)
        self._metrics_adapter = None

    def _adapter(self):
        """Lazy metrics-adapter facade (custom/external metric flavors)."""
        if self._metrics_adapter is None:
            self._metrics_adapter = MetricsAdapter(self.members)
        return self._metrics_adapter

    def _sweep(self) -> None:
        for hpa in self.store.list("FederatedHPA"):
            self.worker.enqueue(hpa.meta.namespaced_name)

    # -- metric collection (metrics-adapter fan-out analogue) --------------

    def _collect(self, hpa: FederatedHPA, clusters: list[str]) -> Optional[tuple[float, int, int]]:
        """Returns (avg_utilization_pct, ready_pods, total_pods) merged
        across the target clusters, or None when no samples exist."""
        target = hpa.spec.scale_target_ref
        workload_key = (
            f"{hpa.meta.namespace}/{target.name}"
            if hpa.meta.namespace
            else target.name
        )
        total_util = 0.0
        total_pods = 0
        ready = 0
        for name in clusters:
            member = self.members.get(name)
            if member is None or not member.reachable:
                continue
            sample = member.pod_metrics.get(workload_key)
            if not sample:
                continue
            pods = int(sample.get("pods", 0))
            total_util += float(sample.get("cpu_utilization", 0.0)) * pods
            total_pods += pods
            ready += int(sample.get("ready_pods", pods))
        if total_pods == 0:
            return None
        return total_util / total_pods, ready, total_pods

    def _pod_list(
        self, hpa: FederatedHPA, clusters: list[str]
    ) -> tuple[list, bool]:
        """The federated podList (federatedhpa_controller.go:540 — member
        pod informers merged): each member's per-pod samples for the target
        workload, as PodSample records. Also reports whether EVERY reachable
        target cluster published per-pod data — a partial list must not
        silently stand in for the federation (a member still on aggregate
        samples would have its load ignored)."""
        target = hpa.spec.scale_target_ref
        workload_key = (
            f"{hpa.meta.namespace}/{target.name}"
            if hpa.meta.namespace
            else target.name
        )
        pods = []
        complete = False
        for name in clusters:
            member = self.members.get(name)
            if member is None or not member.reachable:
                continue
            samples = member.workload_pods.get(workload_key)
            if samples is None:
                # a reachable target cluster without per-pod data: the
                # federated list would be partial — callers fall back to
                # the aggregate path
                return [], False
            complete = True
            for d in samples:
                pods.append(PodSample(cluster=name, **d))
        return pods, complete and bool(pods)

    # -- reconcile ---------------------------------------------------------

    def _reconcile(self, key: str) -> Optional[str]:
        hpa = self.store.get("FederatedHPA", key)
        if hpa is None:
            self._recommendations.pop(key, None)
            return DONE
        target = hpa.spec.scale_target_ref
        template_key = (
            f"{hpa.meta.namespace}/{target.name}" if hpa.meta.namespace else target.name
        )
        template = self.store.get("Resource", template_key)
        if template is None or template.kind != target.kind:
            return DONE
        rb_key = (
            f"{hpa.meta.namespace}/{binding_name(template)}"
            if hpa.meta.namespace
            else binding_name(template)
        )
        rb = self.store.get("ResourceBinding", rb_key)
        clusters = [tc.name for tc in rb.spec.clusters] if rb is not None else []
        current = int(template.spec.get("replicas", 0))
        now = self.clock()
        last = self._last_eval.get(key)
        if last is not None and now - last < self.sync_period_seconds:
            return DONE
        metrics = self._collect(hpa, clusters)
        if current == 0:
            self._update_status(hpa, current, current)
            return DONE

        # desired = max over metrics of each flavor's calculator proposal
        # (replica_calculator.go:62-314 via controllers.replica_calculator);
        # no computable metric keeps the current size. Per-pod sets come
        # from the members' workload_pods (the federated podList); workloads
        # without per-pod detail fall back to the aggregate utilization
        # sample. An uncomputable metric (MetricsError) is skipped like the
        # reference's invalid-metric tally.
        calc = ReplicaCalculator()
        pods, pods_complete = self._pod_list(hpa, clusters)
        # calibration = materialized replicas / template replicas
        # (federatedhpa_controller.go:601 — member scale specs vs template)
        assigned = (
            sum(int(tc.replicas or 0) for tc in rb.spec.clusters)
            if rb is not None
            else 0
        )
        calibration = assigned / current if assigned and current else 1.0

        def _milli(v: float) -> int:
            return max(1, int(round(float(v) * 1000)))

        proposals = []
        for metric in hpa.spec.metrics or []:
            mtype = getattr(metric, "type", "Resource") or "Resource"
            try:
                if mtype == "Resource" and metric.target_average_utilization:
                    done = False
                    if pods_complete:
                        try:
                            n, _, _ = calc.get_resource_replicas(
                                current, metric.target_average_utilization,
                                metric.resource_name or "cpu", pods,
                                calibration,
                            )
                            proposals.append(n)
                            done = True
                        except MetricsError:
                            # per-pod data uncomputable (e.g. missing
                            # requests): the aggregate sample still drives
                            # scaling rather than freezing it
                            done = False
                    if not done and metrics is not None:
                        # aggregate fallback (no complete per-pod detail):
                        # ready-ratio calibration over the merged sample
                        avg_util, ready, total = metrics
                        agg_cal = ready / total if total else 1.0
                        raw = current * (
                            avg_util / metric.target_average_utilization
                        )
                        proposals.append(math.ceil(raw * agg_cal))
                elif mtype == "Resource" and metric.target_average_value:
                    if pods_complete:
                        n, _ = calc.get_raw_resource_replicas(
                            current, _milli(metric.target_average_value),
                            metric.resource_name or "cpu", pods, calibration,
                        )
                        proposals.append(n)
                elif mtype == "Pods" and metric.target_average_value:
                    # custom per-pod metric (custom.metrics.k8s.io): the
                    # sample set joins the federated pod list so missing/
                    # unready pods get the reference's backfill treatment
                    samples = [
                        s
                        for s in self._adapter().custom.get_metric_by_selector(
                            "pods",
                            hpa.meta.namespace,
                            metric.metric_name,
                            metric_selector=metric.metric_selector,
                        )
                        if s.cluster in clusters
                    ]
                    if not samples:
                        continue
                    msamples = {
                        s.object_name: _milli(s.value) for s in samples
                    }
                    plist = pods if pods_complete else [
                        PodSample(name=s.object_name, cluster=s.cluster)
                        for s in samples
                    ]
                    n, _ = calc.get_metric_replicas(
                        current, _milli(metric.target_average_value),
                        msamples, plist, calibration,
                    )
                    proposals.append(n)
                elif mtype == "Object" and (
                    metric.target_value or metric.target_average_value
                ):
                    obj = metric.described_object
                    if obj is None:
                        continue
                    samples = [
                        s
                        for s in self._adapter().custom.get_metric_by_name(
                            _resource_plural(obj.kind or ""),
                            hpa.meta.namespace,
                            obj.name,
                            metric.metric_name,
                            metric_selector=metric.metric_selector,
                        )
                        if s.cluster in clusters
                    ]
                    if not samples:
                        continue
                    usage = sum(_milli(s.value) for s in samples)
                    if metric.target_value:
                        n, _ = calc.get_object_metric_replicas(
                            current, _milli(metric.target_value), usage,
                            pods if pods_complete else [
                                PodSample(name=f"p{i}")
                                for i in range(max(current, 1))
                            ],
                            calibration,
                        )
                    else:
                        status_replicas = (
                            len(pods) if pods_complete else current
                        )
                        n, _ = calc.get_object_per_pod_metric_replicas(
                            max(status_replicas, 1),
                            _milli(metric.target_average_value), usage,
                            calibration,
                        )
                    proposals.append(n)
                elif mtype == "External":
                    samples = self._adapter().external.get_external_metric(
                        hpa.meta.namespace,
                        metric.metric_name,
                        selector=metric.metric_selector,
                    )
                    if not samples:
                        continue
                    usage = sum(s.value for s in samples)
                    if metric.target_value:
                        proposals.append(
                            math.ceil(usage / metric.target_value)
                        )
                    elif metric.target_average_value:
                        # GetExternalPerPodMetricReplicas: per-pod average
                        proposals.append(
                            math.ceil(usage / metric.target_average_value)
                        )
            except MetricsError:
                # reference: tally as invalid metric and keep going — the
                # remaining metrics still drive scaling
                continue
        if not proposals and metrics is None and not pods_complete:
            self._update_status(hpa, current, current)
            return DONE
        self._last_eval[key] = now
        desired = max(proposals) if proposals else current
        desired = min(max(desired, hpa.spec.min_replicas), hpa.spec.max_replicas)

        # scale-down stabilization: act on the max recommendation inside the
        # window (federatedhpa_controller.go:921-960); the first evaluation
        # seeds the window with the current size for continuity
        window = hpa.spec.stabilization_window_seconds
        prior = self._recommendations.get(key)
        if prior is None:
            prior = [(now, current)]
        recs = [(t, r) for t, r in prior if now - t <= window]
        recs.append((now, desired))
        self._recommendations[key] = recs
        if desired < current:
            desired = max(r for _, r in recs)

        if desired != current:
            template.spec["replicas"] = desired
            self.store.apply(template)  # detector re-derives binding replicas
            hpa.status.last_scale_time = now
        self._update_status(hpa, current, desired)
        return DONE

    def _update_status(self, hpa: FederatedHPA, current: int, desired: int) -> None:
        if (
            hpa.status.current_replicas != current
            or hpa.status.desired_replicas != desired
        ):
            hpa.status.current_replicas = current
            hpa.status.desired_replicas = desired
            self.store.apply(hpa)


class CronFederatedHPAController:
    """Cron-driven scaling (pkg/controllers/cronfederatedhpa/). Each tick,
    rules whose schedule matches the current minute fire once."""

    def __init__(self, store: Store, runtime: Runtime, clock=time.time) -> None:
        self.store = store
        self.clock = clock
        self._last_fired: dict[tuple[str, str], int] = {}  # (key, rule) -> minute
        runtime.add_ticker(self.tick)

    def tick(self) -> None:
        now = self.clock()
        minute = int(now // 60)
        for cron_hpa in self.store.list("CronFederatedHPA"):
            for rule in cron_hpa.spec.rules:
                if rule.suspend:
                    continue
                k = (cron_hpa.meta.namespaced_name, rule.name)
                if self._last_fired.get(k) == minute:
                    continue
                if not cron_matches(rule.schedule, now):
                    continue
                self._last_fired[k] = minute
                self._fire(cron_hpa, rule, now)

    def _fire(self, cron_hpa: CronFederatedHPA, rule, now: float) -> None:
        target = cron_hpa.spec.scale_target_ref
        applied = None
        message = ""
        if target.kind == "FederatedHPA":
            key = (
                f"{cron_hpa.meta.namespace}/{target.name}"
                if cron_hpa.meta.namespace
                else target.name
            )
            hpa = self.store.get("FederatedHPA", key)
            if hpa is None:
                message = "target FederatedHPA not found"
            else:
                if rule.target_min_replicas is not None:
                    hpa.spec.min_replicas = rule.target_min_replicas
                if rule.target_max_replicas is not None:
                    hpa.spec.max_replicas = rule.target_max_replicas
                self.store.apply(hpa)
                applied = rule.target_min_replicas
        else:
            key = (
                f"{cron_hpa.meta.namespace}/{target.name}"
                if cron_hpa.meta.namespace
                else target.name
            )
            template = self.store.get("Resource", key)
            if template is None or rule.target_replicas is None:
                message = "target workload not found"
            else:
                template.spec["replicas"] = rule.target_replicas
                self.store.apply(template)
                applied = rule.target_replicas
        cron_hpa.status.execution_histories.append(
            ExecutionHistoryItem(
                rule_name=rule.name,
                execution_time=now,
                applied_replicas=applied,
                message=message,
            )
        )
        self.store.apply(cron_hpa)
