"""Feature gates (ref: pkg/features/features.go:33-86, defaults mirrored)."""

from __future__ import annotations

FAILOVER = "Failover"
GRACEFUL_EVICTION = "GracefulEviction"
PROPAGATE_DEPS = "PropagateDeps"
CUSTOMIZED_CLUSTER_RESOURCE_MODELING = "CustomizedClusterResourceModeling"
POLICY_PREEMPTION = "PropagationPolicyPreemption"
MULTI_CLUSTER_SERVICE = "MultiClusterService"
RESOURCE_QUOTA_ESTIMATE = "ResourceQuotaEstimate"
STATEFUL_FAILOVER_INJECTION = "StatefulFailoverInjection"

DEFAULTS = {
    FAILOVER: False,
    GRACEFUL_EVICTION: True,
    PROPAGATE_DEPS: True,
    CUSTOMIZED_CLUSTER_RESOURCE_MODELING: True,
    POLICY_PREEMPTION: False,
    MULTI_CLUSTER_SERVICE: False,
    RESOURCE_QUOTA_ESTIMATE: False,
    STATEFUL_FAILOVER_INJECTION: False,
}


class FeatureGate:
    def __init__(self, overrides: dict[str, bool] | None = None):
        self._state = dict(DEFAULTS)
        if overrides:
            self._state.update(overrides)

    def enabled(self, feature: str) -> bool:
        return self._state.get(feature, False)

    def set(self, feature: str, value: bool) -> None:
        self._state[feature] = value


# shared global gate, mirroring features.FeatureGate
feature_gate = FeatureGate()
