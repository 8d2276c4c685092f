"""Metrics adapter: multi-cluster metrics aggregation APIs.

The port's own copy of ``karmada_tpu/metricsadapter/``.

Ref: pkg/metricsadapter — implements custom-metrics, external-metrics and
resource-metrics (metrics.k8s.io) API flavors by fanning out to member
clusters and merging (provider/{custommetrics,externalmetrics,
resourcemetrics}.go). Feeds FederatedHPA.
"""

from .provider import MetricsAdapter  # noqa: F401
