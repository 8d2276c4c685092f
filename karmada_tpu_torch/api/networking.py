"""Networking API: MultiClusterService, ServiceExport/Import, MCI.

The port's own copy of ``karmada_tpu/api/networking.py``.

Ref: pkg/apis/networking/v1alpha1 (MultiClusterService types) and the
mcs-api ServiceExport/ServiceImport kinds the reference vendors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .core import Condition, ObjectMeta

# MultiClusterService exposure types
EXPOSURE_CROSS_CLUSTER = "CrossCluster"
EXPOSURE_LOAD_BALANCER = "LoadBalancer"


@dataclass
class ExposureRange:
    cluster_names: list[str] = field(default_factory=list)


@dataclass
class MultiClusterServiceSpec:
    types: list[str] = field(default_factory=lambda: [EXPOSURE_CROSS_CLUSTER])
    ports: list[dict] = field(default_factory=list)
    # provider: clusters where the backing service runs; consumer: clusters
    # that should see the derived service
    provider_clusters: list[ExposureRange] = field(default_factory=list)
    consumer_clusters: list[ExposureRange] = field(default_factory=list)


@dataclass
class MultiClusterServiceStatus:
    conditions: list[Condition] = field(default_factory=list)


@dataclass
class MultiClusterService:
    KIND = "MultiClusterService"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MultiClusterServiceSpec = field(default_factory=MultiClusterServiceSpec)
    status: MultiClusterServiceStatus = field(default_factory=MultiClusterServiceStatus)

    def provider_names(self) -> list[str]:
        return [n for r in self.spec.provider_clusters for n in r.cluster_names]

    def consumer_names(self) -> list[str]:
        return [n for r in self.spec.consumer_clusters for n in r.cluster_names]


@dataclass
class ServiceExport:
    """mcs-api ServiceExport: marks a service for cross-cluster export."""

    KIND = "ServiceExport"

    meta: ObjectMeta = field(default_factory=ObjectMeta)


@dataclass
class ServiceImportSpec:
    type: str = "ClusterSetIP"
    ports: list[dict] = field(default_factory=list)


@dataclass
class ServiceImport:
    KIND = "ServiceImport"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceImportSpec = field(default_factory=ServiceImportSpec)


@dataclass
class MultiClusterIngressSpec:
    """Ref: networking/v1alpha1 MultiClusterIngress: ingress spec over
    services backed by multiple clusters."""

    rules: list[dict] = field(default_factory=list)


@dataclass
class MultiClusterIngress:
    KIND = "MultiClusterIngress"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MultiClusterIngressSpec = field(default_factory=MultiClusterIngressSpec)
    status: dict = field(default_factory=dict)
