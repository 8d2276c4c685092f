"""Object builders for tests, benchmarks and synthetic fleets.

The port's own copy of ``karmada_tpu.utils.builders``: the same seeds give
the same fleets and placements as the JAX package's builders, which is what
lets the tests and ``chip_smoke.py`` pose one workload to both engines.

The analogue of the reference's test/helper/resource.go builders
(NewCluster, NewClusterWithResource, ...) plus synthetic-fleet generators for
the BASELINE.json workloads (100 bindings x 20 clusters up to 100k x 5k).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from ..api.cluster import (
    Cluster,
    ClusterSpec,
    ClusterStatus,
    ResourceSummary,
    Taint,
)
from ..api.core import Condition, ObjectMeta, Resource
from ..api.policy import (
    ClusterAffinity,
    ClusterPreferences,
    Placement,
    ReplicaSchedulingStrategy,
    StaticClusterWeight,
)
from .quantity import parse_resource_list


def new_cluster(
    name: str,
    *,
    cpu: str | int = "100",
    memory: str | int = "200Gi",
    pods: int = 1000,
    allocated: Optional[Mapping[str, int | str]] = None,
    labels: Optional[Mapping[str, str]] = None,
    provider: str = "",
    region: str = "",
    zone: str = "",
    taints: Sequence[Taint] = (),
    api_enablements: Sequence[str] = ("apps/v1/Deployment",),
    complete_enablements: bool = True,
    ready: bool = True,
) -> Cluster:
    allocatable = parse_resource_list({"cpu": cpu, "memory": memory, "pods": pods})
    conditions = [Condition(type="Ready", status=ready)]
    if complete_enablements:
        conditions.append(Condition(type="CompleteAPIEnablements", status=True))
    return Cluster(
        meta=ObjectMeta(name=name, labels=dict(labels or {})),
        spec=ClusterSpec(
            provider=provider,
            region=region,
            zones=[zone] if zone else [],
            taints=list(taints),
        ),
        status=ClusterStatus(
            api_enablements=list(api_enablements),
            conditions=conditions,
            resource_summary=ResourceSummary(
                allocatable=allocatable,
                allocated=parse_resource_list(dict(allocated)) if allocated else {},
            ),
        ),
    )


def duplicated_placement(**kw) -> Placement:
    return Placement(
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type="Duplicated"
        ),
        **kw,
    )


def static_weight_placement(
    weights: Mapping[str, int], **kw
) -> Placement:
    """Weights keyed by cluster name."""
    return Placement(
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type="Divided",
            replica_division_preference="Weighted",
            weight_preference=ClusterPreferences(
                static_weight_list=[
                    StaticClusterWeight(
                        target_cluster=ClusterAffinity(cluster_names=[n]), weight=w
                    )
                    for n, w in weights.items()
                ]
            ),
        ),
        **kw,
    )


def dynamic_weight_placement(**kw) -> Placement:
    return Placement(
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type="Divided",
            replica_division_preference="Weighted",
            weight_preference=ClusterPreferences(dynamic_weight="AvailableReplicas"),
        ),
        **kw,
    )


def aggregated_placement(**kw) -> Placement:
    return Placement(
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type="Divided",
            replica_division_preference="Aggregated",
        ),
        **kw,
    )


def new_deployment(
    name: str,
    *,
    namespace: str = "default",
    replicas: int = 2,
    cpu: str = "250m",
    memory: str = "512Mi",
    image: str = "nginx:1.25",
    labels: Optional[Mapping[str, str]] = None,
) -> Resource:
    """A kube-shaped Deployment template (the samples/nginx analogue)."""
    return Resource(
        api_version="apps/v1",
        kind="Deployment",
        meta=ObjectMeta(name=name, namespace=namespace, labels=dict(labels or {})),
        spec={
            "replicas": replicas,
            "template": {
                "spec": {
                    "containers": [
                        {
                            "name": name,
                            "image": image,
                            "resources": {
                                "requests": {"cpu": cpu, "memory": memory}
                            },
                        }
                    ]
                }
            },
        },
    )


def synthetic_fleet(
    num_clusters: int,
    *,
    seed: int = 0,
    regions: int = 8,
    zones_per_region: int = 4,
    providers: Sequence[str] = ("aws", "gcp", "azure"),
    taint_fraction: float = 0.05,
    label_sets: int = 16,
) -> list[Cluster]:
    """Synthetic member fleet mirroring the scale knobs of BASELINE.json:
    heterogeneous capacity, topology spread, a tainted slice, label variety."""
    rng = np.random.default_rng(seed)
    clusters = []
    for i in range(num_clusters):
        region = f"region-{rng.integers(0, regions)}"
        zone = f"{region}-z{rng.integers(0, zones_per_region)}"
        cores = int(rng.choice([16, 32, 64, 128]))
        nodes = int(rng.integers(2, 50))
        taints = (
            [Taint(key="fleet.io/dedicated", value="infra", effect="NoSchedule")]
            if rng.random() < taint_fraction
            else []
        )
        labels = {
            "tier": f"t{rng.integers(0, label_sets)}",
            "env": str(rng.choice(["prod", "staging", "dev"])),
        }
        alloc_frac = float(rng.uniform(0.2, 0.8))
        total_cpu = cores * nodes
        clusters.append(
            new_cluster(
                f"member-{i}",
                cpu=total_cpu,
                memory=f"{4 * total_cpu}Gi",
                pods=nodes * 110,
                allocated={
                    "cpu": total_cpu * alloc_frac,  # cores (canonicalized to milli)
                    "memory": int(4 * total_cpu * alloc_frac * (1 << 30)),
                    "pods": int(nodes * 110 * alloc_frac),
                },
                labels=labels,
                provider=str(rng.choice(list(providers))),
                region=region,
                zone=zone,
                taints=taints,
            )
        )
    return clusters
