"""Graceful eviction of a binding from one cluster.

The port's own copy of ``evict_binding`` from
``karmada_tpu/controllers/cluster.py``; the cluster controllers around it
(status collection, the taint manager) need the member clients, which the
port does not carry yet.
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.work import GracefulEvictionTask
from ..utils.features import GRACEFUL_EVICTION, feature_gate


def evict_binding(
    rb,
    cluster_name: str,
    *,
    reason: str,
    producer: str,
    message: str = "",
    purge_mode: str = "Graciously",
    grace_period_seconds=None,
    preserved_label_state: Optional[dict] = None,
    now: Optional[float] = None,
) -> None:
    """Move a cluster from spec.clusters into graceful-eviction tasks
    (binding_types_helper GracefulEvictCluster semantics). Without the
    GracefulEviction feature the cluster is dropped outright."""
    target = next((tc for tc in rb.spec.clusters if tc.name == cluster_name), None)
    if target is None:
        return
    rb.spec.clusters = [tc for tc in rb.spec.clusters if tc.name != cluster_name]
    if feature_gate.enabled(GRACEFUL_EVICTION):
        if not any(
            t.from_cluster == cluster_name for t in rb.spec.graceful_eviction_tasks
        ):
            rb.spec.graceful_eviction_tasks.append(
                GracefulEvictionTask(
                    from_cluster=cluster_name,
                    replicas=target.replicas,
                    reason=reason,
                    message=message,
                    producer=producer,
                    purge_mode=purge_mode,
                    grace_period_seconds=grace_period_seconds,
                    creation_timestamp=now if now is not None else time.time(),
                    preserved_label_state=dict(preserved_label_state or {}),
                    clusters_before_failover=[tc.name for tc in rb.spec.clusters]
                    + [cluster_name],
                )
            )
    rb.meta.generation += 1  # spec changed -> scheduler re-runs
