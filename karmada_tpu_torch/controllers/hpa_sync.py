"""Unified auth: admin RBAC synced into every member cluster as a Work.

The port's own copy of ``UnifiedAuthController`` from
``karmada_tpu/controllers/hpa_sync.py``. Ref: unified-auth-controller
(pkg/controllers/unifiedauth/, 335 LoC). The module's HPA scale-target
marker and member-decided replica syncer come with the autoscaling
controllers.
"""

from __future__ import annotations

from typing import Optional

from ..api.core import ObjectMeta, Resource
from ..api.work import Work, WorkSpec
from ..utils import DONE, Runtime, Store
from .propagation import execution_namespace


class UnifiedAuthController:
    """Admin RBAC sync into members (pkg/controllers/unifiedauth): every
    cluster receives a ClusterRole/ClusterRoleBinding pair granting the
    configured subjects cluster-wide access through the aggregated proxy."""

    ROLE_NAME = "karmada-controller-manager:karmada-view"

    def __init__(self, store: Store, runtime: Runtime, subjects=("system:admin",)) -> None:
        self.store = store
        self.subjects = list(subjects)
        self.worker = runtime.new_worker("unified-auth", self._reconcile)
        store.watch("Cluster", lambda e: self.worker.enqueue(e.key))

    def _reconcile(self, key: str) -> Optional[str]:
        cluster = self.store.get("Cluster", key)
        if cluster is None:
            return DONE
        role = Resource(
            api_version="rbac.authorization.k8s.io/v1",
            kind="ClusterRole",
            meta=ObjectMeta(name=self.ROLE_NAME),
            spec={"rules": [{"apiGroups": ["*"], "resources": ["*"],
                             "verbs": ["get", "list", "watch"]}]},
        )
        binding = Resource(
            api_version="rbac.authorization.k8s.io/v1",
            kind="ClusterRoleBinding",
            meta=ObjectMeta(name=self.ROLE_NAME),
            spec={
                "roleRef": {"kind": "ClusterRole", "name": self.ROLE_NAME},
                "subjects": [{"kind": "User", "name": s} for s in self.subjects],
            },
        )
        ns = execution_namespace(cluster.name)
        wkey = f"{ns}/unified-auth"
        existing = self.store.get("Work", wkey)
        sig = [role.spec, binding.spec]
        if existing is not None and [w.spec for w in existing.spec.workload] == sig:
            return DONE
        self.store.apply(
            Work(
                meta=ObjectMeta(name="unified-auth", namespace=ns),
                spec=WorkSpec(workload=[role, binding]),
            )
        )
        return DONE
