"""HPA scale-target marking + member-decided replica sync + unified auth.

The port's own copy of ``karmada_tpu/controllers/hpa_sync.py``. The marker
reads FederatedHPA objects (``controllers/autoscaling.py`` scales their
targets). Ref:
- hpaScaleTargetMarker (pkg/controllers/hpascaletargetmarker, 316 LoC):
  labels workloads targeted by a FederatedHPA so other controllers know the
  replica field is HPA-owned.
- deploymentReplicasSyncer (pkg/controllers/deploymentreplicassyncer,
  206 LoC): when member-side HPAs own replicas, sync the member-decided sum
  back onto the template so the control plane doesn't fight the members.
- unified-auth-controller (pkg/controllers/unifiedauth/, 335 LoC): sync
  RBAC for admin subjects into member clusters as Works.
"""

from __future__ import annotations

from typing import Optional

from ..api.core import ObjectMeta, Resource
from ..api.work import Work, WorkSpec
from ..utils import DONE, Runtime, Store
from .propagation import execution_namespace

HPA_TARGET_LABEL = "autoscaling.karmada.io/scale-target"
# marks workloads whose replica field is member-owned (retained on apply)
RETAIN_REPLICAS_LABEL = "resourcetemplate.karmada.io/retain-replicas"


class HpaScaleTargetMarker:
    def __init__(self, store: Store, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.new_worker("hpa-marker", self._reconcile)
        store.watch("FederatedHPA", lambda e: self.worker.enqueue((e.key, e.type)))

    def _reconcile(self, key_type) -> Optional[str]:
        key, event_type = key_type
        hpa = self.store.get("FederatedHPA", key)
        ns = key.rpartition("/")[0]
        if hpa is None:
            # unmark any template that pointed at this HPA
            for res in self.store.list("Resource", ns or None):
                if res.meta.labels.get(HPA_TARGET_LABEL) == key:
                    del res.meta.labels[HPA_TARGET_LABEL]
                    self.store.apply(res)
            return DONE
        target = hpa.spec.scale_target_ref
        tkey = f"{ns}/{target.name}" if ns else target.name
        template = self.store.get("Resource", tkey)
        if template is None or template.kind != target.kind:
            return DONE
        changed = False
        if template.meta.labels.get(HPA_TARGET_LABEL) != key:
            template.meta.labels[HPA_TARGET_LABEL] = key
            changed = True
        if template.meta.labels.get(RETAIN_REPLICAS_LABEL) != "true":
            template.meta.labels[RETAIN_REPLICAS_LABEL] = "true"
            changed = True
        if changed:
            self.store.apply(template)
        return DONE


class DeploymentReplicasSyncer:
    """Member-decided replicas -> template (for HPA-marked workloads).
    Runs as a ticker: sums the member manifests' spec.replicas and writes the
    total back when it drifts."""

    def __init__(self, store: Store, runtime: Runtime, members) -> None:
        self.store = store
        self.members = members
        runtime.add_ticker(self.sync_once)

    def sync_once(self) -> None:
        for template in self.store.list("Resource"):
            if (
                template.kind != "Deployment"
                or HPA_TARGET_LABEL not in template.meta.labels
            ):
                continue
            key = template.meta.namespaced_name
            rb = self.store.get(
                "ResourceBinding", f"{template.meta.namespace}/{template.meta.name}-deployment"
            )
            if rb is None:
                continue
            total = 0
            seen = False
            for tc in rb.spec.clusters:
                member = self.members.get(tc.name)
                if member is None or not member.reachable:
                    continue
                obj = member.get(
                    "apps/v1/Deployment",
                    template.meta.namespace,
                    template.meta.name,
                )
                if obj is not None:
                    total += int(obj.spec.get("replicas", 0))
                    seen = True
            if seen and total != int(template.spec.get("replicas", 0)):
                template.spec["replicas"] = total
                self.store.apply(template)


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
