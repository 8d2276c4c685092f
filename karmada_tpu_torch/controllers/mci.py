"""MultiClusterIngress controller.

The port's own copy of ``karmada_tpu/controllers/mci.py``.

Ref: pkg/controllers/multiclusteringress + pkg/apis/networking/v1alpha1
MultiClusterIngress: an ingress whose backend services are backed by
multiple clusters. The controller resolves each rule's backend service to
the clusters that can serve it (via the MCS machinery) and dispatches a
plain Ingress + derived backends into those clusters.
"""

from __future__ import annotations

from typing import Optional

from ..api.core import ObjectMeta, Resource
from ..api.work import Work, WorkSpec
from ..utils import DONE, Runtime, Store
from ..utils.member import MemberClientRegistry
from .propagation import execution_namespace


class MultiClusterIngressController:
    def __init__(
        self, store: Store, runtime: Runtime, members: MemberClientRegistry
    ) -> None:
        self.store = store
        self.members = members
        self.worker = runtime.new_worker("multiclusteringress", self._reconcile)
        store.watch("MultiClusterIngress", lambda e: self.worker.enqueue(e.key))
        runtime.add_ticker(self._sweep)

    def _sweep(self) -> None:
        for mci in self.store.list("MultiClusterIngress"):
            self.worker.enqueue(mci.meta.namespaced_name)

    def _service_clusters(self, namespace: str, service: str) -> list[str]:
        """Clusters that can serve a backend service: those holding the
        service natively or via an MCS-derived service."""
        out = []
        for name in self.members.names():
            member = self.members.get(name)
            if member is None or not member.reachable:
                continue
            if (
                member.get("v1/Service", namespace, service) is not None
                or member.get("v1/Service", namespace, f"derived-{service}")
                is not None
            ):
                out.append(name)
        return sorted(out)

    def _reconcile(self, key: str) -> Optional[str]:
        mci = self.store.get("MultiClusterIngress", key)
        ns, _, name = key.rpartition("/")
        if mci is None:
            return DONE
        # gather backend services from the rules
        backends = set()
        for rule in mci.spec.rules:
            for path in rule.get("http", {}).get("paths", []):
                svc = path.get("backend", {}).get("service", {}).get("name")
                if svc:
                    backends.add(svc)
        target_clusters: set[str] = set()
        for svc in backends:
            target_clusters.update(self._service_clusters(ns, svc))
        ingress = Resource(
            api_version="networking.k8s.io/v1",
            kind="Ingress",
            meta=ObjectMeta(name=name, namespace=ns),
            spec={"rules": list(mci.spec.rules)},
        )
        for cluster in sorted(target_clusters):
            work_ns = execution_namespace(cluster)
            wkey = f"{work_ns}/mci-{ns}.{name}"
            existing = self.store.get("Work", wkey)
            if existing is not None and existing.spec.workload[0].spec == ingress.spec:
                continue
            self.store.apply(
                Work(
                    meta=ObjectMeta(name=f"mci-{ns}.{name}", namespace=work_ns),
                    spec=WorkSpec(workload=[ingress]),
                )
            )
        if mci.status.get("clusters") != sorted(target_clusters):
            mci.status = {"clusters": sorted(target_clusters)}
            self.store.apply(mci)
        return DONE
