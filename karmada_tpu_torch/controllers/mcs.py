"""Multi-cluster service controllers: endpoint collection + dispatch.

The port's own copy of ``karmada_tpu/controllers/mcs.py``.

Ref:
- mcs ServiceExport controller (pkg/controllers/mcs/service_export_controller.go):
  collect EndpointSlices of exported services from member clusters into the
  control plane (as Works-shadowed EndpointSlice resources labeled with the
  source cluster).
- MultiClusterService controllers (pkg/controllers/multiclusterservice/,
  1,601 LoC): for an MCS CR, ensure the backing service runs in provider
  clusters, then distribute a derived service + collected EndpointSlices to
  consumer clusters (endpointslice-collect + endpointslice-dispatch).
- ServiceImport -> derived service (pkg/controllers/mcs/
  service_import_controller.go): "derived-<name>" service in importing
  clusters backed by the collected slices.
"""

from __future__ import annotations

from typing import Optional

from ..api.core import ObjectMeta, Resource
from ..api.work import Work, WorkSpec
from ..utils import DONE, Runtime, Store
from ..utils.member import MemberClientRegistry, UnreachableError
from .propagation import execution_namespace

SOURCE_CLUSTER_LABEL = "endpointslice.karmada.io/source-cluster"
SERVICE_LABEL = "kubernetes.io/service-name"


def derived_service_name(name: str) -> str:
    return f"derived-{name}"


class ServiceExportController:
    """Collect member EndpointSlices for exported services onto the control
    plane."""

    def __init__(
        self, store: Store, runtime: Runtime, members: MemberClientRegistry
    ) -> None:
        self.store = store
        self.members = members
        self.worker = runtime.new_worker("service-export", self._reconcile)
        store.watch("ServiceExport", lambda e: self.worker.enqueue(e.key))
        runtime.add_ticker(self._sweep)

    def _sweep(self) -> None:
        for se in self.store.list("ServiceExport"):
            self.worker.enqueue(se.meta.namespaced_name)

    def _reconcile(self, key: str) -> Optional[str]:
        se = self.store.get("ServiceExport", key)
        ns, _, name = key.rpartition("/")
        if se is None:
            self._cleanup(ns, name)
            return DONE
        for cluster_name in self.members.names():
            member = self.members.get(cluster_name)
            if member is None or not member.reachable:
                continue
            try:
                slices = [
                    s
                    for s in member.list("discovery.k8s.io/v1/EndpointSlice")
                    if s.meta.namespace == ns
                    and s.meta.labels.get(SERVICE_LABEL) == name
                ]
            except UnreachableError:
                continue
            for s in slices:
                collected = Resource(
                    api_version=s.api_version,
                    kind=s.kind,
                    meta=ObjectMeta(
                        name=f"{cluster_name}-{s.meta.name}",
                        namespace=ns,
                        labels={
                            SERVICE_LABEL: name,
                            SOURCE_CLUSTER_LABEL: cluster_name,
                        },
                    ),
                    spec=dict(s.spec),
                )
                existing = self.store.get(
                    "Resource", f"{ns}/{collected.meta.name}"
                )
                if existing is None or existing.spec != collected.spec:
                    self.store.apply(collected)
        return DONE

    def _cleanup(self, ns: str, name: str) -> None:
        for res in self.store.list("Resource", ns):
            if (
                res.kind == "EndpointSlice"
                and res.meta.labels.get(SERVICE_LABEL) == name
                and SOURCE_CLUSTER_LABEL in res.meta.labels
            ):
                self.store.delete("Resource", res.meta.namespaced_name)


class MultiClusterServiceController:
    """MCS CR -> derived service + endpoint slices into consumer clusters."""

    def __init__(
        self, store: Store, runtime: Runtime, members: MemberClientRegistry
    ) -> None:
        self.store = store
        self.members = members
        self.worker = runtime.new_worker("multiclusterservice", self._reconcile)
        store.watch("MultiClusterService", lambda e: self.worker.enqueue(e.key))
        runtime.add_ticker(self._sweep)

    def _sweep(self) -> None:
        for mcs in self.store.list("MultiClusterService"):
            self.worker.enqueue(mcs.meta.namespaced_name)

    def _reconcile(self, key: str) -> Optional[str]:
        mcs = self.store.get("MultiClusterService", key)
        ns, _, name = key.rpartition("/")
        if mcs is None:
            return DONE
        providers = mcs.provider_names() or list(self.members.names())
        consumers = mcs.consumer_names() or list(self.members.names())

        # 1. collect endpoint slices from provider clusters
        slices: list[Resource] = []
        for cluster_name in providers:
            member = self.members.get(cluster_name)
            if member is None or not member.reachable:
                continue
            try:
                found = [
                    s
                    for s in member.list("discovery.k8s.io/v1/EndpointSlice")
                    if s.meta.namespace == ns
                    and s.meta.labels.get(SERVICE_LABEL) == name
                ]
            except UnreachableError:
                continue
            for s in found:
                slices.append((cluster_name, s))

        # 2. derive the service spec from any provider's service
        svc_spec = {"ports": mcs.spec.ports}
        for cluster_name in providers:
            member = self.members.get(cluster_name)
            if member is None or not member.reachable:
                continue
            svc = member.get("v1/Service", ns, name)
            if svc is not None:
                svc_spec = {**svc.spec, "clusterIP": None}
                break

        # 3. dispatch derived service + slices into consumer clusters
        derived = derived_service_name(name)
        for cluster_name in consumers:
            work_ns = execution_namespace(cluster_name)
            workloads = [
                Resource(
                    api_version="v1",
                    kind="Service",
                    meta=ObjectMeta(name=derived, namespace=ns),
                    spec=dict(svc_spec),
                )
            ]
            for src, s in slices:
                if src == cluster_name:
                    continue  # a cluster doesn't need its own slices back
                workloads.append(
                    Resource(
                        api_version=s.api_version,
                        kind=s.kind,
                        meta=ObjectMeta(
                            name=f"{src}-{s.meta.name}",
                            namespace=ns,
                            labels={
                                SERVICE_LABEL: derived,
                                SOURCE_CLUSTER_LABEL: src,
                            },
                        ),
                        spec=dict(s.spec),
                    )
                )
            wkey = f"{work_ns}/mcs-{ns}.{name}"
            existing = self.store.get("Work", wkey)
            sig = [(w.kind, w.meta.name, w.spec) for w in workloads]
            if existing is not None and [
                (w.kind, w.meta.name, w.spec) for w in existing.spec.workload
            ] == sig:
                continue
            self.store.apply(
                Work(
                    meta=ObjectMeta(name=f"mcs-{ns}.{name}", namespace=work_ns),
                    spec=WorkSpec(workload=workloads),
                )
            )
        return DONE
