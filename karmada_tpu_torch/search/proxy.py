"""Proxy framework: ordered plugins answering unified resource requests.

The port's own copy of ``karmada_tpu/search/proxy.py``.

Ref: pkg/search/proxy/framework — a connect chain where each plugin decides
whether it can serve the request; order is cache -> member cluster ->
karmada control plane (pkg/search/proxy/framework/plugins + karmada.go:68-74).
The aggregated-apiserver's clusters/{name}/proxy passthrough
(pkg/registry/cluster/storage/proxy.go:41-102) is the ClusterProxyPlugin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..api.core import Resource
from ..utils import Store
from ..utils.member import MemberClientRegistry, UnreachableError
from .registry import MultiClusterCache


@dataclass
class ProxyRequest:
    verb: str  # get | list | logs | exec
    gvk: str
    namespace: str = ""
    name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    # explicit member-cluster routing (clusters/{name}/proxy passthrough)
    cluster: Optional[str] = None
    # subresource payload: logs tail, exec command
    options: dict[str, Any] = field(default_factory=dict)


@dataclass
class ProxyResponse:
    served_by: str  # cache | cluster | karmada
    obj: Optional[Resource] = None
    items: list[tuple[str, Resource]] = field(default_factory=list)
    error: str = ""
    # subresource result (log lines, exec output)
    data: Any = None
    # list paging (multi-cluster continue + resource-version encodings)
    continue_token: str = ""
    resource_version: str = ""


class CachePlugin:
    name = "cache"

    def __init__(self, cache: MultiClusterCache):
        self.cache = cache

    def connect(self, req: ProxyRequest) -> Optional[ProxyResponse]:
        if req.verb not in ("get", "list"):
            return None  # subresources always go to the member
        if req.verb == "get":
            hit = self.cache.get(req.gvk, req.namespace, req.name, req.cluster)
            if hit is not None:
                return ProxyResponse(served_by=self.name, obj=hit[1])
            return None
        limit = int(req.options.get("limit", 0) or 0)
        cont = str(req.options.get("continue", "") or "")
        if limit or cont:
            items, next_token, rv = self.cache.list_paged(
                req.gvk, req.namespace or None, req.labels or None,
                limit=limit, continue_token=cont, cluster=req.cluster,
            )
            if items or cont:
                return ProxyResponse(
                    served_by=self.name, items=items,
                    continue_token=next_token, resource_version=rv,
                )
            return None
        items = self.cache.list(req.gvk, req.namespace or None, req.labels or None)
        if req.cluster is not None:
            items = [(c, o) for c, o in items if c == req.cluster]
        if items:
            return ProxyResponse(served_by=self.name, items=items)
        return None


class ClusterProxyPlugin:
    """Direct passthrough to one member cluster (requires req.cluster)."""

    name = "cluster"

    def __init__(self, members: MemberClientRegistry):
        self.members = members

    def connect(self, req: ProxyRequest) -> Optional[ProxyResponse]:
        if req.cluster is None:
            return None
        member = self.members.get(req.cluster)
        if member is None:
            return ProxyResponse(
                served_by=self.name, error=f"unknown cluster {req.cluster}"
            )
        try:
            if req.verb == "get":
                obj = member.get(req.gvk, req.namespace, req.name)
                if obj is None:
                    return ProxyResponse(
                        served_by=self.name, error="not found"
                    )
                return ProxyResponse(served_by=self.name, obj=obj)
            if req.verb in ("logs", "exec"):
                # pod subresources ride the same clusters/{name}/proxy
                # passthrough that karmadactl logs/exec/attach uses
                # (pkg/registry/cluster/storage/proxy.go:41-102)
                try:
                    if req.verb == "logs":
                        data = member.pod_logs(
                            req.namespace, req.name, tail=req.options.get("tail")
                        )
                    else:
                        data = member.pod_exec(
                            req.namespace, req.name, req.options.get("command", [])
                        )
                except KeyError as e:
                    return ProxyResponse(served_by=self.name, error=str(e))
                return ProxyResponse(served_by=self.name, data=data)
            items = [
                (req.cluster, o)
                for o in member.list(req.gvk)
                if (not req.namespace or o.meta.namespace == req.namespace)
                and all(o.meta.labels.get(k) == v for k, v in req.labels.items())
            ]
            return ProxyResponse(served_by=self.name, items=items)
        except UnreachableError as e:
            return ProxyResponse(served_by=self.name, error=str(e))


class KarmadaPlugin:
    """Fallback: serve from the control-plane store (templates)."""

    name = "karmada"

    def __init__(self, store: Store):
        self.store = store

    def connect(self, req: ProxyRequest) -> Optional[ProxyResponse]:
        if req.verb not in ("get", "list"):
            return ProxyResponse(
                served_by=self.name,
                error=f"verb {req.verb} requires cluster routing",
            )
        if req.verb == "get":
            key = f"{req.namespace}/{req.name}" if req.namespace else req.name
            obj = self.store.get("Resource", key)
            if obj is not None and f"{obj.api_version}/{obj.kind}" == req.gvk:
                return ProxyResponse(served_by=self.name, obj=obj)
            return ProxyResponse(served_by=self.name, error="not found")
        items = [
            ("karmada", o)
            for o in self.store.list("Resource", req.namespace or None)
            if f"{o.api_version}/{o.kind}" == req.gvk
            and all(o.meta.labels.get(k) == v for k, v in req.labels.items())
        ]
        return ProxyResponse(served_by=self.name, items=items)


class Proxy:
    """Ordered plugin chain (karmada.go:68-74: cache, cluster, karmada)."""

    def __init__(
        self,
        store: Store,
        members: MemberClientRegistry,
        cache: MultiClusterCache,
    ) -> None:
        self.plugins = [
            CachePlugin(cache),
            ClusterProxyPlugin(members),
            KarmadaPlugin(store),
        ]

    def connect(self, req: ProxyRequest) -> ProxyResponse:
        for plugin in self.plugins:
            resp = plugin.connect(req)
            if resp is not None:
                return resp
        return ProxyResponse(served_by="", error="no plugin served the request")
