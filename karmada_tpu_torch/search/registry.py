"""ResourceRegistry + multi-cluster cache.

The port's own copy of ``karmada_tpu/search/registry.py``.

Ref: pkg/apis/search/v1alpha1 (ResourceRegistry: target clusters + resource
selectors + backend) and pkg/search/controller.go (per-cluster caches for the
selected GVKs).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import base64
import json

from ..api.core import ObjectMeta, Resource
from ..api.policy import ClusterAffinity
from ..utils import DONE, Runtime, Store
from ..utils.member import MemberClientRegistry, UnreachableError


def encode_token(payload: dict) -> str:
    """Opaque list token (the reference base64-encodes JSON the same way —
    multiClusterResourceVersion.String / multiClusterContinue.String)."""
    return base64.urlsafe_b64encode(
        json.dumps(payload, sort_keys=True).encode()
    ).decode()


def decode_token(token: str) -> dict:
    try:
        return json.loads(base64.urlsafe_b64decode(token.encode()))
    except Exception:
        return {}


@dataclass
class ResourceRegistrySpec:
    target_cluster: ClusterAffinity = field(default_factory=ClusterAffinity)
    resource_selectors: list[dict] = field(default_factory=list)  # {apiVersion, kind}
    backend: str = "cache"  # cache | opensearch (external indexer plug point)


@dataclass
class ResourceRegistry:
    KIND = "ResourceRegistry"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceRegistrySpec = field(default_factory=ResourceRegistrySpec)


class MultiClusterCache:
    """(cluster, gvk, namespace, name) -> Resource, queryable across
    clusters. Fed by the SearchController's collection sweeps (the informer
    analogue)."""

    def __init__(self) -> None:
        self._items: dict[tuple[str, str, str, str], Resource] = {}

    def put(self, cluster: str, obj: Resource) -> None:
        self._items[
            (cluster, f"{obj.api_version}/{obj.kind}", obj.meta.namespace, obj.meta.name)
        ] = obj

    def drop_cluster(self, cluster: str) -> None:
        self._items = {
            k: v for k, v in self._items.items() if k[0] != cluster
        }

    def clear(self) -> None:
        self._items = {}

    def get(
        self, gvk: str, namespace: str, name: str, cluster: Optional[str] = None
    ) -> Optional[tuple[str, Resource]]:
        for (c, g, ns, n), obj in self._items.items():
            if g == gvk and ns == namespace and n == name:
                if cluster is None or c == cluster:
                    return c, obj
        return None

    def list(
        self,
        gvk: str,
        namespace: Optional[str] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> list[tuple[str, Resource]]:
        out = []
        for (c, g, ns, _), obj in self._items.items():
            if g != gvk:
                continue
            if namespace is not None and ns != namespace:
                continue
            if labels and any(
                obj.meta.labels.get(k) != v for k, v in labels.items()
            ):
                continue
            out.append((c, obj))
        return sorted(out, key=lambda t: (t[0], t[1].meta.namespaced_name))

    def list_paged(
        self,
        gvk: str,
        namespace: Optional[str] = None,
        labels: Optional[dict[str, str]] = None,
        limit: int = 0,
        continue_token: str = "",
        cluster: Optional[str] = None,
    ) -> tuple[list[tuple[str, Resource]], str, str]:
        """Paged multi-cluster list (ref: pkg/search/proxy/store/
        multi_cluster_cache.go:187-265): items stream cluster by cluster in
        name order; the continue token records (cluster, last item) so the
        next page resumes mid-cluster and then moves on; the returned
        resource version is the per-cluster rv map (the reference's
        multiClusterResourceVersion encoding). Returns
        (items, next_continue, resource_version)."""
        everything = self.list(gvk, namespace, labels)
        if cluster is not None:
            # cluster scoping must precede the page window, or the limit
            # counts items the caller never sees
            everything = [(c, o) for c, o in everything if c == cluster]
        start_cluster, after = "", ""
        if continue_token:
            tok = decode_token(continue_token)
            start_cluster = tok.get("cluster", "")
            after = tok.get("after", "")
        # multi-cluster rv covers EVERY cluster contributing to the full
        # list, independent of the page window
        rv_map: dict[str, int] = {}
        for c, obj in everything:
            rv_map[c] = max(rv_map.get(c, 0), obj.meta.resource_version)
        items: list[tuple[str, Resource]] = []
        next_token = ""
        for c, obj in everything:
            key = obj.meta.namespaced_name
            if c < start_cluster or (c == start_cluster and after and key <= after):
                continue
            if limit and len(items) >= limit:
                last_c, last_obj = items[-1]
                next_token = encode_token(
                    {"cluster": last_c, "after": last_obj.meta.namespaced_name}
                )
                break
            items.append((c, obj))
        return items, next_token, encode_token(rv_map)


class SearchController:
    """Builds/refreshes the cache for every ResourceRegistry
    (pkg/search/controller.go)."""

    def __init__(
        self, store: Store, runtime: Runtime, members: MemberClientRegistry,
        indexer=None,
    ) -> None:
        from .backend import InvertedIndexBackend

        self.store = store
        self.members = members
        self.cache = MultiClusterCache()
        # registries with spec.backend == "opensearch" additionally index
        # into the document backend (backendstore/opensearch.go analogue).
        # Inject an HttpIndexerBackend (search/indexer.py) to ship the
        # documents to an EXTERNAL indexer process over the wire instead.
        self.indexer = indexer if indexer is not None else InvertedIndexBackend()
        # registry key -> doc keys it indexed last pass; the diff drives
        # deletions so member-side removals and backend switches don't
        # leave stale documents
        self._indexed: dict[str, set[tuple[str, str, str, str]]] = {}
        self.enabled = True  # addon toggle (karmada-search install state)
        self.worker = runtime.new_worker("search", self._reconcile)
        store.watch("ResourceRegistry", lambda e: self.worker.enqueue(e.key))
        runtime.add_ticker(self._sweep)

    def _sweep(self) -> None:
        if not self.enabled:
            return
        for rr in self.store.list("ResourceRegistry"):
            self.worker.enqueue(rr.meta.namespaced_name)
        # networked backends buffer bulk batches; the periodic sweep drains
        # them so documents don't sit unshipped between watch bursts
        flush = getattr(self.indexer, "flush", None)
        if flush is not None:
            flush()

    def resync(self) -> None:
        """Re-enqueue every registry (addon enable / manual refresh)."""
        self.enabled = True
        self._sweep()

    def disable(self) -> None:
        """addon disable: stop refreshing and drop cached state (the
        uninstall analogue — the aggregated API goes away)."""
        self.enabled = False
        for rr in list(self._indexed):
            for doc in self._indexed.pop(rr, set()):
                self.indexer.delete(*doc)
        # networked backends buffer deletions: ship them now — the sweep
        # no longer runs once disabled
        flush = getattr(self.indexer, "flush", None)
        if flush is not None:
            flush()
        self.cache.clear()

    def _reconcile(self, key: str) -> Optional[str]:
        if not self.enabled:
            return DONE
        rr = self.store.get("ResourceRegistry", key)
        index = rr is not None and rr.spec.backend == "opensearch"
        fresh: set[tuple[str, str, str, str]] = set()
        if rr is not None:
            for cluster in self.store.list("Cluster"):
                if not rr.spec.target_cluster.matches(cluster):
                    continue
                member = self.members.get(cluster.name)
                if member is None or not member.reachable:
                    continue
                for sel in rr.spec.resource_selectors:
                    gvk = f"{sel.get('apiVersion', 'v1')}/{sel.get('kind', '')}"
                    try:
                        for obj in member.list(gvk):
                            self.cache.put(cluster.name, obj)
                            if index:
                                self.indexer.upsert(cluster.name, obj)
                                fresh.add(
                                    (cluster.name, gvk, obj.meta.namespace, obj.meta.name)
                                )
                    except UnreachableError:
                        self.cache.drop_cluster(cluster.name)
                        self.indexer.drop_cluster(cluster.name)
                        fresh = {d for d in fresh if d[0] != cluster.name}
        # documents this registry indexed before but not this pass are gone
        # from the members (or the backend/registry changed) — delete them.
        # An overlapping registry that still wants one re-upserts next sweep.
        for doc in self._indexed.get(key, set()) - fresh:
            self.indexer.delete(*doc)
        if fresh:
            self._indexed[key] = fresh
        else:
            self._indexed.pop(key, None)
        return DONE

    def search(self, query: str = "", **kw) -> list[dict]:
        """Search the document backend (the search API surface)."""
        return self.indexer.search(query, **kw)
