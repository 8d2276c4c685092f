"""Search backend stores: pluggable indexers behind ResourceRegistry.

The port's own copy of ``karmada_tpu/search/backend.py``.

Ref: pkg/search/backendstore (interface.go: BackendStore with
ResourceEventHandlerFuncs — OnAdd/OnUpdate/OnDelete per registry; default
in-memory cacher, opensearch.go: documents indexed per cluster with
bulk upserts and deletes, queried by the search API).

The reference's OpenSearch backend ships objects to an external indexer as
JSON documents keyed ``{cluster}/{namespace}/{name}``. The analogue here is
an in-process inverted-index document store with the same document shape and
life-cycle (upsert/delete per watch event, drop-by-cluster on cluster
removal) and a query surface covering the search API's needs: term match
over tokenized fields, field-scoped terms (``kind:Deployment``,
``label:app=web``), prefix match, and conjunction. An external OpenSearch
can implement the same ``BackendStore`` protocol against a real cluster.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Iterable, Optional, Protocol

from ..api.core import Resource


class BackendStore(Protocol):
    """backendstore.BackendStore: watch-event sink + lifecycle."""

    def upsert(self, cluster: str, obj: Resource) -> None: ...

    def delete(self, cluster: str, gvk: str, namespace: str, name: str) -> None: ...

    def drop_cluster(self, cluster: str) -> None: ...


def _doc_id(cluster: str, gvk: str, namespace: str, name: str) -> str:
    return f"{cluster}/{gvk}/{namespace}/{name}"


def _tokenize(text: str) -> list[str]:
    out, cur = [], []
    for ch in text.lower():
        if ch.isalnum():
            cur.append(ch)
        else:
            if cur:
                out.append("".join(cur))
            cur = []
    if cur:
        out.append("".join(cur))
    return out


class InvertedIndexBackend:
    """The opensearch.go analogue: objects as documents in an inverted
    index; terms carry optional field scopes."""

    def __init__(self) -> None:
        self._docs: dict[str, dict] = {}
        self._index: dict[str, set[str]] = defaultdict(set)
        self._by_cluster: dict[str, set[str]] = defaultdict(set)
        self._lock = threading.Lock()

    # -- BackendStore -------------------------------------------------------

    def upsert(self, cluster: str, obj: Resource) -> None:
        gvk = f"{obj.api_version}/{obj.kind}"
        doc_id = _doc_id(cluster, gvk, obj.meta.namespace, obj.meta.name)
        doc = {
            "cluster": cluster,
            "apiVersion": obj.api_version,
            "kind": obj.kind,
            "namespace": obj.meta.namespace,
            "name": obj.meta.name,
            "labels": dict(obj.meta.labels),
            "annotations": dict(obj.meta.annotations),
            "object": obj,
        }
        terms = set()
        for field_name in ("cluster", "kind", "namespace", "name"):
            for tok in _tokenize(doc[field_name]):
                terms.add(tok)
                terms.add(f"{field_name}:{tok}")
        for k, v in obj.meta.labels.items():
            terms.add(f"label:{k.lower()}={v.lower()}")
            terms.update(_tokenize(v))
        with self._lock:
            self._remove_locked(doc_id)
            self._docs[doc_id] = doc
            self._by_cluster[cluster].add(doc_id)
            for t in terms:
                self._index[t].add(doc_id)
            doc["_terms"] = terms

    def delete(self, cluster: str, gvk: str, namespace: str, name: str) -> None:
        with self._lock:
            self._remove_locked(_doc_id(cluster, gvk, namespace, name))

    def drop_cluster(self, cluster: str) -> None:
        with self._lock:
            for doc_id in list(self._by_cluster.get(cluster, ())):
                self._remove_locked(doc_id)
            self._by_cluster.pop(cluster, None)

    # called-with-lock-held helper (the ``_locked`` suffix contract):
    # every caller above holds self._lock
    # graftlint: disable=GL004,GL011
    def _remove_locked(self, doc_id: str) -> None:
        doc = self._docs.pop(doc_id, None)
        if doc is None:
            return
        for t in doc.get("_terms", ()):
            bucket = self._index.get(t)
            if bucket:
                bucket.discard(doc_id)
                if not bucket:
                    del self._index[t]
        self._by_cluster[doc["cluster"]].discard(doc_id)

    # -- query surface ------------------------------------------------------

    def search(
        self,
        query: str = "",
        *,
        clusters: Optional[Iterable[str]] = None,
        limit: int = 100,
    ) -> list[dict]:
        """Conjunction of query terms. Term forms: bare token, ``field:tok``
        (cluster/kind/namespace/name), ``label:k=v``, trailing ``*`` prefix."""
        with self._lock:
            candidates: Optional[set[str]] = None
            for raw in query.split():
                term = raw.lower()
                if term.endswith("*"):
                    prefix = term[:-1]
                    matched: set[str] = set()
                    for t, ids in self._index.items():
                        if t.startswith(prefix):
                            matched |= ids
                else:
                    matched = set(self._index.get(term, ()))
                candidates = matched if candidates is None else candidates & matched
            if candidates is None:  # empty query = everything
                candidates = set(self._docs)
            if clusters is not None:
                allowed = set(clusters)
                candidates = {d for d in candidates if self._docs[d]["cluster"] in allowed}
            docs = sorted(candidates)[:limit]
            return [
                {k: v for k, v in self._docs[d].items() if not k.startswith("_")}
                for d in docs
            ]

    def count(self) -> int:
        with self._lock:
            return len(self._docs)
