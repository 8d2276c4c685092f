"""OpenSearch wire-protocol backend store (server + client).

The port's own copy of ``karmada_tpu/search/opensearch.py``.

Ref: pkg/search/backendstore/opensearch.go — the reference's
``backend: opensearch`` store speaks the real OpenSearch REST API:

- index-per-kind named ``{prefix}-{lowercase kind}`` created lazily with
  a mapping (``PUT /{index}``, "already exists" tolerated;
  opensearch.go:250-284);
- one document per object keyed by UID (``PUT /{index}/_doc/{uid}``,
  ``DELETE /{index}/_doc/{uid}``; opensearch.go:158-247), with the
  member cluster recorded in the ``resource.karmada.io/cached-from-cluster``
  annotation and ``spec``/``status`` serialized as JSON STRINGS inside
  the document (opensearch.go:203-218).

This module carries that protocol for the plane:

- ``OpenSearchServer`` — an HTTP process serving the REST subset the
  reference client issues (index create, _doc index/delete, _search
  with query_string/match_all, _delete_by_query, _count, NDJSON _bulk)
  over the in-proc inverted-index document store. It stands in for a
  real OpenSearch node in tests AND documents exactly which slice of
  the API the plane depends on.
- ``OpenSearchBackend`` — a ``BackendStore`` implementation speaking
  that protocol (the opensearch-go client analogue): per-event
  IndexRequest/DeleteRequest semantics, UID document ids, index-per-
  kind, the reference's document shape, plus buffered NDJSON ``_bulk``
  flushing (the reference marks bulk "TODO"; the wire format is the
  standard one so a real OpenSearch accepts it).

Run the server: ``python -m karmada_tpu_torch.search.opensearch``.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from ..api.core import ObjectMeta, Resource
from .backend import InvertedIndexBackend

CACHE_SOURCE_ANNOTATION = "resource.karmada.io/cached-from-cluster"
# cluster/v1alpha1/well_known_constants.go:35 CacheSourceAnnotationKey
DEFAULT_PREFIX = "kubernetes"  # opensearch.go:39 defaultPrefix


def index_name(kind: str, prefix: str = DEFAULT_PREFIX) -> str:
    return f"{prefix}-{kind.lower()}"


def rfc3339(epoch: Optional[float]) -> str:
    """Go time.Format(RFC3339): the zero Time renders as year 1, which is
    exactly what GetCreationTimestamp() yields for objects without one."""
    if not epoch:
        return "0001-01-01T00:00:00Z"
    from datetime import datetime, timezone

    return datetime.fromtimestamp(epoch, timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def doc_id(cluster: str, obj: Resource) -> str:
    """UID when the object has one (the reference's DocumentID), else a
    deterministic key — simulated members don't always stamp UIDs."""
    return obj.meta.uid or (
        f"{cluster}/{obj.api_version}/{obj.kind}/"
        f"{obj.meta.namespace}/{obj.meta.name}"
    )


def resource_to_doc(cluster: str, obj: Resource) -> dict:
    """The reference's document shape (opensearch.go:203-218): metadata
    fields flattened, the cache-source annotation stamped, spec/status as
    JSON strings."""
    annotations = dict(obj.meta.annotations)
    annotations[CACHE_SOURCE_ANNOTATION] = cluster
    return {
        "apiVersion": obj.api_version,
        "kind": obj.kind,
        "metadata": {
            "name": obj.meta.name,
            "namespace": obj.meta.namespace,
            "creationTimestamp": rfc3339(obj.meta.creation_timestamp),
            "labels": dict(obj.meta.labels),
            "annotations": annotations,
            "deletionTimestamp": (
                rfc3339(obj.meta.deletion_timestamp)
                if obj.meta.deletion_timestamp
                else None
            ),
        },
        "spec": json.dumps(obj.spec),
        "status": json.dumps(obj.status),
    }


def doc_to_resource(doc: dict) -> tuple[str, Resource]:
    """(cluster, Resource) from the reference-shaped document."""
    meta = doc.get("metadata") or {}
    annotations = dict(meta.get("annotations") or {})
    cluster = annotations.pop(CACHE_SOURCE_ANNOTATION, "")

    def _parse(v):
        if isinstance(v, str):
            try:
                return json.loads(v) or {}
            except ValueError:
                return {}
        return v or {}

    return cluster, Resource(
        api_version=doc.get("apiVersion", ""),
        kind=doc.get("kind", ""),
        meta=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            labels=dict(meta.get("labels") or {}),
            annotations=annotations,
        ),
        spec=_parse(doc.get("spec")),
        status=_parse(doc.get("status")),
    )


class OpenSearchServer:
    """An OpenSearch-node stand-in: the REST subset the plane speaks,
    over the inverted-index document store."""

    def __init__(self, address: tuple[str, int] = ("127.0.0.1", 0)):
        self.index = InvertedIndexBackend()
        self.indices: dict[str, dict] = {}  # index name -> mapping body
        # _doc id -> (cluster, gvk, namespace, name) for deletes, plus the
        # reverse map so a client that only knows the object coordinates
        # (our BackendStore.delete signature) can address a UID-keyed doc
        # via the deterministic fallback id
        self._ids: dict[str, tuple[str, str, str, str]] = {}
        self._by_key: dict[tuple[str, str, str, str], str] = {}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            # -- helpers --------------------------------------------------
            def _body(self) -> bytes:
                length = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(length) if length else b""

            def _reply(self, status, payload):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _index_doc(self, _index: str, _id: str, doc: dict) -> dict:
                cluster, obj = doc_to_resource(doc)
                key = (
                    cluster, f"{obj.api_version}/{obj.kind}",
                    obj.meta.namespace, obj.meta.name,
                )
                with outer._lock:
                    created = _id not in outer._ids
                    outer._ids[_id] = key
                    outer._by_key[key] = _id
                outer.index.upsert(cluster, obj)
                return {
                    "_index": _index, "_id": _id,
                    "result": "created" if created else "updated",
                }

            def _delete_doc(self, _index: str, _id: str) -> dict:
                with outer._lock:
                    key = outer._ids.pop(_id, None)
                    if key is None:
                        # coordinate-form fallback id: the doc itself may
                        # be keyed by UID — resolve through the reverse map
                        parts = _id.split("/")
                        if len(parts) >= 5:
                            cand = (
                                parts[0], "/".join(parts[1:-2]),
                                parts[-2], parts[-1],
                            )
                            real = outer._by_key.get(cand)
                            if real is not None:
                                key = outer._ids.pop(real, None)
                    if key is not None:
                        outer._by_key.pop(key, None)
                if key is None:
                    return {"_index": _index, "_id": _id,
                            "result": "not_found"}
                outer.index.delete(*key)
                return {"_index": _index, "_id": _id, "result": "deleted"}

            def _search(self, body: dict, limit_default=100) -> dict:
                query = body.get("query") or {}
                size = int(body.get("size", limit_default))
                q = ""
                if "query_string" in query:
                    q = query["query_string"].get("query", "")
                elif "match" in query:
                    q = " ".join(
                        f"{k}:{v}" for k, v in query["match"].items()
                    )
                docs = outer.index.search("" if q == "*" else q, limit=size)
                hits = []
                for d in docs:
                    obj = d["object"]
                    cluster = d.get("cluster", "")
                    key = (
                        cluster, f"{obj.api_version}/{obj.kind}",
                        obj.meta.namespace, obj.meta.name,
                    )
                    with outer._lock:
                        real_id = outer._by_key.get(key)
                    hits.append({
                        "_index": index_name(obj.kind),
                        "_id": real_id or doc_id(cluster, obj),
                        "_source": resource_to_doc(cluster, obj),
                    })
                return {
                    "hits": {
                        "total": {"value": len(hits), "relation": "eq"},
                        "hits": hits,
                    }
                }

            # -- routes ---------------------------------------------------
            def do_PUT(self):
                parts = [p for p in self.path.split("/") if p]
                try:
                    if len(parts) == 1:  # PUT /{index} — create index
                        name = parts[0]
                        with outer._lock:
                            if name in outer.indices:
                                # resource_already_exists, like OpenSearch
                                self._reply(400, {"error": {
                                    "type":
                                    "resource_already_exists_exception",
                                }})
                                return
                            body = self._body()
                            outer.indices[name] = (
                                json.loads(body) if body else {}
                            )
                        self._reply(200, {"acknowledged": True,
                                          "index": name})
                        return
                    if len(parts) == 3 and parts[1] == "_doc":
                        doc = json.loads(self._body())
                        self._reply(
                            200, self._index_doc(parts[0], parts[2], doc)
                        )
                        return
                    self._reply(404, {"error": "no route"})
                except Exception as exc:  # noqa: BLE001 — wire surface
                    self._reply(400, {"error": str(exc)})

            def do_POST(self):
                parts = [p for p in self.path.split("/") if p]
                try:
                    if parts and parts[-1] == "_bulk":
                        self._bulk()
                        return
                    if parts and parts[-1] == "_search":
                        body = self._body()
                        self._reply(
                            200,
                            self._search(json.loads(body) if body else {}),
                        )
                        return
                    if parts and parts[-1] == "_count":
                        self._reply(200, {"count": outer.index.count()})
                        return
                    if len(parts) == 2 and parts[1] == "_delete_by_query":
                        self._delete_by_query(json.loads(self._body()))
                        return
                    if len(parts) == 3 and parts[1] == "_doc":
                        doc = json.loads(self._body())
                        self._reply(
                            200, self._index_doc(parts[0], parts[2], doc)
                        )
                        return
                    self._reply(404, {"error": "no route"})
                except Exception as exc:  # noqa: BLE001 — wire surface
                    self._reply(400, {"error": str(exc)})

            def do_DELETE(self):
                parts = [p for p in self.path.split("/") if p]
                try:
                    if len(parts) == 3 and parts[1] == "_doc":
                        self._reply(
                            200, self._delete_doc(parts[0], parts[2])
                        )
                        return
                    self._reply(404, {"error": "no route"})
                except Exception as exc:  # noqa: BLE001 — wire surface
                    self._reply(400, {"error": str(exc)})

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/":
                    self._reply(200, {"tagline": "opensearch stand-in"})
                elif parsed.path.endswith("/_count"):
                    self._reply(200, {"count": outer.index.count()})
                else:
                    self._reply(404, {"error": "no route"})

            def _bulk(self):
                """NDJSON _bulk: alternating action and source lines
                (the standard wire format; delete actions carry no
                source line). Item results mirror OpenSearch's."""
                lines = [
                    ln for ln in self._body().decode().split("\n") if ln
                ]
                items = []
                errors = False
                i = 0
                while i < len(lines):
                    action = json.loads(lines[i])
                    i += 1
                    if "index" in action or "create" in action:
                        meta = action.get("index") or action.get("create")
                        doc = json.loads(lines[i])
                        i += 1
                        res = self._index_doc(
                            meta.get("_index", ""), meta.get("_id", ""), doc
                        )
                        items.append({"index": {**res, "status": 200}})
                    elif "delete" in action:
                        meta = action["delete"]
                        res = self._delete_doc(
                            meta.get("_index", ""), meta.get("_id", "")
                        )
                        items.append({"delete": {**res, "status": 200}})
                    else:
                        items.append({"unknown": {"status": 400}})
                        errors = True
                self._reply(200, {"errors": errors, "items": items})

            def _delete_by_query(self, body: dict):
                """The subset drop_cluster needs: match on the cache-
                source annotation."""
                query = (body.get("query") or {}).get("match") or {}
                cluster = query.get(
                    f"metadata.annotations.{CACHE_SOURCE_ANNOTATION}", ""
                )
                if not cluster:
                    self._reply(400, {"error": "unsupported query"})
                    return
                with outer._lock:
                    gone = [
                        _id for _id, key in outer._ids.items()
                        if key[0] == cluster
                    ]
                    for _id in gone:
                        key = outer._ids.pop(_id, None)
                        if key is not None:
                            outer._by_key.pop(key, None)
                outer.index.drop_cluster(cluster)
                self._reply(200, {"deleted": len(gone)})

        self._httpd = ThreadingHTTPServer(address, Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class OpenSearchBackend:
    """``BackendStore`` over the OpenSearch REST protocol (the
    opensearch-go client analogue): lazily-created index per kind, UID
    document ids, the reference's document shape, buffered NDJSON
    ``_bulk`` flushes. Points at ``OpenSearchServer`` in tests and at a
    real OpenSearch node in production — the wire is the same."""

    # the index-create body, field for field the reference's ``mapping``
    # const (opensearch.go:41-116): 1 shard / 0 replicas, searchable
    # name/namespace with 256-char keyword subfields, annotations/labels
    # stored-not-indexed, and spec/status disabled objects (the documents
    # carry them as JSON strings)
    MAPPING = {
        "settings": {
            "index": {"number_of_shards": 1, "number_of_replicas": 0}
        },
        "mappings": {
            "properties": {
                "apiVersion": {"type": "text"},
                "kind": {"type": "text"},
                "metadata": {
                    "properties": {
                        "annotations": {"type": "object", "enabled": False},
                        "creationTimestamp": {"type": "text"},
                        "deletionTimestamp": {"type": "text"},
                        "labels": {"type": "object", "enabled": False},
                        "name": {
                            "type": "text",
                            "fields": {
                                "keyword": {
                                    "type": "keyword", "ignore_above": 256
                                }
                            },
                        },
                        "namespace": {
                            "type": "text",
                            "fields": {
                                "keyword": {
                                    "type": "keyword", "ignore_above": 256
                                }
                            },
                        },
                        "ownerReferences": {"type": "text"},
                        "resourceVersion": {
                            "type": "text",
                            "fields": {
                                "keyword": {
                                    "type": "keyword", "ignore_above": 256
                                }
                            },
                        },
                    }
                },
                "spec": {"type": "object", "enabled": False},
                "status": {"type": "object", "enabled": False},
            }
        },
    }

    def __init__(
        self,
        target: str,
        *,
        prefix: str = DEFAULT_PREFIX,
        batch_size: int = 64,
        timeout_seconds: float = 5.0,
    ):
        self.target = target
        self.prefix = prefix
        self.batch_size = batch_size
        self.timeout = timeout_seconds
        self._indices: set[str] = set()
        self._buffer: list[str] = []  # NDJSON lines
        # (cluster, gvk, ns, name) -> indexed _id: deletes only know the
        # object coordinates while documents key by UID on the node, so
        # the client remembers what it indexed under which id — against a
        # REAL OpenSearch the coordinate-form fallback id would address
        # nothing (the reference's informer always has the object, so its
        # deletes carry the UID; ours reconstructs it from this map)
        self._doc_ids: dict[tuple[str, str, str, str], str] = {}
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self.dropped = 0

    # -- HTTP helpers -------------------------------------------------------

    def _request(self, method: str, path: str, body: Optional[bytes] = None,
                 content_type: str = "application/json"):
        req = urllib.request.Request(
            f"http://{self.target}{path}", data=body, method=method,
            headers={"Content-Type": content_type},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read() or b"{}")

    def _ensure_index(self, kind: str) -> str:
        name = index_name(kind, self.prefix)
        if name in self._indices:
            return name
        try:
            self._request(
                "PUT", f"/{name}", json.dumps(self.MAPPING).encode()
            )
        except urllib.error.HTTPError as e:
            # OpenSearch answers 400 for validation failures too — only
            # the already-exists TYPE is benign (opensearch.go:264 checks
            # the exception type, not the status code)
            try:
                err = json.loads(e.read()).get("error") or {}
                etype = err.get("type", "") if isinstance(err, dict) else ""
            except Exception:  # noqa: BLE001 — wire surface
                etype = ""
            if etype != "resource_already_exists_exception":
                raise
        self._indices.add(name)
        return name

    # -- BackendStore -------------------------------------------------------

    def upsert(self, cluster: str, obj: Resource) -> None:
        name = self._ensure_index(obj.kind)
        _id = doc_id(cluster, obj)
        with self._lock:
            self._doc_ids[(
                cluster, f"{obj.api_version}/{obj.kind}",
                obj.meta.namespace, obj.meta.name,
            )] = _id
        action = json.dumps({"index": {"_index": name, "_id": _id}})
        source = json.dumps(resource_to_doc(cluster, obj))
        self._enqueue([action, source])

    def delete(self, cluster: str, gvk: str, namespace: str, name: str) -> None:
        kind = gvk.rsplit("/", 1)[-1]
        key = (cluster, gvk, namespace, name)
        with self._lock:
            _id = self._doc_ids.pop(key, None)
        if _id is None:
            # never indexed by this client: the deterministic fallback id
            obj = Resource(
                api_version=gvk.rsplit("/", 1)[0], kind=kind,
                meta=ObjectMeta(name=name, namespace=namespace),
            )
            _id = doc_id(cluster, obj)
        self._enqueue([json.dumps({"delete": {
            "_index": index_name(kind, self.prefix),
            "_id": _id,
        }})])

    def drop_cluster(self, cluster: str) -> None:
        self.flush()
        with self._lock:
            for key in [k for k in self._doc_ids if k[0] == cluster]:
                self._doc_ids.pop(key, None)
        # wildcard across every kind index (a real node 404s a literal
        # nonexistent index; '{prefix}-*' is the standard multi-index form)
        self._request(
            "POST", f"/{self.prefix}-*/_delete_by_query",
            json.dumps({"query": {"match": {
                f"metadata.annotations.{CACHE_SOURCE_ANNOTATION}": cluster,
            }}}).encode(),
        )

    def _enqueue(self, lines: list[str]) -> None:
        with self._lock:
            self._buffer.extend(lines)
            should = len(self._buffer) >= 2 * self.batch_size
        if should:
            self.flush()

    def flush(self) -> bool:
        with self._send_lock:
            with self._lock:
                if not self._buffer:
                    return True
                batch, self._buffer = self._buffer, []
            body = ("\n".join(batch) + "\n").encode()
            try:
                resp = self._request(
                    "POST", "/_bulk", body, "application/x-ndjson"
                )
                if resp.get("errors"):
                    self.dropped += sum(
                        1
                        for item in resp.get("items", [])
                        for v in item.values()
                        if v.get("status", 200) >= 400
                    )
                return True
            except urllib.error.HTTPError:
                # count OPERATIONS, not NDJSON lines (index ops carry an
                # action line AND a source line)
                self.dropped += sum(
                    1
                    for ln in batch
                    if ln.startswith(('{"index"', '{"create"', '{"delete"'))
                )
                return False
            except (urllib.error.URLError, OSError):
                with self._lock:
                    self._buffer = batch + self._buffer  # retry in order
                return False

    # -- queries ------------------------------------------------------------

    def search(
        self,
        query: str = "",
        *,
        clusters: Optional[Iterable[str]] = None,
        limit: int = 100,
    ) -> list[dict]:
        self.flush()
        body = {
            "size": limit,
            "query": (
                {"query_string": {"query": query}}
                if query
                else {"match_all": {}}
            ),
        }
        resp = self._request("POST", "/_search", json.dumps(body).encode())
        out = []
        want = set(clusters) if clusters else None
        for hit in resp.get("hits", {}).get("hits", []):
            cluster, obj = doc_to_resource(hit.get("_source") or {})
            if want is not None and cluster not in want:
                continue
            out.append({
                "cluster": cluster, "gvk": f"{obj.api_version}/{obj.kind}",
                "namespace": obj.meta.namespace, "name": obj.meta.name,
                "object": obj,
            })
        return out

    def count(self) -> int:
        self.flush()
        return int(self._request("GET", "/_count").get("count", 0))


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--address", default="127.0.0.1:0")
    args = p.parse_args(argv)
    from ..utils.net import parse_hostport

    server = OpenSearchServer(parse_hostport(args.address, default_host=""))
    bound = server.start()
    print(f"opensearch stand-in listening on port {bound}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
