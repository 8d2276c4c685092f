"""Networked search indexer: documents shipped over a wire protocol.
The port's own copy of ``karmada_tpu/search/indexer.py``.

Ref: pkg/search/backendstore/opensearch.go — the reference's OpenSearch
backend POSTs bulk upsert/delete document batches to an EXTERNAL indexer
over HTTP and the search API queries it back. This module is that shape
for the TPU-native plane:

- ``IndexerServer``: a standalone HTTP process hosting the inverted-index
  document store (the OpenSearch stand-in). Endpoints: POST /bulk (batched
  upsert/delete/drop_cluster operations), GET /search, GET /count,
  GET /healthz. Run: ``python -m karmada_tpu_torch.search.indexer`` (it
  builds no engine, so it takes no ``--device``).
- ``HttpIndexerBackend``: a ``BackendStore`` implementation that buffers
  watch events and ships them as bulk batches (opensearch.go's
  BulkIndexer), flushing on batch size or explicitly; queries round-trip
  over HTTP. Drop-in for ``SearchController``'s indexer seam — the
  ResourceRegistry's ``backend: opensearch`` documents land in the remote
  process instead of the in-proc index.

Unreachable-indexer semantics: bulk flushes buffer and retry on the next
flush (the reference's BulkIndexer also queues); queries raise.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional
from urllib.parse import parse_qs, urlparse

from ..api.core import Resource
from .backend import InvertedIndexBackend


def _obj_to_doc(obj: Resource) -> dict:
    from ..bus.service import encode_object

    return json.loads(encode_object(obj))


def _doc_to_obj(doc: dict) -> Resource:
    from ..bus.service import decode_object

    return decode_object("Resource", json.dumps(doc))


class IndexerServer:
    """The external indexer process (OpenSearch stand-in)."""

    def __init__(self, address: tuple[str, int] = ("127.0.0.1", 0)):
        self.index = InvertedIndexBackend()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                if self.path != "/bulk":
                    self._reply(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                # two-phase: validate + decode the WHOLE batch into thunks
                # first, then apply. A malformed op must not leave an
                # applied prefix behind (the old sequential form both
                # persisted the prefix and made the client count the whole
                # batch as poison); on rejection nothing is applied and the
                # failing index is reported so the client drops only it.
                try:
                    ops = json.loads(self.rfile.read(length) or b"[]")
                    if not isinstance(ops, list):
                        raise ValueError("bulk body must be a JSON array")
                except Exception as exc:  # noqa: BLE001 — wire surface
                    self._reply(400, {"error": str(exc), "failed_index": -1})
                    return
                thunks = []
                for i, op in enumerate(ops):
                    try:
                        kind = op.get("op")
                        if kind == "upsert":
                            cluster, obj = op["cluster"], _doc_to_obj(
                                op["object"]
                            )
                            thunks.append(
                                lambda c=cluster, o=obj: outer.index.upsert(
                                    c, o
                                )
                            )
                        elif kind == "delete":
                            a = (
                                op["cluster"], op["gvk"],
                                op["namespace"], op["name"],
                            )
                            thunks.append(
                                lambda a=a: outer.index.delete(*a)
                            )
                        elif kind == "drop_cluster":
                            cluster = op["cluster"]
                            thunks.append(
                                lambda c=cluster: outer.index.drop_cluster(c)
                            )
                        else:
                            raise ValueError(f"unknown op {kind!r}")
                    except Exception as exc:  # noqa: BLE001 — wire surface
                        self._reply(
                            400, {"error": str(exc), "failed_index": i}
                        )
                        return
                applied = 0
                try:
                    for t in thunks:
                        t()
                        applied += 1
                except Exception as exc:  # noqa: BLE001 — an apply-phase
                    # failure must still produce an HTTP response: a dropped
                    # connection reads as TRANSIENT to the client, which
                    # would requeue (and partially re-apply) the same batch
                    # forever. 500 + no failed_index → the client drops the
                    # batch and counts it, making progress.
                    self._reply(
                        500, {"error": str(exc), "applied": applied}
                    )
                    return
                self._reply(200, {"applied": applied})

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/healthz":
                    self._reply(200, {"ok": True})
                elif parsed.path == "/count":
                    self._reply(200, {"count": outer.index.count()})
                elif parsed.path == "/search":
                    q = parse_qs(parsed.query)
                    clusters = q.get("cluster")
                    docs = outer.index.search(
                        q.get("q", [""])[0],
                        clusters=clusters,
                        limit=int(q.get("limit", ["100"])[0]),
                    )
                    out = []
                    for d in docs:
                        d = dict(d)
                        d["object"] = _obj_to_doc(d["object"])
                        out.append(d)
                    self._reply(200, {"hits": out})
                else:
                    self._reply(404, {"error": "not found"})

            def _reply(self, status, payload):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

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


class HttpIndexerBackend:
    """BackendStore over the wire, with bulk buffering.

    Satisfies the same Protocol as ``InvertedIndexBackend`` (upsert /
    delete / drop_cluster / search / count); watch events buffer locally
    and flush as one POST /bulk per ``batch_size`` events (or on
    ``flush()``), mirroring opensearch.go's BulkIndexer."""

    def __init__(
        self,
        target: str,
        *,
        batch_size: int = 64,
        timeout_seconds: float = 5.0,
    ):
        self.target = target
        self.batch_size = batch_size
        self.timeout = timeout_seconds
        self._buffer: list[dict] = []
        self._lock = threading.Lock()
        # serializes take+POST+requeue so concurrent flushes cannot ship
        # batches out of order (a delete overtaking an older upsert would
        # resurrect the document remotely)
        self._send_lock = threading.Lock()
        self.dropped = 0  # poison ops rejected by the server (HTTP 4xx)

    # -- BackendStore -------------------------------------------------------

    def upsert(self, cluster: str, obj: Resource) -> None:
        self._enqueue(
            {"op": "upsert", "cluster": cluster, "object": _obj_to_doc(obj)}
        )

    def delete(self, cluster: str, gvk: str, namespace: str, name: str) -> None:
        self._enqueue(
            {
                "op": "delete", "cluster": cluster, "gvk": gvk,
                "namespace": namespace, "name": name,
            }
        )

    def drop_cluster(self, cluster: str) -> None:
        self._enqueue({"op": "drop_cluster", "cluster": cluster})

    def _enqueue(self, op: dict) -> None:
        with self._lock:
            self._buffer.append(op)
            should_flush = len(self._buffer) >= self.batch_size
        if should_flush:
            self.flush()

    def flush(self) -> bool:
        """Ship the buffered batch. Transient failures (connection/timeout)
        requeue the batch for the next flush, in order (BulkIndexer retry
        semantics). An HTTP rejection is atomic server-side (nothing was
        applied): the reported ``failed_index`` op is POISON — dropped and
        counted — and the rest of the batch retries, so one malformed op
        neither persists a prefix nor discards its batchmates. Returns
        success."""
        with self._send_lock:
            with self._lock:
                if not self._buffer:
                    return True
                batch, self._buffer = self._buffer, []
            while batch:
                req = urllib.request.Request(
                    f"http://{self.target}/bulk",
                    data=json.dumps(batch).encode(),
                    headers={"Content-Type": "application/json"},
                )
                try:
                    with urllib.request.urlopen(
                        req, timeout=self.timeout
                    ) as resp:
                        json.loads(resp.read())
                    return True
                except urllib.error.HTTPError as exc:
                    try:
                        bad = json.loads(exc.read()).get("failed_index", -1)
                    except Exception:  # noqa: BLE001 — wire surface
                        bad = -1
                    if 0 <= bad < len(batch):
                        self.dropped += 1
                        batch = batch[:bad] + batch[bad + 1 :]
                        continue  # retry the rest without the poison op
                    self.dropped += len(batch)  # unidentifiable rejection
                    return False
                except (urllib.error.URLError, OSError):
                    with self._lock:
                        # retry later, in order
                        self._buffer = batch + self._buffer
                    return False
            return True

    # -- queries ------------------------------------------------------------

    def search(
        self,
        query: str = "",
        *,
        clusters: Optional[Iterable[str]] = None,
        limit: int = 100,
    ) -> list[dict]:
        self.flush()
        params = [("q", query), ("limit", str(limit))]
        for c in clusters or ():
            params.append(("cluster", c))
        qs = "&".join(
            f"{k}={urllib.parse.quote(str(v))}" for k, v in params
        )
        with urllib.request.urlopen(
            f"http://{self.target}/search?{qs}", timeout=self.timeout
        ) as resp:
            hits = json.loads(resp.read())["hits"]
        for d in hits:
            d["object"] = _doc_to_obj(d["object"])
        return hits

    def count(self) -> int:
        self.flush()
        with urllib.request.urlopen(
            f"http://{self.target}/count", timeout=self.timeout
        ) as resp:
            return json.loads(resp.read())["count"]


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--address", default="127.0.0.1:0")
    args = p.parse_args(argv)
    from ..utils.net import parse_hostport

    server = IndexerServer(parse_hostport(args.address, default_host=""))
    bound = server.start()
    print(f"indexer listening on port {bound}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
