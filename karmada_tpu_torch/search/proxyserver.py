"""Aggregated-apiserver proxy passthrough: a real HTTP server for
``/apis/cluster.karmada.io/v1alpha1/clusters/{name}/proxy/{path}``.

The port's own copy of ``karmada_tpu/search/proxyserver.py``.

Ref: pkg/registry/cluster/storage/proxy.go:41-102 (the Connecter serving
the proxy subresource per member cluster) + the unified-auth flow: the
caller authenticates to the karmada control plane, and the proxied member
request carries Impersonate-User / Impersonate-Group headers so the member
enforces the CALLER's identity, not the plane's credentials (the
impersonation-based unified auth the reference builds from aggregated
RBAC). Streaming passes through: log follow responses are chunked as lines
arrive, not buffered (the reference pipes the member response body).

Transport is plain HTTP here (the in-proc plane has no PKI by default);
member routing translates the proxied kube REST path onto the
MemberCluster seam — a real deployment swaps that for the member's
apiserver endpoint, keeping this server's auth/impersonation/streaming
shell.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..interpreter.webhook import resource_to_dict
from ..utils.member import MemberClientRegistry, UnreachableError

PROXY_RE = re.compile(
    r"^/apis/cluster\.karmada\.io/v1alpha1/clusters/(?P<cluster>[^/]+)/proxy"
    r"(?P<path>/.*)?$"
)
# member-side kube REST paths the in-proc seam can serve
POD_LOG_RE = re.compile(
    r"^/api/v1/namespaces/(?P<ns>[^/]+)/pods/(?P<name>[^/]+)/log$"
)
POD_EXEC_RE = re.compile(
    r"^/api/v1/namespaces/(?P<ns>[^/]+)/pods/(?P<name>[^/]+)"
    r"/(?P<verb>exec|attach)$"
)
RESOURCE_RE = re.compile(
    r"^/(?:api/(?P<core_version>v1)|apis/(?P<group>[^/]+)/(?P<version>[^/]+))"
    r"/namespaces/(?P<ns>[^/]+)/(?P<plural>[^/]+)(?:/(?P<name>[^/]+))?$"
)

_PLURALS = {
    "pods": "v1/Pod",
    "configmaps": "v1/ConfigMap",
    "secrets": "v1/Secret",
    "services": "v1/Service",
    "deployments": "apps/v1/Deployment",
    "statefulsets": "apps/v1/StatefulSet",
    "jobs": "batch/v1/Job",
}


class ClusterProxyServer:
    """Serves the proxy subresource over real HTTP with token auth ->
    impersonation headers -> member dispatch."""

    def __init__(
        self,
        members: MemberClientRegistry,
        address: tuple[str, int] = ("127.0.0.1", 0),
        *,
        tokens: Optional[dict[str, tuple[str, list[str]]]] = None,
    ):
        self.members = members
        #: bearer token -> (user, groups): the unified-auth table (the
        #: reference derives identity from the aggregated apiserver's
        #: authentication; agents register tokens via the CSR flow)
        self.tokens = dict(tokens or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet test output
                pass

            def do_GET(self):
                outer._handle(self)

            def do_POST(self):
                # kubectl issues the exec/attach subresource as POST
                outer._handle(self)

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

    # -- request handling --------------------------------------------------

    def _authenticate(self, handler) -> Optional[tuple[str, list[str]]]:
        auth = handler.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return None
        return self.tokens.get(auth[len("Bearer "):])

    def _handle(self, handler) -> None:
        parsed = urlparse(handler.path)
        m = PROXY_RE.match(parsed.path)
        if m is None:
            self._error(handler, 404, "not a cluster proxy path")
            return
        identity = self._authenticate(handler)
        if identity is None:
            self._error(handler, 401, "invalid or missing bearer token")
            return
        user, groups = identity
        cluster = m.group("cluster")
        member = self.members.get(cluster)
        if member is None:
            self._error(handler, 404, f"cluster {cluster} not registered")
            return
        # impersonation-based unified auth: the member request carries the
        # CALLER's identity (proxy.go ConnectCluster sets these from the
        # requesting user before dialing the member)
        impersonation = {
            "Impersonate-User": user,
            "Impersonate-Group": groups,
        }
        sub_path = m.group("path") or "/"
        multi = parse_qs(parsed.query)
        query = {k: v[-1] for k, v in multi.items()}
        try:
            self._dispatch(
                handler, member, sub_path, query, impersonation, multi
            )
        except UnreachableError as e:
            self._fail(handler, 503, str(e))
        except (KeyError, ValueError) as e:
            self._fail(handler, 404 if isinstance(e, KeyError) else 400, str(e))
        except OSError as e:
            # e.g. an exec runtime whose command does not exist
            # (FileNotFoundError from Popen) — a clean 400 beats a
            # dropped connection the client sees as a protocol failure
            self._fail(handler, 400, str(e))

    def _fail(self, handler, code: int, message: str) -> None:
        """Error path that respects an already-started chunked stream: once
        headers are out, a second status line would corrupt the response —
        terminate the stream instead."""
        if getattr(handler, "_streamed", False):
            try:
                handler.wfile.write(b"0\r\n\r\n")
                handler.wfile.flush()
            except OSError:
                pass
            return
        self._error(handler, code, message)

    def _dispatch(
        self, handler, member, path, query, impersonation, multi=None
    ) -> None:
        member.record_proxy_request(path, impersonation)
        log_m = POD_LOG_RE.match(path)
        if log_m is not None:
            self._serve_logs(handler, member, log_m, query)
            return
        exec_m = POD_EXEC_RE.match(path)
        if exec_m is not None:
            self._serve_exec(handler, member, exec_m, multi or {})
            return
        res_m = RESOURCE_RE.match(path)
        if res_m is not None:
            gvk = _PLURALS.get(res_m.group("plural"))
            if gvk is None:
                self._error(handler, 404, f"unknown resource {res_m.group('plural')}")
                return
            ns, name = res_m.group("ns"), res_m.group("name")
            if name:
                obj = member.get(gvk, ns, name)
                if obj is None:
                    self._error(handler, 404, f"{gvk} {ns}/{name} not found")
                    return
                self._json(handler, 200, resource_to_dict(obj))
            else:
                items = [
                    resource_to_dict(o)
                    for o in member.list(gvk)
                    if o.meta.namespace == ns
                ]
                self._json(handler, 200, {"kind": "List", "items": items})
            return
        self._error(handler, 501, f"path {path} not proxied in-proc")

    def _serve_exec(self, handler, member, m, multi) -> None:
        """Streaming exec/attach subresource: output lines chunk out AS
        the member runtime produces them (the SPDY-session analogue —
        ref pkg/karmadactl/exec/exec.go holds the stream through the
        proxy; with SubprocessExecRuntime wired on the member this pipes
        a real OS process end-to-end). ``command`` repeats per argv
        element, kube-style; attach streams with no command."""
        ns, name = m.group("ns"), m.group("name")
        command = list(multi.get("command") or [])
        if m.group("verb") == "attach" or not command:
            # attach = follow the pod's log stream (no new process)
            self._serve_logs(
                handler, member, POD_LOG_RE.match(
                    f"/api/v1/namespaces/{ns}/pods/{name}/log"
                ), {"follow": "true"},
            )
            return
        # pod existence (and member reachability) check BEFORE headers go
        # out so failures are still clean HTTP errors
        stream = member.pod_exec_stream(ns, name, command)
        first = next(stream, None)
        chunk = self._start_chunked(handler)
        try:
            if first is not None:
                chunk(first.encode() + b"\n")
                for line in stream:
                    chunk(line.encode() + b"\n")
        except Exception as exc:  # noqa: BLE001 — headers are out: report
            # the runtime failure IN-BAND (like an SPDY session would) and
            # still terminate the chunked stream cleanly
            chunk(f"error: {exc}".encode() + b"\n")
        chunk(b"")
        handler.wfile.flush()

    def _serve_logs(self, handler, member, m, query) -> None:
        ns, name = m.group("ns"), m.group("name")
        tail = None
        if "tailLines" in query:
            try:
                tail = int(query["tailLines"])
            except ValueError:
                raise ValueError(f"invalid tailLines {query['tailLines']!r}")
        follow = query.get("follow", "") in ("true", "1")
        # ONE snapshot read: computing `seen` from a second read would skip
        # lines appended between the two reads
        all_lines = member.pod_logs(ns, name)
        seen = len(all_lines)
        lines = all_lines if tail is None else (
            all_lines[-tail:] if tail > 0 else []
        )
        chunk = self._start_chunked(handler)
        for line in lines:
            chunk(line.encode() + b"\n")
        if follow:
            # stream lines appended AFTER the snapshot; the in-proc follow
            # holds the pipe open until the member goes quiet for the grace
            # window (a real deployment pipes the member response body
            # until the client disconnects)
            while True:
                fresh = member.wait_pod_logs(ns, name, seen, timeout=0.5)
                if not fresh:
                    break
                for line in fresh:
                    chunk(line.encode() + b"\n")
                seen += len(fresh)
        chunk(b"")  # zero-length chunk terminates the stream
        handler.wfile.flush()

    @staticmethod
    def _start_chunked(handler):
        """Send streaming headers and return the chunk writer (shared by
        the log-follow and exec paths). Marks the handler streamed so
        later failures terminate the stream instead of re-responding."""
        handler.send_response(200)
        handler.send_header("Content-Type", "text/plain")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        handler._streamed = True

        def chunk(data: bytes) -> None:
            handler.wfile.write(f"{len(data):X}\r\n".encode())
            handler.wfile.write(data)
            handler.wfile.write(b"\r\n")
            handler.wfile.flush()

        return chunk

    @staticmethod
    def _json(handler, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    @staticmethod
    def _error(handler, code: int, message: str) -> None:
        body = json.dumps({"error": message}).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
