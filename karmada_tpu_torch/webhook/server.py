"""Admission webhook as an HTTP(S) service: the port's own copy of
``karmada_tpu/webhook/server.py``.

Ref: cmd/webhook/app/webhook.go:161-183 — the reference's 22 admission
handlers run in a separate TLS process the apiserver calls per write. Here
the SAME ``AdmissionChain`` (webhook/chain.py) that normally hooks the
Store in-process is hosted behind HTTP(S) (the interpreter webhook's
transport, interpreter/webhook.py), and ``RemoteAdmission`` plugs the wire
round-trip back into a Store's admission seam: every apply/delete POSTs an
AdmissionReview-style document, mutations come back serialized, denials
raise exactly like the in-proc chain. ``POST /convert`` serves the CRD
conversion webhook (``api/versioning.handle_conversion_review``). Run:
``python -m karmada_tpu_torch.webhook.server`` (it builds no engine, so it
takes no ``--device``).
"""

from __future__ import annotations

import json
import ssl
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..bus.service import decode_object, encode_object
from .chain import AdmissionChain, default_admission_chain

#: env knob for RemoteAdmission's per-request read deadline
ADMISSION_TIMEOUT_ENV = "KARMADA_TPU_ADMISSION_TIMEOUT"


class AdmissionDenied(Exception):
    pass


class AdmissionWebhookServer:
    """Hosts an AdmissionChain behind POST /admit.

    Request:  {"kind", "operation": "CREATE"|"DELETE", "object": <json>}
    Response: {"allowed": bool, "object": <mutated json>, "message": str}
    """

    def __init__(
        self,
        chain: Optional[AdmissionChain] = None,
        address: tuple[str, int] = ("127.0.0.1", 0),
        *,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
    ):
        self.chain = chain or default_admission_chain()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                if self.path == "/convert":
                    # CRD conversion-webhook contract (ConversionReview
                    # in/out) — the multi-version seam's wire surface
                    # (ref: conversion strategy Webhook; the reference
                    # serves work/v1alpha1 <-> v1alpha2 this way)
                    from ..api.versioning import handle_conversion_review

                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        review = json.loads(self.rfile.read(length) or b"{}")
                        self._reply(200, handle_conversion_review(review))
                    except Exception as exc:  # noqa: BLE001 — wire surface
                        self._reply(400, {"error": str(exc)})
                    return
                if self.path != "/admit":
                    self._reply(404, {"allowed": False, "message": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    kind = body["kind"]
                    obj = decode_object(kind, json.dumps(body["object"]))
                    if body.get("operation") == "DELETE":
                        outer.chain.admit_delete(kind, obj)
                    else:
                        outer.chain.admit(kind, obj)
                    self._reply(
                        200,
                        {
                            "allowed": True,
                            "object": json.loads(encode_object(obj)),
                        },
                    )
                except Exception as exc:  # noqa: BLE001 — wire surface
                    self._reply(200, {"allowed": False, "message": str(exc)})

            def _reply(self, status, payload):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(address, Handler)
        self.scheme = "http"
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True
            )
            self.scheme = "https"
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.port}/admit"

    def start(self) -> str:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.url

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class RemoteAdmission:
    """Store admission hooks that round-trip through the webhook process.

    ``Store(admission=remote.admit, delete_admission=remote.admit_delete)``
    makes every control-plane write call the external webhook — the
    reference's apiserver->webhook TLS hop. Mutations are copied back onto
    the caller's object; a denial (or a malformed response) raises;
    ``fail_open`` mirrors failurePolicy=Ignore for unreachable webhooks
    (default False = fail closed, the reference's default for its own
    policies)."""

    #: A freshly-spawned webhook process on an oversubscribed machine
    #: can take longer than the old fixed 5s to answer its FIRST request
    #: (TLS handshake + interpreter warm-up behind a full test suite) —
    #: the known spawn-family flake. The deadline is env-tunable
    #: (ADMISSION_TIMEOUT_ENV) and every request gets ONE bounded retry
    #: on an unreachable/timed-out channel (admission is a pure
    #: check/mutate, so the retry is idempotent by construction).
    TIMEOUT_ENV = ADMISSION_TIMEOUT_ENV

    def __init__(
        self,
        url: str,
        *,
        ca_bundle: Optional[bytes] = None,
        timeout_seconds: Optional[float] = None,
        fail_open: bool = False,
    ):
        import os

        self.url = url
        if timeout_seconds is None:
            raw = os.environ.get(ADMISSION_TIMEOUT_ENV, "").strip()
            try:
                timeout_seconds = float(raw) if raw else 5.0
            except ValueError:
                timeout_seconds = 5.0
        self.timeout = timeout_seconds
        self.fail_open = fail_open
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if ca_bundle is not None:
            self._ssl_ctx = ssl.create_default_context(cadata=ca_bundle.decode())

    #: transport retries per request (bounded: exactly one re-dial)
    RETRIES = 1

    def _post(self, kind: str, obj, operation: str):
        payload = json.dumps(
            {
                "kind": kind,
                "operation": operation,
                "object": json.loads(encode_object(obj)),
            }
        ).encode()
        body = None
        last_exc: Optional[Exception] = None
        for attempt in range(1 + self.RETRIES):
            req = urllib.request.Request(
                self.url, data=payload,
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=self.timeout, context=self._ssl_ctx
                ) as resp:
                    body = json.loads(resp.read())
                break
            except (urllib.error.URLError, OSError) as exc:
                last_exc = exc
        if body is None:
            if self.fail_open:
                return None
            raise AdmissionDenied(
                f"admission webhook unreachable: {last_exc}"
            )
        if not body.get("allowed"):
            raise ValueError(body.get("message", "admission denied"))
        return body.get("object")

    def admit(self, kind: str, obj) -> None:
        mutated = self._post(kind, obj, "CREATE")
        if mutated is not None:
            new = decode_object(kind, json.dumps(mutated))
            obj.__dict__.update(new.__dict__)

    def admit_delete(self, kind: str, obj) -> None:
        self._post(kind, obj, "DELETE")


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--address", default="127.0.0.1:0")
    p.add_argument("--certfile", default="")
    p.add_argument("--keyfile", default="")
    args = p.parse_args(argv)
    from ..utils.net import parse_hostport

    server = AdmissionWebhookServer(
        address=parse_hostport(args.address, default_host=""),
        certfile=args.certfile or None,
        keyfile=args.keyfile or None,
    )
    url = server.start()
    # the parent process scrapes this line to learn the bound endpoint
    print(f"admission webhook listening on port {server.port} ({url})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
