"""Interpreter webhooks: HTTPS extension transport for resource semantics.

The port's own copy of ``karmada_tpu/interpreter/webhook.py``.

Ref: pkg/apis/config/v1alpha1/resourceinterpreterwebhook_types.go
(ResourceInterpreterWebhookConfiguration: clientConfig + RuleWithOperations
+ timeoutSeconds) and interpretercontext_types.go:42-133
(ResourceInterpreterContext request/response: uid, kind, operation, object,
observedObject, replicas, aggregatedStatus → successful, JSONPatch,
replicas/requirements, dependencies, rawStatus, healthy);
pkg/resourceinterpreter/customized/webhook (client + configmanager).

Shape: an extension author runs ``InterpreterWebhookServer`` hosting plain
Python operation handlers behind HTTP(S); the control plane's
``WebhookConfigManager`` watches ``ResourceInterpreterWebhookConfiguration``
objects and registers a ``WebhookInterpreterClient`` per matching
(kind, operation) on the facade's webhook tier — above the embedded
thirdparty corpus, below user in-process customizations (the reference's
chain order, interpreter.go:120-143). Responses patch via RFC 6902
JSONPatch, same as the reference (we apply add/replace/remove).
"""

from __future__ import annotations

from ..utils.clone import clone_json
import json
import ssl
import threading
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from ..api.core import ObjectMeta, Resource, new_uid
from ..api.work import AggregatedStatusItem, NodeClaim, ReplicaRequirements
from ..utils import DONE, Runtime, Store
from .facade import (
    AGGREGATE_STATUS,
    GET_DEPENDENCIES,
    GET_REPLICAS,
    INTERPRET_HEALTH,
    REFLECT_STATUS,
    RETAIN,
    REVISE_REPLICA,
    DependentObjectReference,
    ResourceInterpreter,
)

# ---------------------------------------------------------------------------
# wire (de)serialization


def resource_to_dict(obj: Resource) -> dict:
    return {
        "apiVersion": obj.api_version,
        "kind": obj.kind,
        "metadata": {
            "name": obj.meta.name,
            "namespace": obj.meta.namespace,
            "labels": dict(obj.meta.labels),
            "annotations": dict(obj.meta.annotations),
            "generation": obj.meta.generation,
        },
        "spec": clone_json(obj.spec),
        "status": clone_json(obj.status),
    }


def resource_from_dict(d: dict) -> Resource:
    meta = d.get("metadata") or {}
    return Resource(
        api_version=d.get("apiVersion", ""),
        kind=d.get("kind", ""),
        meta=ObjectMeta(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
            generation=int(meta.get("generation") or 0),
        ),
        spec=d.get("spec") or {},
        status=d.get("status") or {},
    )


def apply_json_patch(doc: dict, patch: list[dict]) -> dict:
    """RFC 6902 add/replace/remove over a JSON document (the subset the
    reference consumes for interpreter responses)."""
    out = clone_json(doc)
    for op in patch:
        path = op.get("path", "")
        parts = [p.replace("~1", "/").replace("~0", "~") for p in path.split("/")[1:]]
        parent = out
        for raw in parts[:-1]:
            key = int(raw) if isinstance(parent, list) else raw
            parent = parent[key]
        last = parts[-1] if parts else ""
        kind = op.get("op")
        if kind in ("add", "replace"):
            if isinstance(parent, list):
                if last == "-":
                    parent.append(op.get("value"))
                elif kind == "add":
                    parent.insert(int(last), op.get("value"))
                else:
                    parent[int(last)] = op.get("value")
            else:
                parent[last] = op.get("value")
        elif kind == "remove":
            if isinstance(parent, list):
                del parent[int(last)]
            else:
                parent.pop(last, None)
        else:
            raise ValueError(f"unsupported JSONPatch op {kind!r}")
    return out


# ---------------------------------------------------------------------------
# configuration API (config/v1alpha1)


@dataclass
class RuleWithOperations:
    """Operations × apiVersions × kinds; '*' wildcards."""

    operations: list[str] = field(default_factory=lambda: ["*"])
    api_versions: list[str] = field(default_factory=lambda: ["*"])
    kinds: list[str] = field(default_factory=lambda: ["*"])

    def matches_target(self, api_version: str, kind: str) -> bool:
        return ("*" in self.api_versions or api_version in self.api_versions) and (
            "*" in self.kinds or kind in self.kinds
        )

    def matches_operation(self, operation: str) -> bool:
        return "*" in self.operations or operation in self.operations


@dataclass
class WebhookClientConfig:
    url: str = ""
    ca_bundle: Optional[bytes] = None


@dataclass
class InterpreterWebhook:
    name: str = ""
    client_config: WebhookClientConfig = field(default_factory=WebhookClientConfig)
    rules: list[RuleWithOperations] = field(default_factory=list)
    timeout_seconds: float = 10.0


@dataclass
class ResourceInterpreterWebhookConfiguration:
    KIND = "ResourceInterpreterWebhookConfiguration"

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: list[InterpreterWebhook] = field(default_factory=list)


# ---------------------------------------------------------------------------
# server side (extension author)


class InterpreterWebhookServer:
    """Hosts operation handlers behind HTTP(S).

    ``handlers`` maps operation name → callable taking the decoded request
    dict and returning response fields (dict). Convenience: ``from_rules``
    builds handlers straight from declarative-style callables."""

    def __init__(
        self,
        handlers: dict[str, Callable[[dict], dict]],
        address: tuple[str, int] = ("127.0.0.1", 0),
        *,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
    ):
        self.handlers = dict(handlers)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                request = body.get("request") or {}
                uid = request.get("uid", "")
                op = request.get("operation", "")
                fn = outer.handlers.get(op)
                if fn is None:
                    response = {
                        "uid": uid,
                        "successful": False,
                        "status": {"message": f"operation {op} not supported"},
                    }
                else:
                    try:
                        fields = fn(request)
                        response = {"uid": uid, "successful": True, **fields}
                    except Exception as exc:  # surfaced to the caller
                        response = {
                            "uid": uid,
                            "successful": False,
                            "status": {"message": str(exc)},
                        }
                payload = json.dumps({"response": response}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer(address, Handler)
        self.scheme = "http"
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True)
            self.scheme = "https"
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.port}/interpret"

    def start(self) -> str:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.url

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


# ---------------------------------------------------------------------------
# client side (control plane)


class WebhookInterpreterClient:
    """POSTs ResourceInterpreterContext requests to one webhook endpoint and
    maps responses back to facade operations (customized/webhook client)."""

    def __init__(self, webhook: InterpreterWebhook):
        self.webhook = webhook
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if webhook.client_config.ca_bundle:
            # full verification including hostname — a CA-signed cert for a
            # different host must not be accepted
            self._ssl_ctx = ssl.create_default_context(
                cadata=webhook.client_config.ca_bundle.decode()
            )

    def _call(self, request_fields: dict) -> dict:
        request = {"uid": new_uid(), **request_fields}
        body = json.dumps({"request": request}).encode()
        req = urllib.request.Request(
            self.webhook.client_config.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(
            req, timeout=self.webhook.timeout_seconds, context=self._ssl_ctx
        ) as resp:
            payload = json.loads(resp.read())
        response = payload.get("response") or {}
        if response.get("uid") != request["uid"]:
            raise RuntimeError("webhook response uid mismatch")
        if not response.get("successful"):
            message = (response.get("status") or {}).get("message", "")
            raise RuntimeError(f"webhook {self.webhook.name} failed: {message}")
        return response

    def _base(self, obj: Resource, operation: str) -> dict:
        return {
            "kind": {"apiVersion": obj.api_version, "kind": obj.kind},
            "name": obj.meta.name,
            "namespace": obj.meta.namespace,
            "operation": operation,
            "object": resource_to_dict(obj),
        }

    def _patched(self, obj: Resource, response: dict) -> Resource:
        patch = response.get("patch")
        if not patch:
            return obj
        if isinstance(patch, str):
            patch = json.loads(patch)
        return resource_from_dict(apply_json_patch(resource_to_dict(obj), patch))

    # -- facade operations --------------------------------------------------

    def get_replicas(self, obj: Resource):
        response = self._call(self._base(obj, "InterpretReplica"))
        requirements = None
        raw = response.get("replicaRequirements")
        if raw:
            from ..utils.quantity import parse_resource_list

            claim = raw.get("nodeClaim") or None
            requirements = ReplicaRequirements(
                # the wire carries ResourceList quantity strings ("500m",
                # "1Gi") or plain ints — parse, don't cast
                resource_request=parse_resource_list(raw.get("resourceRequest") or {}),
                node_claim=NodeClaim(
                    node_selector=dict(claim.get("nodeSelector") or {}),
                    tolerations=list(claim.get("tolerations") or []),
                )
                if claim
                else None,
                namespace=obj.meta.namespace,
                priority_class_name=raw.get("priorityClassName", ""),
            )
        return int(response.get("replicas") or 0), requirements

    def revise_replica(self, obj: Resource, replicas: int) -> Resource:
        response = self._call(
            {**self._base(obj, "ReviseReplica"), "replicas": int(replicas)}
        )
        return self._patched(obj, response)

    def retain(self, desired: Resource, observed: Resource) -> Resource:
        response = self._call(
            {
                **self._base(desired, "Retain"),
                "observedObject": resource_to_dict(observed),
            }
        )
        return self._patched(desired, response)

    def aggregate_status(
        self, obj: Resource, items: list[AggregatedStatusItem]
    ) -> Resource:
        response = self._call(
            {
                **self._base(obj, "AggregateStatus"),
                "aggregatedStatus": [
                    {
                        "clusterName": i.cluster_name,
                        "status": i.status,
                        "applied": i.applied,
                        "health": i.health,
                    }
                    for i in items
                ],
            }
        )
        return self._patched(obj, response)

    def get_dependencies(self, obj: Resource) -> list[DependentObjectReference]:
        response = self._call(self._base(obj, "InterpretDependency"))
        return [
            DependentObjectReference(
                api_version=d.get("apiVersion", "v1"),
                kind=d.get("kind", ""),
                namespace=d.get("namespace", obj.meta.namespace),
                name=d.get("name", ""),
            )
            for d in response.get("dependencies") or []
        ]

    def reflect_status(self, obj: Resource) -> Optional[dict]:
        response = self._call(self._base(obj, "InterpretStatus"))
        return response.get("rawStatus")

    def interpret_health(self, obj: Resource) -> bool:
        response = self._call(self._base(obj, "InterpretHealth"))
        return bool(response.get("healthy"))


# operation name on the wire (reference InterpreterOperation) → facade op +
# client method
_WIRE_OPS = {
    GET_REPLICAS: ("InterpretReplica", "get_replicas"),
    REVISE_REPLICA: ("ReviseReplica", "revise_replica"),
    RETAIN: ("Retain", "retain"),
    AGGREGATE_STATUS: ("AggregateStatus", "aggregate_status"),
    GET_DEPENDENCIES: ("InterpretDependency", "get_dependencies"),
    REFLECT_STATUS: ("InterpretStatus", "reflect_status"),
    INTERPRET_HEALTH: ("InterpretHealth", "interpret_health"),
}


class WebhookConfigManager:
    """Watches ResourceInterpreterWebhookConfiguration and (de)registers
    webhook clients on the facade's webhook tier (customized/webhook
    configmanager analogue)."""

    def __init__(
        self, store: Store, runtime: Runtime, interpreter: ResourceInterpreter
    ) -> None:
        self.store = store
        self.interpreter = interpreter
        self._registered: dict[str, list[tuple[str, str]]] = {}
        self.worker = runtime.new_worker("interpreter-webhook-config", self._reconcile)
        store.watch(
            ResourceInterpreterWebhookConfiguration.KIND,
            lambda e: self.worker.enqueue(e.key),
        )
        # wildcard rules bind per-GVK at reconcile time; a template kind
        # appearing later must re-resolve every configuration
        self._seen_gvks: set[str] = set()
        store.watch("Resource", self._on_resource)

    def _on_resource(self, event) -> None:
        obj = event.obj
        if obj is None:
            return
        gvk = f"{obj.api_version}/{obj.kind}"
        if gvk in self._seen_gvks:
            return
        self._seen_gvks.add(gvk)
        for config in self.store.list(ResourceInterpreterWebhookConfiguration.KIND):
            self.worker.enqueue(config.meta.namespaced_name)

    def _known_gvks(self) -> set[str]:
        """Kinds currently in the store that a wildcard rule could serve."""
        return {f"{r.api_version}/{r.kind}" for r in self.store.list("Resource")}

    def _reconcile(self, key: str) -> Optional[str]:
        config = self.store.get(ResourceInterpreterWebhookConfiguration.KIND, key)
        previous = self._registered.pop(key, [])
        for gvk, op, fn in previous:
            # identity-guarded: an overlapping config that registered later
            # owns the slot now and must not be clobbered
            self.interpreter.deregister_webhook(gvk, op, fn)
        affected_gvks = {gvk for gvk, _, _ in previous}
        if config is None:
            self._resync(affected_gvks)
            return DONE
        regs: list[tuple[str, str, object]] = []
        for webhook in config.webhooks:
            client = WebhookInterpreterClient(webhook)
            for rule in webhook.rules:
                kinds = rule.kinds
                versions = rule.api_versions
                if "*" in kinds or "*" in versions:
                    targets = sorted(
                        g
                        for g in self._known_gvks()
                        if rule.matches_target(*g.rsplit("/", 1))
                    )
                else:
                    targets = [f"{v}/{k}" for v in versions for k in kinds]
                for facade_op, (wire_op, method) in _WIRE_OPS.items():
                    if not rule.matches_operation(wire_op):
                        continue
                    for gvk in targets:
                        fn = getattr(client, method)
                        self.interpreter.register_webhook(gvk, facade_op, fn)
                        regs.append((gvk, facade_op, fn))
        self._registered[key] = regs
        # hook changes re-run the pipeline for affected templates so
        # bindings built with the old semantics are rebuilt (same full
        # resync the declarative configmanager performs)
        self._resync(affected_gvks | {gvk for gvk, _, _ in regs})
        return DONE

    def _resync(self, gvks: set[str]) -> None:
        for res in self.store.list("Resource"):
            if f"{res.api_version}/{res.kind}" in gvks:
                self.store.apply(res)
