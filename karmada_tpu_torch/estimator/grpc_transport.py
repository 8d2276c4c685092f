"""Real gRPC transport for the estimator channel: the port's own copy of
``karmada_tpu/estimator/grpc_transport.py``.

Ref: pkg/estimator/server/server.go:171-173 (mTLS gRPC serve),
pkg/util/grpcconnection/config.go (client/server TLS config: server cert +
key, optional client-auth CA; insecure fallback), client/cache.go (per-
cluster connection cache) and client/service.go (discovery by naming
convention ``{prefix}-{cluster}:port``).

grpc_tools (python codegen plugin) is not in the image, so the servicer and
stub are wired by hand over the protoc-generated ``estimator_pb2`` messages
using grpc's generic handler API — same wire format a generated stub would
speak. The connection object satisfies the ``call(method, request)`` seam of
``EstimatorClientPool``, so the scheduler side is transport-agnostic: swap
the resolver and the same fan-out runs in-proc or over the network.

``grpc`` and the ``_pb2`` modules are imported inside the functions and
classes that use them: ``RemoteAccurateEstimator`` (and this module) import
without either, so an estimator behind the in-process
``service.EstimatorConnection`` runs where grpc and protobuf are absent.
The service and message names on the wire (``karmada_tpu.estimator.*``) are
the JAX package's, so either package's client reaches either's server.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

from .service import (
    ClusterBatchResult,
    EstimatorService,
    GetGenerationsRequest,
    GetGenerationsResponse,
    MaxAvailableReplicasBatchRequest,
    MaxAvailableReplicasBatchResponse,
    MaxAvailableReplicasRequest,
    MaxAvailableReplicasResponse,
    UnschedulableReplicasRequest,
    UnschedulableReplicasResponse,
    UnsupportedMethodError,
)

SERVICE_NAME = "karmada_tpu.estimator.Estimator"


def _protos():
    """(estimator_pb2, estimator_batch_pb2), imported on first use."""
    from .proto import estimator_batch_pb2, estimator_pb2

    return estimator_pb2, estimator_batch_pb2


def _req_to_pb(req: MaxAvailableReplicasRequest) -> "pb.MaxAvailableReplicasRequest":
    pb, _ = _protos()
    msg = pb.MaxAvailableReplicasRequest(cluster=req.cluster)
    rr = msg.replica_requirements
    for k, v in req.resource_request.items():
        rr.resource_request[k] = int(v)
    rr.namespace = req.namespace
    rr.priority_class_name = req.priority_class_name
    for k, v in req.node_selector.items():
        rr.node_claim.node_selector[k] = v
    for t in req.tolerations:
        tol = rr.node_claim.tolerations.add()
        tol.key = t.get("key", "")
        tol.operator = t.get("operator", "Equal")
        tol.value = t.get("value", "")
        tol.effect = t.get("effect", "")
        secs = t.get("toleration_seconds")
        if secs is not None:
            tol.toleration_seconds = int(secs)
            tol.has_toleration_seconds = True
    return msg


def _pb_to_req(msg: "pb.MaxAvailableReplicasRequest") -> MaxAvailableReplicasRequest:
    rr = msg.replica_requirements
    tolerations = []
    for tol in rr.node_claim.tolerations:
        d = {
            "key": tol.key,
            "operator": tol.operator or "Equal",
            "value": tol.value,
            "effect": tol.effect,
        }
        if tol.has_toleration_seconds:
            d["toleration_seconds"] = tol.toleration_seconds
        tolerations.append(d)
    return MaxAvailableReplicasRequest(
        cluster=msg.cluster,
        resource_request=dict(rr.resource_request),
        node_selector=dict(rr.node_claim.node_selector),
        tolerations=tolerations,
        namespace=rr.namespace,
        priority_class_name=rr.priority_class_name,
    )


def _unsched_to_pb(req: UnschedulableReplicasRequest) -> "pb.UnschedulableReplicasRequest":
    pb, _ = _protos()
    return pb.UnschedulableReplicasRequest(
        cluster=req.cluster,
        resource_kind=req.resource_kind,
        namespace=req.namespace,
        name=req.name,
        unschedulable_threshold_seconds=req.unschedulable_threshold_seconds,
    )


def _pb_to_unsched(msg: "pb.UnschedulableReplicasRequest") -> UnschedulableReplicasRequest:
    return UnschedulableReplicasRequest(
        cluster=msg.cluster,
        resource_kind=msg.resource_kind,
        namespace=msg.namespace,
        name=msg.name,
        unschedulable_threshold_seconds=msg.unschedulable_threshold_seconds,
    )


def _batch_to_pb(
    req: MaxAvailableReplicasBatchRequest,
) -> "bpb.MaxAvailableReplicasBatchRequest":
    _, bpb = _protos()
    msg = bpb.MaxAvailableReplicasBatchRequest(
        clusters=list(req.clusters), dims=list(req.dims),
        namespaces=list(getattr(req, "namespaces", []) or []),
    )
    for row in req.rows:
        msg.rows.add().values.extend(int(v) for v in row)
    return msg


def _pb_to_batch(
    msg: "bpb.MaxAvailableReplicasBatchRequest",
) -> MaxAvailableReplicasBatchRequest:
    return MaxAvailableReplicasBatchRequest(
        clusters=list(msg.clusters),
        dims=list(msg.dims),
        rows=[list(row.values) for row in msg.rows],
        namespaces=list(msg.namespaces),
    )


def _batch_resp_to_pb(
    resp: MaxAvailableReplicasBatchResponse,
) -> "bpb.MaxAvailableReplicasBatchResponse":
    _, bpb = _protos()
    msg = bpb.MaxAvailableReplicasBatchResponse()
    for res in resp.results:
        out = msg.results.add()
        out.cluster = res.cluster
        out.max_replicas.extend(int(v) for v in res.max_replicas)
        out.generation = int(res.generation)
    return msg


def _pb_to_batch_resp(
    msg: "bpb.MaxAvailableReplicasBatchResponse",
) -> MaxAvailableReplicasBatchResponse:
    return MaxAvailableReplicasBatchResponse(
        results=[
            ClusterBatchResult(
                cluster=res.cluster,
                max_replicas=list(res.max_replicas),
                generation=res.generation,
            )
            for res in msg.results
        ]
    )


def _gens_to_pb(req: GetGenerationsRequest) -> "bpb.GetGenerationsRequest":
    _, bpb = _protos()
    return bpb.GetGenerationsRequest(clusters=list(req.clusters))


def _pb_to_gens(msg: "bpb.GetGenerationsRequest") -> GetGenerationsRequest:
    return GetGenerationsRequest(clusters=list(msg.clusters))


def _gens_resp_to_pb(
    resp: GetGenerationsResponse,
) -> "bpb.GetGenerationsResponse":
    _, bpb = _protos()
    msg = bpb.GetGenerationsResponse()
    for cluster, gen in resp.generations.items():
        entry = msg.generations.add()
        entry.cluster = cluster
        entry.generation = int(gen)
    return msg


def _pb_to_gens_resp(
    msg: "bpb.GetGenerationsResponse",
) -> GetGenerationsResponse:
    return GetGenerationsResponse(
        generations={e.cluster: e.generation for e in msg.generations}
    )


class EstimatorGrpcServer:
    """Serves one cluster's ``EstimatorService`` over gRPC, optionally mTLS
    (ref: server/server.go:171-173; grpcconnection/config.go ServerConfig)."""

    def __init__(
        self,
        service: EstimatorService,
        address: str = "127.0.0.1:0",
        *,
        server_cert: Optional[bytes] = None,
        server_key: Optional[bytes] = None,
        client_ca: Optional[bytes] = None,
        max_workers: int = 8,
        enable_batch: bool = True,
    ):
        import grpc

        pb, bpb = _protos()
        self._service = service
        # SO_REUSEPORT off: a port conflict must surface at bind time, not
        # silently load-balance two estimator servers on one port
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[("grpc.so_reuseport", 0)],
        )

        # served-RPC accounting at the wire choke point (covers the single-
        # and multi-cluster services alike). Each handler records one
        # ``estimator.serve`` span under the CALLER's wave: the trace
        # context rides the invocation metadata
        from ..utils.metrics import estimator_server_requests
        from ..utils.tracing import decode_trace_metadata, tracer

        def _ctx(context):
            return decode_trace_metadata(context.invocation_metadata())

        def max_available(request: pb.MaxAvailableReplicasRequest, context):
            estimator_server_requests.inc(method="MaxAvailableReplicas")
            with tracer.server_span(
                "estimator.serve", _ctx(context),
                method="MaxAvailableReplicas",
            ):
                resp = self._service.max_available_replicas(
                    _pb_to_req(request)
                )
            return pb.MaxAvailableReplicasResponse(max_replicas=resp.max_replicas)

        def unschedulable(request: pb.UnschedulableReplicasRequest, context):
            estimator_server_requests.inc(method="GetUnschedulableReplicas")
            with tracer.server_span(
                "estimator.serve", _ctx(context),
                method="GetUnschedulableReplicas",
            ):
                resp = self._service.get_unschedulable_replicas(
                    _pb_to_unsched(request)
                )
            return pb.UnschedulableReplicasResponse(
                unschedulable_replicas=resp.unschedulable_replicas
            )

        def max_available_batch(
            request: "bpb.MaxAvailableReplicasBatchRequest", context
        ):
            estimator_server_requests.inc(method="MaxAvailableReplicasBatch")
            with tracer.server_span(
                "estimator.serve", _ctx(context),
                method="MaxAvailableReplicasBatch",
            ) as sp:
                sp.attrs["rows"] = len(request.rows)
                resp = self._service.max_available_replicas_batch(
                    _pb_to_batch(request)
                )
            return _batch_resp_to_pb(resp)

        def get_generations(request: "bpb.GetGenerationsRequest", context):
            estimator_server_requests.inc(method="GetGenerations")
            with tracer.server_span(
                "estimator.serve", _ctx(context), method="GetGenerations",
            ):
                return _gens_resp_to_pb(
                    self._service.get_generations(_pb_to_gens(request))
                )

        handlers = {
            "MaxAvailableReplicas": grpc.unary_unary_rpc_method_handler(
                max_available,
                request_deserializer=pb.MaxAvailableReplicasRequest.FromString,
                response_serializer=pb.MaxAvailableReplicasResponse.SerializeToString,
            ),
            "GetUnschedulableReplicas": grpc.unary_unary_rpc_method_handler(
                unschedulable,
                request_deserializer=pb.UnschedulableReplicasRequest.FromString,
                response_serializer=pb.UnschedulableReplicasResponse.SerializeToString,
            ),
        }
        # the batched protocol + generation pings ship together; a service
        # object without the methods (or enable_batch=False — the old-server
        # shape, used by the mixed-version tests) leaves them unregistered
        # so clients get UNIMPLEMENTED and negotiate the unary fallback
        if enable_batch and hasattr(service, "max_available_replicas_batch"):
            handlers["MaxAvailableReplicasBatch"] = (
                grpc.unary_unary_rpc_method_handler(
                    max_available_batch,
                    request_deserializer=(
                        bpb.MaxAvailableReplicasBatchRequest.FromString
                    ),
                    response_serializer=(
                        bpb.MaxAvailableReplicasBatchResponse.SerializeToString
                    ),
                )
            )
            handlers["GetGenerations"] = grpc.unary_unary_rpc_method_handler(
                get_generations,
                request_deserializer=bpb.GetGenerationsRequest.FromString,
                response_serializer=(
                    bpb.GetGenerationsResponse.SerializeToString
                ),
            )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        if bool(server_cert) != bool(server_key) or (
            client_ca and not (server_cert and server_key)
        ):
            # incomplete TLS material must fail loudly, never silently
            # degrade to plaintext (grpcconnection/config.go errors likewise)
            raise ValueError(
                "incomplete server TLS config: server_cert and server_key are "
                "both required (and client_ca implies them)"
            )
        if server_cert and server_key:
            creds = grpc.ssl_server_credentials(
                [(server_key, server_cert)],
                root_certificates=client_ca,
                require_client_auth=client_ca is not None,
            )
            self.port = self._server.add_secure_port(address, creds)
        else:
            self.port = self._server.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"estimator gRPC server failed to bind {address}")

    def start(self) -> int:
        self._server.start()
        return self.port

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self._server.stop(grace)


class GrpcEstimatorConnection:
    """Client side of one cluster's estimator channel. Satisfies the
    ``call(method, request)`` seam of ``EstimatorClientPool`` (ref:
    client/cache.go EstimatorClient wrapper)."""

    def __init__(
        self,
        cluster: str,
        target: str,
        *,
        root_ca: Optional[bytes] = None,
        client_cert: Optional[bytes] = None,
        client_key: Optional[bytes] = None,
        timeout_seconds: float = 3.0,
    ):
        import grpc

        pb, bpb = _protos()
        self.cluster = cluster
        self.target = target
        self.timeout = timeout_seconds
        if (client_cert or client_key) and not (root_ca and client_cert and client_key):
            raise ValueError(
                "incomplete client TLS config: client_cert/client_key require "
                "each other and root_ca"
            )
        if root_ca is not None:
            creds = grpc.ssl_channel_credentials(
                root_certificates=root_ca,
                private_key=client_key,
                certificate_chain=client_cert,
            )
            self._channel = grpc.secure_channel(target, creds)
        else:
            self._channel = grpc.insecure_channel(target)
        self._max_available = self._channel.unary_unary(
            f"/{SERVICE_NAME}/MaxAvailableReplicas",
            request_serializer=pb.MaxAvailableReplicasRequest.SerializeToString,
            response_deserializer=pb.MaxAvailableReplicasResponse.FromString,
        )
        self._unschedulable = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GetUnschedulableReplicas",
            request_serializer=pb.UnschedulableReplicasRequest.SerializeToString,
            response_deserializer=pb.UnschedulableReplicasResponse.FromString,
        )
        self._batch = self._channel.unary_unary(
            f"/{SERVICE_NAME}/MaxAvailableReplicasBatch",
            request_serializer=(
                bpb.MaxAvailableReplicasBatchRequest.SerializeToString
            ),
            response_deserializer=(
                bpb.MaxAvailableReplicasBatchResponse.FromString
            ),
        )
        self._generations = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GetGenerations",
            request_serializer=bpb.GetGenerationsRequest.SerializeToString,
            response_deserializer=bpb.GetGenerationsResponse.FromString,
        )
        # batched-protocol negotiation: None until the first batch/ping
        # call, then pinned until the channel proves unhealthy — a WIRE
        # failure resets it to None so the transparently-reconnected
        # channel re-probes before reuse (the returning server may be a
        # different build), and an evicted connection is rebuilt from the
        # resolver with the same effect
        self.supports_batch: Optional[bool] = None
        # unified channel resilience (utils.backoff): consecutive wire
        # failures open the breaker; the registry's fan-out consults
        # ``breaker.engaged()`` BEFORE submitting, so a dead server
        # answers UnauthenticReplica immediately instead of burning the
        # executor (and the pass deadline) on a doomed RPC
        from ..utils.backoff import default_breaker

        self.breaker = default_breaker(f"estimator@{target}")

    def _unimplemented(self, method: str, exc) -> UnsupportedMethodError:
        # UNIMPLEMENTED = an old server build without the batched protocol:
        # remember the negotiation on THIS connection and let the caller
        # fall back to per-profile unary (any other failure propagates)
        self.supports_batch = False
        return UnsupportedMethodError(method)

    def call(self, method: str, request):
        import grpc

        from ..utils.backoff import CircuitBreakerOpen
        from ..utils.faultinject import apply_fault, fault_point
        from ..utils.tracing import trace_metadata, tracer

        if not self.breaker.allow():
            raise CircuitBreakerOpen(
                f"estimator {self.target} breaker is open"
            )
        ok = False
        try:
            # ONE client span per wire attempt (a caller's retry opens a
            # fresh span, so each server-side span re-parents under
            # exactly one client span); the context is captured INSIDE
            # the span so the server records under this span's id
            with tracer.span(
                "estimator.rpc", remote=True, peer=self.target,
                cluster=self.cluster, method=method,
            ):
                md = trace_metadata(tracer.current_context())
                apply_fault(
                    fault_point("estimator.rpc", f"{method}:{self.cluster}"),
                    "estimator.rpc", f"{method}:{self.cluster}",
                    channel=self._channel,
                )
                resp = self._call(method, request, md)
            ok = True
            return resp
        except UnsupportedMethodError:
            # the server ANSWERED (an old build negotiating the fallback):
            # the channel itself is healthy
            ok = True
            raise
        except grpc.RpcError:
            # a wire failure invalidates the pinned batch negotiation —
            # the channel reconnects transparently underneath, and the
            # server that comes back may be a different build, so the
            # next batch/ping call must RE-PROBE instead of trusting a
            # dead server's answer
            self.supports_batch = None
            raise
        finally:
            (self.breaker.record_success if ok
             else self.breaker.record_failure)()

    def _call(self, method: str, request, metadata=()):
        import grpc

        if method == "MaxAvailableReplicas":
            resp = self._max_available(
                _req_to_pb(request), timeout=self.timeout, metadata=metadata
            )
            return MaxAvailableReplicasResponse(max_replicas=resp.max_replicas)
        if method == "GetUnschedulableReplicas":
            resp = self._unschedulable(
                _unsched_to_pb(request), timeout=self.timeout,
                metadata=metadata,
            )
            return UnschedulableReplicasResponse(
                unschedulable_replicas=resp.unschedulable_replicas
            )
        if method == "MaxAvailableReplicasBatch":
            try:
                resp = self._batch(
                    _batch_to_pb(request), timeout=self.timeout,
                    metadata=metadata,
                )
            except grpc.RpcError as exc:
                if exc.code() == grpc.StatusCode.UNIMPLEMENTED:
                    raise self._unimplemented(method, exc) from exc
                raise
            self.supports_batch = True
            return _pb_to_batch_resp(resp)
        if method == "GetGenerations":
            try:
                resp = self._generations(
                    _gens_to_pb(request), timeout=self.timeout,
                    metadata=metadata,
                )
            except grpc.RpcError as exc:
                if exc.code() == grpc.StatusCode.UNIMPLEMENTED:
                    raise self._unimplemented(method, exc) from exc
                raise
            self.supports_batch = True
            return _pb_to_gens_resp(resp)
        raise ValueError(f"unknown method {method}")

    def call_future(self, method: str, request):
        """Pipelined seam for the unary fallback: returns a grpc future so
        a client can keep N per-profile calls in flight on one channel
        instead of blocking sequentially. Resolve with ``future.result()``;
        the response is the raw pb message (use ``.max_replicas``)."""
        if method == "MaxAvailableReplicas":
            from ..utils.backoff import CircuitBreakerOpen
            from ..utils.faultinject import apply_fault, fault_point
            from ..utils.tracing import TraceContext, trace_metadata, tracer

            # non-consuming breaker gate (engaged(), not allow()): futures
            # resolve off-thread, so outcomes feed the breaker via a done
            # callback rather than the probe-slot protocol
            if self.breaker.engaged():
                raise CircuitBreakerOpen(
                    f"estimator {self.target} breaker is open"
                )
            # the in-flight window closes from the grpc done callback (on
            # another thread), so the client span is MANUAL — and the
            # propagated context names the manual span itself, so the
            # server span re-parents under the attempt that carried it
            sp = tracer.open_manual(
                "estimator.rpc", remote=True, peer=self.target,
                cluster=self.cluster, method=method,
            )
            md = trace_metadata(TraceContext(
                wave=sp.wave, trace_id=sp.trace_id, span_id=sp.span_id,
                proc=tracer.proc,
            ))
            try:
                apply_fault(
                    fault_point(
                        "estimator.rpc", f"{method}:{self.cluster}:future"
                    ),
                    "estimator.rpc", f"{method}:{self.cluster}",
                    channel=self._channel,
                )
                fut = self._max_available.future(
                    _req_to_pb(request), timeout=self.timeout, metadata=md
                )
            except BaseException:
                tracer.close_manual(sp)
                raise
            fut.add_done_callback(
                lambda f: (
                    tracer.close_manual(sp),
                    (
                        self.breaker.record_failure()
                        if (not f.cancelled() and f.exception() is not None)
                        else self.breaker.record_success()
                    ),
                )
            )
            return fut
        raise ValueError(f"no future seam for method {method}")

    def close(self) -> None:
        self._channel.close()


def conventional_target(prefix: str, cluster: str, port: int, host: str = "") -> str:
    """Discovery by naming convention (ref: client/service.go —
    ``{prefix}-{cluster}.{ns}:port``; here host defaults to the name itself
    so DNS or /etc/hosts resolves it, tests pass an explicit host)."""
    name = f"{prefix}-{cluster}"
    return f"{host or name}:{port}"


class RemoteAccurateEstimator:
    """EstimatorRegistry-compatible adapter over a gRPC connection: the
    scheduler-side face of an estimator SERVER running in another process
    (per-member deployment; ref client/accurate.go SchedulerEstimator).

    ``max_available_replicas`` interns the request batch to its unique
    profiles and issues ONE MaxAvailableReplicasBatch RPC carrying the
    whole matrix — the reference queries per binding; one batched call is
    the same answer at orders fewer round-trips. Old servers answer
    UNIMPLEMENTED and the connection negotiates the per-profile unary
    fallback, PIPELINED over the channel (``call_future``) instead of
    blocking sequentially. Unreachable estimators answer -1
    (UnauthenticReplica, client/interface.go:30) so the min-merge ignores
    them instead of blocking scheduling."""

    def __init__(self, cluster_name: str, conn, dims_provider):
        import numpy as _np

        self.cluster_name = cluster_name
        self.conn = conn
        self.dims_provider = dims_provider  # () -> list[str] snapshot dims
        self.unschedulable: dict[str, int] = {}
        self._np = _np

    def query_profiles(self, dims, uniq):
        """int32[U] answers for unique profile rows over ``dims``, plus the
        server's snapshot generation (None when the fallback path answered
        — old servers have no generation to report)."""
        from .accurate import UNAUTHENTIC, conn_supports_batch

        np_ = self._np
        if conn_supports_batch(self.conn) is not False:
            try:
                resp = self.conn.call(
                    "MaxAvailableReplicasBatch",
                    MaxAvailableReplicasBatchRequest(
                        clusters=[self.cluster_name],
                        dims=list(dims),
                        rows=[[int(v) for v in row] for row in uniq],
                    ),
                )
                for res in resp.results:
                    if res.cluster == self.cluster_name:
                        return (
                            np_.asarray(res.max_replicas, np_.int32),
                            int(res.generation),
                        )
                # server answered but does not host this cluster
                return np_.full(len(uniq), UNAUTHENTIC, np_.int32), None
            except UnsupportedMethodError:
                pass  # negotiated on the conn: fall through to unary
            except Exception:  # noqa: BLE001 — wire failure = no answer
                return np_.full(len(uniq), UNAUTHENTIC, np_.int32), None
        return self._query_profiles_unary(dims, uniq), None

    def _query_profiles_unary(self, dims, uniq):
        """Per-profile unary fallback, pipelined: keep up to
        ``fallback_width()`` calls in flight on the channel. In-proc
        connections (no ``call_future`` seam) just loop — there is no wire
        latency to hide."""
        from .accurate import UNAUTHENTIC, fallback_width

        np_ = self._np
        out = np_.empty(len(uniq), np_.int32)
        reqs = [
            MaxAvailableReplicasRequest(
                cluster=self.cluster_name,
                resource_request={
                    d: int(q) for d, q in zip(dims, row) if q > 0
                },
            )
            for row in uniq
        ]
        submit = getattr(self.conn, "call_future", None)
        if submit is None:
            for u, req in enumerate(reqs):
                try:
                    resp = self.conn.call("MaxAvailableReplicas", req)
                    out[u] = resp.max_replicas
                except Exception:  # noqa: BLE001
                    out[u] = UNAUTHENTIC
            return out
        width = fallback_width()
        for start in range(0, len(reqs), width):
            window = []
            for u in range(start, min(start + width, len(reqs))):
                try:
                    window.append((u, submit("MaxAvailableReplicas", reqs[u])))
                except Exception:  # noqa: BLE001 — submit failure = -1
                    out[u] = UNAUTHENTIC
            for u, fut in window:
                try:
                    out[u] = fut.result().max_replicas
                except Exception:  # noqa: BLE001
                    out[u] = UNAUTHENTIC
        return out

    def max_available_replicas(self, requirements, requests_batch=None):
        np_ = self._np
        if requests_batch is None:
            req = dict(requirements.resource_request) if requirements else {}
            try:
                resp = self.conn.call(
                    "MaxAvailableReplicas",
                    MaxAvailableReplicasRequest(
                        cluster=self.cluster_name, resource_request=req
                    ),
                )
                return np_.asarray([resp.max_replicas], np_.int32)
            except Exception:  # noqa: BLE001 — wire failure = no answer
                return np_.asarray([-1], np_.int32)
        dims = list(self.dims_provider())
        batch = np_.asarray(requests_batch, np_.int64)
        uniq, inv = np_.unique(batch, axis=0, return_inverse=True)
        per_prof, _gen = self.query_profiles(dims, uniq)
        return per_prof[inv]

    def get_unschedulable_replicas(self, namespace: str, name: str) -> int:
        try:
            resp = self.conn.call(
                "GetUnschedulableReplicas",
                UnschedulableReplicasRequest(
                    cluster=self.cluster_name, namespace=namespace, name=name
                ),
            )
            return resp.unschedulable_replicas
        except Exception:  # noqa: BLE001
            return 0
