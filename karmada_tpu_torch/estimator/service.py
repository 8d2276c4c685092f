"""Estimator service contract + scheduler-side connection machinery.

The port's own copy of ``karmada_tpu/estimator/service.py``; it imports
neither grpc nor protobuf, so the in-process seam runs where they are
absent.

Ref: pkg/estimator/service/service.proto:26-29 (service Estimator —
MaxAvailableReplicas / GetUnschedulableReplicas), pb/types.go:26-119
(request/response shapes), client/{cache,service}.go (per-cluster connection
cache, naming-convention discovery {prefix}-{cluster}:port) and
client/accurate.go:139-162 (concurrent fan-out under one deadline).

The wire types are dataclasses mirroring the protobuf schema. Transports
are pluggable behind the ``call(method, request)`` seam: the in-proc
transport calls the service object directly; the real gRPC/protobuf
transport (optionally mTLS) lives in :mod:`.grpc_transport` and drops into
the same pool via the resolver, so the scheduler side never knows which
wire it is on.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

log = logging.getLogger("karmada_tpu_torch")

import numpy as np

from ..api.work import ReplicaRequirements
from .accurate import UNAUTHENTIC, AccurateEstimator


@dataclass
class MaxAvailableReplicasRequest:
    cluster: str = ""
    # ReplicaRequirements (pb/types.go:52-69)
    resource_request: dict[str, int] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[dict] = field(default_factory=list)
    namespace: str = ""
    priority_class_name: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class MaxAvailableReplicasResponse:
    max_replicas: int = 0


@dataclass
class UnschedulableReplicasRequest:
    cluster: str = ""
    resource_kind: str = ""
    namespace: str = ""
    name: str = ""
    unschedulable_threshold_seconds: int = 60


@dataclass
class UnschedulableReplicasResponse:
    unschedulable_replicas: int = 0


# -- batched protocol + generation pings (estimator_batch.proto) ------------


@dataclass
class MaxAvailableReplicasBatchRequest:
    """One RPC per SERVER per pass: the whole unique-profile matrix for
    every cluster the server hosts (empty ``clusters`` = all hosted).
    ``rows`` are positional over ``dims``; the server projects them onto
    its own dim order by name. ``namespaces`` optionally carries one
    namespace per row so the server's ResourceQuota plugin caps each
    row's answer exactly like the unary path does (empty = no namespaces,
    the pre-quota wire shape — old clients keep working)."""

    clusters: list[str] = field(default_factory=list)
    dims: list[str] = field(default_factory=list)
    rows: list = field(default_factory=list)  # U x len(dims) ints
    namespaces: list[str] = field(default_factory=list)  # one per row


@dataclass
class ClusterBatchResult:
    cluster: str = ""
    max_replicas: list[int] = field(default_factory=list)  # one per row
    generation: int = 0  # snapshot generation the answers were computed at


@dataclass
class MaxAvailableReplicasBatchResponse:
    results: list[ClusterBatchResult] = field(default_factory=list)


@dataclass
class GetGenerationsRequest:
    clusters: list[str] = field(default_factory=list)  # empty = all hosted


@dataclass
class GetGenerationsResponse:
    generations: dict[str, int] = field(default_factory=dict)


class UnsupportedMethodError(RuntimeError):
    """The server does not speak this method (an old estimator build):
    gRPC UNIMPLEMENTED translated at the transport seam so in-proc and
    wire connections negotiate the fallback identically."""


class EstimatorService:
    """Server side: wraps one cluster's AccurateEstimator behind the service
    contract (ref: server/server.go:194-225)."""

    def __init__(self, estimator: AccurateEstimator):
        self.estimator = estimator

    def max_available_replicas(
        self, req: MaxAvailableReplicasRequest
    ) -> MaxAvailableReplicasResponse:
        requirements = ReplicaRequirements(
            resource_request=dict(req.resource_request),
            namespace=req.namespace,
            priority_class_name=req.priority_class_name,
        )
        if req.node_selector or req.tolerations:
            from ..api.work import NodeClaim

            requirements.node_claim = NodeClaim(
                node_selector=dict(req.node_selector),
                tolerations=list(req.tolerations),
            )
        dims = self.estimator.snapshot.dims
        row = np.zeros((1, len(dims)), np.int64)
        for j, d in enumerate(dims):
            row[0, j] = req.resource_request.get(d, 0)
        out = self.estimator.max_available_replicas(requirements, row)
        return MaxAvailableReplicasResponse(max_replicas=int(out[0]))

    def get_unschedulable_replicas(
        self, req: UnschedulableReplicasRequest
    ) -> UnschedulableReplicasResponse:
        key = f"{req.namespace}/{req.name}" if req.namespace else req.name
        return UnschedulableReplicasResponse(
            unschedulable_replicas=self.estimator.get_unschedulable_replicas(key)
        )

    def generation(self) -> int:
        """Monotonic snapshot generation: NodeCache bumps it on every
        upsert_node/add_pod/remove_* event; a static NodeSnapshot pins it
        (no events means the estimate can never go stale)."""
        return int(getattr(self.estimator.snapshot, "generation", 0))

    def max_available_replicas_batch(
        self, req: MaxAvailableReplicasBatchRequest
    ) -> MaxAvailableReplicasBatchResponse:
        """Answer the whole unique-profile matrix from ONE vectorized
        estimator call — the [B, N] kernel the unary wire path throws away.
        The generation is read BEFORE computing: a member event landing
        mid-computation must make the answer look stale (re-queried next
        pass), never fresh."""
        name = self.estimator.cluster_name
        if req.clusters and name not in req.clusters:
            return MaxAvailableReplicasBatchResponse()
        gen = self.generation()
        dims = self.estimator.snapshot.dims
        u = len(req.rows)
        mat = np.zeros((u, len(dims)), np.int64)
        # project caller dims onto ours by name: unknown caller dims drop,
        # our dims absent from the caller's list read 0 — exactly the unary
        # path's resource_request.get(d, 0)
        for j_src, d in enumerate(req.dims):
            if d in dims:
                mat[:, dims.index(d)] = [row[j_src] for row in req.rows]
        out = (
            self.estimator.max_available_replicas(None, mat)
            if u
            else np.zeros(0, np.int32)
        )
        # ResourceQuota plugin parity with the unary path: a row carrying
        # a namespace is capped through the SAME plugin call the unary
        # handler makes, over the same projected request dict the unary
        # fallback client would send — the batch answer for (namespace,
        # profile) is the unary answer by construction (feature-gated,
        # like the unary path)
        if req.namespaces and self.estimator.quota_plugin is not None:
            from ..utils.features import RESOURCE_QUOTA_ESTIMATE, feature_gate

            if feature_gate.enabled(RESOURCE_QUOTA_ESTIMATE):
                out = np.asarray(out).copy()
                for j, ns in enumerate(req.namespaces[:u]):
                    if not ns:
                        continue
                    requirements = ReplicaRequirements(
                        resource_request={
                            d: int(q)
                            for d, q in zip(req.dims, req.rows[j])
                            if q > 0
                        },
                        namespace=ns,
                    )
                    cap = self.estimator.quota_plugin.estimate(
                        ns, requirements
                    )
                    if cap is not None:
                        out[j] = min(int(out[j]), max(int(cap), 0))
        return MaxAvailableReplicasBatchResponse(
            results=[
                ClusterBatchResult(
                    cluster=name,
                    max_replicas=[int(v) for v in out],
                    generation=gen,
                )
            ]
        )

    def get_generations(
        self, req: GetGenerationsRequest
    ) -> GetGenerationsResponse:
        name = self.estimator.cluster_name
        if req.clusters and name not in req.clusters:
            return GetGenerationsResponse()
        return GetGenerationsResponse(generations={name: self.generation()})


class MultiClusterEstimatorService:
    """One server PROCESS hosting many clusters' estimators, routed by
    ``request.cluster`` — the multiplexed deployment shape (the reference
    runs one estimator deployment per member; at hundreds of members an
    operator consolidates them, and the wire contract already carries the
    cluster name on every request, so the scheduler side is unchanged)."""

    def __init__(self, services: dict[str, EstimatorService]):
        self._services = services

    def max_available_replicas(
        self, req: MaxAvailableReplicasRequest
    ) -> MaxAvailableReplicasResponse:
        svc = self._services.get(req.cluster)
        if svc is None:
            raise KeyError(f"no estimator for cluster {req.cluster!r}")
        return svc.max_available_replicas(req)

    def get_unschedulable_replicas(
        self, req: UnschedulableReplicasRequest
    ) -> UnschedulableReplicasResponse:
        svc = self._services.get(req.cluster)
        if svc is None:
            raise KeyError(f"no estimator for cluster {req.cluster!r}")
        return svc.get_unschedulable_replicas(req)

    def max_available_replicas_batch(
        self, req: MaxAvailableReplicasBatchRequest
    ) -> MaxAvailableReplicasBatchResponse:
        """One RPC answers every hosted cluster's unique-profile vector —
        the O(servers) pass shape. A requested-but-unhosted cluster is
        simply absent from the response (the caller answers
        UnauthenticReplica for it, matching the unary path's KeyError)."""
        wanted = req.clusters or sorted(self._services)
        results: list[ClusterBatchResult] = []
        for name in wanted:
            svc = self._services.get(name)
            if svc is None:
                continue
            sub = MaxAvailableReplicasBatchRequest(
                clusters=[name], dims=req.dims, rows=req.rows,
                namespaces=req.namespaces,
            )
            results.extend(svc.max_available_replicas_batch(sub).results)
        return MaxAvailableReplicasBatchResponse(results=results)

    def get_generations(
        self, req: GetGenerationsRequest
    ) -> GetGenerationsResponse:
        wanted = req.clusters or sorted(self._services)
        return GetGenerationsResponse(
            generations={
                name: self._services[name].generation()
                for name in wanted
                if name in self._services
            }
        )


class EstimatorConnection:
    """One cluster's channel. ``call`` is the transport seam."""

    def __init__(self, cluster: str, service: EstimatorService):
        self.cluster = cluster
        self._service = service

    def call(self, method: str, request):
        # the in-proc seam records the SAME server-side span the gRPC
        # handlers do (trace shape is transport-independent); the caller
        # shares the process, so it nests under the caller's open span
        # directly — no metadata, no remote_parent, no network column
        from ..utils.tracing import tracer

        with tracer.server_span("estimator.serve", None, method=method):
            return self._dispatch(method, request)

    def _dispatch(self, method: str, request):
        if method == "MaxAvailableReplicas":
            return self._service.max_available_replicas(request)
        if method == "GetUnschedulableReplicas":
            return self._service.get_unschedulable_replicas(request)
        if method == "MaxAvailableReplicasBatch":
            handler = getattr(
                self._service, "max_available_replicas_batch", None
            )
            if handler is None:  # an old service build: negotiate fallback
                raise UnsupportedMethodError(method)
            return handler(request)
        if method == "GetGenerations":
            handler = getattr(self._service, "get_generations", None)
            if handler is None:
                raise UnsupportedMethodError(method)
            return handler(request)
        raise ValueError(f"unknown method {method}")


def _close(conn) -> None:
    close = getattr(conn, "close", None)
    if close is not None:
        try:
            close()
        except Exception as exc:  # noqa: BLE001 — teardown is best-effort
            log.debug("estimator connection close failed: %s", exc)


class EstimatorClientPool:
    """Scheduler-side connection cache + service discovery
    (client/cache.go + client/service.go). Discovery resolves
    ``{prefix}-{cluster}`` through a resolver callable — the DNS-by-
    convention analogue."""

    def __init__(
        self,
        resolver: Callable[[str], Optional[EstimatorService]],
        timeout_seconds: float = 3.0,
        max_workers: int = 32,
    ):
        self.resolver = resolver
        self.timeout = timeout_seconds
        self._conns: dict[str, EstimatorConnection] = {}
        self._lock = threading.Lock()
        # bounded shared executor for the fan-out: a raw Thread per cluster
        # per query (the previous shape) costs a ~8 MiB stack + spawn each
        # at thousands of members; the executor spawns lazily up to the
        # bound and reuses threads across passes. Context-propagating: the
        # per-cluster RPC spans must land in the wave that fanned out, not
        # in wave 0 on a bare pool thread
        from concurrent.futures import ThreadPoolExecutor

        from ..utils.tracing import ContextPropagatingExecutor

        self._executor = ContextPropagatingExecutor(ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="estimator-fanout"
        ))

    def connection(self, cluster: str) -> Optional[EstimatorConnection]:
        with self._lock:
            conn = self._conns.get(cluster)
        if conn is not None:
            return conn
        service = self.resolver(cluster)
        if service is None:
            return None
        # the resolver may hand back a ready connection (e.g. a
        # GrpcEstimatorConnection) or a bare service to wrap in-proc
        conn = service if hasattr(service, "call") else EstimatorConnection(cluster, service)
        with self._lock:
            winner = self._conns.setdefault(cluster, conn)
        if winner is not conn:  # lost an insert race: drop the extra channel
            _close(conn)
        return winner

    def evict(self, cluster: str, conn=None) -> None:
        """Drop a cached connection. When ``conn`` is given, evict only if it
        is still the cached one — a late failure must not tear down a
        channel a newer pass already re-resolved."""
        with self._lock:
            cached = self._conns.get(cluster)
            if cached is None or (conn is not None and cached is not conn):
                return
            del self._conns[cluster]
        _close(cached)

    def max_available_replicas(
        self,
        clusters: list[str],
        resource_request: dict[str, int],
        **req_kw,
    ) -> dict[str, int]:
        """Concurrent fan-out with one shared deadline
        (client/accurate.go:139-162). Clusters without a connection answer
        UnauthenticReplica (-1)."""
        from concurrent.futures import wait as _fwait

        results: dict[str, int] = {c: UNAUTHENTIC for c in clusters}

        def one(cluster: str) -> None:
            conn = self.connection(cluster)
            if conn is None:
                return
            from .accurate import conn_breaker_engaged

            if conn_breaker_engaged(conn):
                # breaker-open server: answer UnauthenticReplica NOW
                # instead of burning the fan-out on a doomed RPC (the
                # transport's own half-open probe heals the breaker)
                return
            try:
                resp = conn.call(
                    "MaxAvailableReplicas",
                    MaxAvailableReplicasRequest(
                        cluster=cluster, resource_request=resource_request, **req_kw
                    ),
                )
            except Exception as exc:  # noqa: BLE001 — any transport failure
                # transport failure answers UnauthenticReplica and drops the
                # cached channel — only if it is still this one, so a late
                # straggler cannot tear down a re-resolved healthy channel
                # (client/accurate.go error path + cache eviction). Logged:
                # a silently-evicted estimator looks identical to a cluster
                # that genuinely answered -1. Class name only at warning —
                # grpc error reprs are multi-line and orchestrators scrape
                # this process's merged stdout/stderr for JSON lines
                log.warning(
                    "estimator %s: MaxAvailableReplicas failed (%s); "
                    "answering UnauthenticReplica and evicting the channel",
                    cluster, type(exc).__name__,
                )
                log.debug("estimator %s failure detail", cluster,
                          exc_info=exc)
                self.evict(cluster, conn)
                return
            results[cluster] = resp.max_replicas

        futs = [self._executor.submit(one, c) for c in clusters]
        # one shared deadline for the whole fan-out; stragglers keep running
        # on the executor (their conn.call carries its own timeout, so they
        # drain) and keep writing to ``results`` — the caller's view must be
        # frozen at the deadline, hence the snapshot
        _fwait(futs, timeout=self.timeout)
        return dict(results)
