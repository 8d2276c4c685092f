"""Solver sidecar: the scheduler's Score/Assign subtree as a gRPC service,
on the port's engine. The port's own copy of ``karmada_tpu/solver/service.py``.

Ref: SURVEY.md section 7 ("a gRPC sidecar wrapper (mirroring service.proto)
for out-of-tree use per the north star") and the estimator transport
pattern (estimator/grpc_transport.py; pkg/estimator/service/
service.proto:26-29). The sidecar owns a TensorScheduler (and with it the
card and the device-resident fleet table); the control plane pushes cluster
state through SyncClusters on cluster events and calls ScoreAndAssign with
binding batches. Snapshot versions fence the two: scheduling against a
version the solver doesn't hold fails FAILED_PRECONDITION and the caller
re-syncs — placements are never computed against stale capacity.

Placements travel as canonical JSON of the Placement CR, interned per
request AND cached by content server-side, so the engine's id()-keyed
caches (and the fleet table's slots) keep hitting across calls. Problems
are rebuilt on every request, so the engine's batch-identity replay never
hits a repeated request: it takes the fleet's diff route instead.

``SolverService`` has a protobuf-free core, ``sync_clusters(clusters,
version)`` and ``solve(version, placement_jsons, problems)`` (problems are
any records with the wire's fields: ``ProblemRecord``s from
``encode_records``, or the protobuf messages themselves), so the service
runs in process where grpc and protobuf are absent; ``score_and_assign``
decodes a ``ScoreAndAssignRequest``, calls the core and encodes the
response. ``grpc`` and ``solver_pb2`` are imported inside the functions
that use them. The service and message names on the wire
(``karmada_tpu.solver.*``) are the JAX package's, so a JAX client reaches
this server and the port's client reaches the JAX server.
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict
from concurrent import futures
from typing import NamedTuple, Optional, Sequence

from ..api.cluster import (
    AllocatableModeling,
    Cluster,
    ClusterSpec,
    ClusterStatus,
    ResourceModel,
    ResourceModelRange,
    ResourceSummary,
    Taint,
)
from ..api.core import Condition, ObjectMeta
from ..api.policy import Placement
from ..scheduler import BindingProblem, ClusterSnapshot, TensorScheduler
from ..utils.codec import from_jsonable, to_jsonable

SERVICE_NAME = "karmada_tpu.solver.Solver"


def _pb():
    from .proto import solver_pb2

    return solver_pb2


# -- cluster state <-> wire -------------------------------------------------


def cluster_to_state(cl: Cluster):
    pb = _pb()
    msg = pb.ClusterState(
        name=cl.name,
        provider=cl.spec.provider,
        region=cl.spec.region,
        zone=cl.spec.zones[0] if cl.spec.zones else "",
        api_enablements=list(cl.status.api_enablements),
        complete_enablements=any(
            c.type == "CompleteAPIEnablements" and c.status
            for c in cl.status.conditions
        ),
    )
    for k, v in cl.meta.labels.items():
        msg.labels[k] = v
    for t in cl.spec.taints:
        msg.taints.add(key=t.key, value=t.value, effect=t.effect)
    rs = cl.status.resource_summary
    for k, v in rs.allocatable.items():
        msg.allocatable[k] = int(v)
    for k, v in rs.allocated.items():
        msg.allocated[k] = int(v)
    for k, v in rs.allocating.items():
        msg.allocating[k] = int(v)
    for rm in cl.spec.resource_models:
        m = msg.resource_models.add(grade=rm.grade)
        for r in rm.ranges:
            m.ranges.add(name=r.name, min=int(r.min), max=int(r.max))
    for am in rs.allocatable_modelings:
        msg.allocatable_modelings.add(grade=am.grade, count=am.count)
    return msg


def state_to_cluster(msg) -> Cluster:
    conditions = [Condition(type="Ready", status=True)]
    if msg.complete_enablements:
        conditions.append(Condition(type="CompleteAPIEnablements", status=True))
    return Cluster(
        meta=ObjectMeta(name=msg.name, labels=dict(msg.labels)),
        spec=ClusterSpec(
            provider=msg.provider,
            region=msg.region,
            zones=[msg.zone] if msg.zone else [],
            taints=[
                Taint(key=t.key, value=t.value, effect=t.effect)
                for t in msg.taints
            ],
            resource_models=[
                ResourceModel(
                    grade=m.grade,
                    ranges=[
                        ResourceModelRange(name=r.name, min=r.min, max=r.max)
                        for r in m.ranges
                    ],
                )
                for m in msg.resource_models
            ],
        ),
        status=ClusterStatus(
            api_enablements=list(msg.api_enablements),
            conditions=conditions,
            resource_summary=ResourceSummary(
                allocatable=dict(msg.allocatable),
                allocated=dict(msg.allocated),
                allocating=dict(msg.allocating),
                allocatable_modelings=[
                    AllocatableModeling(grade=a.grade, count=a.count)
                    for a in msg.allocatable_modelings
                ],
            ),
        ),
    )


# -- problems/results <-> wire ----------------------------------------------


class ProblemRecord(NamedTuple):
    """One binding problem as the wire carries it (``BindingProblem`` in
    solver.proto): the placement by its index into the request's
    placement JSONs (-1 for none)."""

    key: str
    placement_idx: int
    replicas: int
    requests: dict
    gvk: str
    prev: dict
    evict_clusters: tuple
    fresh: bool


class ResultRecord(NamedTuple):
    """One result as the wire carries it (``ScheduleResult``): placements
    and the feasible set sorted by cluster name, both empty on an error."""

    key: str
    clusters: tuple  # ((name, replicas), ...)
    feasible: tuple
    affinity_name: str
    error: str


def placement_json(pl: Optional[Placement]) -> str:
    return (
        json.dumps(to_jsonable(pl), sort_keys=True, separators=(",", ":"))
        if pl is not None
        else ""
    )


def encode_records(problems: Sequence[BindingProblem]) -> tuple[list, list]:
    """(placement JSONs, ``ProblemRecord``s): each distinct placement object
    encoded once and each distinct JSON sent once."""
    jsons: list[str] = []
    interned: dict[int, int] = {}
    json_slot: dict[str, int] = {}
    records = []
    for p in problems:
        if p.placement is None:
            idx = -1
        else:
            idx = interned.get(id(p.placement))
            if idx is None:
                js = placement_json(p.placement)
                idx = json_slot.get(js)
                if idx is None:
                    idx = len(jsons)
                    jsons.append(js)
                    json_slot[js] = idx
                interned[id(p.placement)] = idx
        records.append(ProblemRecord(
            key=p.key, placement_idx=idx, replicas=p.replicas,
            requests={k: int(v) for k, v in p.requests.items()}, gvk=p.gvk,
            prev={k: int(v) for k, v in p.prev.items()},
            evict_clusters=tuple(p.evict_clusters), fresh=p.fresh,
        ))
    return jsons, records


def encode_problems(problems: Sequence[BindingProblem]):
    """The ``ScoreAndAssignRequest`` of ``problems`` (no snapshot version)."""
    req = _pb().ScoreAndAssignRequest()
    jsons, records = encode_records(problems)
    req.placement_jsons.extend(jsons)
    for r in records:
        req.problems.add(
            key=r.key, placement_idx=r.placement_idx, replicas=r.replicas,
            requests=r.requests, gvk=r.gvk, prev=r.prev,
            evict_clusters=list(r.evict_clusters), fresh=r.fresh,
        )
    return req


def result_records(results) -> list[ResultRecord]:
    """Engine results as the wire carries them."""
    out = []
    for r in results:
        if r.success:
            out.append(ResultRecord(r.key, tuple(sorted(r.clusters.items())),
                                    tuple(sorted(r.feasible)), r.affinity_name, r.error))
        else:
            out.append(ResultRecord(r.key, (), (), r.affinity_name, r.error))
    return out


class SolverService:
    """In-process core of the sidecar: snapshot custody + engine dispatch.
    The default engine is a ``TensorScheduler`` on ``device``;
    ``engine_factory(snapshot)`` replaces it (the estimator-aware sidecar
    of ``__main__`` folds live estimator answers in this way)."""

    PLACEMENT_JSON_CACHE = 8192

    def __init__(self, engine_factory=None, device="cuda"):
        self._engine: Optional[TensorScheduler] = None
        self._version = 0
        self.device = device
        self._engine_factory = engine_factory or (
            lambda snap: TensorScheduler(snap, device=device))
        # canonical-JSON -> Placement object, LRU: stable identity across
        # calls keeps the engine's id()-keyed caches warm
        self._placements: OrderedDict[str, Placement] = OrderedDict()
        # the last request's wall split, seconds: decode (placements and
        # problems rebuilt), engine (the schedule call) and, on the wire
        # route, encode (the response built)
        self.last_split: dict[str, float] = {}

    @property
    def snapshot_version(self) -> int:
        return self._version

    def sync_clusters(self, clusters: Sequence[Cluster], version: int) -> int:
        snap = ClusterSnapshot(sorted(clusters, key=lambda c: c.name))
        if self._engine is None or not self._engine.update_snapshot(snap):
            self._engine = self._engine_factory(snap)
        self._version = version
        return self._version

    def _placement(self, js: str) -> Placement:
        pl = self._placements.get(js)
        if pl is None:
            pl = from_jsonable(Placement, json.loads(js))
            self._placements[js] = pl
            if len(self._placements) > self.PLACEMENT_JSON_CACHE:
                self._placements.popitem(last=False)
        else:
            self._placements.move_to_end(js)
        return pl

    def solve(self, version: int, placement_jsons: Sequence[str], problems) -> list:
        """The engine's results for ``problems`` (``ProblemRecord``s or
        wire messages) against snapshot ``version``; raises
        ``StaleSnapshotError`` when the solver holds another version."""
        if self._engine is None:
            raise StaleSnapshotError("solver holds no cluster snapshot")
        if version != self._version:
            raise StaleSnapshotError(
                f"snapshot version mismatch: caller {version} "
                f"!= solver {self._version}"
            )
        t0 = time.perf_counter()
        placements = [self._placement(js) for js in placement_jsons]
        batch = [
            BindingProblem(
                key=m.key,
                placement=placements[m.placement_idx] if m.placement_idx >= 0 else None,
                replicas=m.replicas,
                requests=dict(m.requests),
                gvk=m.gvk,
                prev=dict(m.prev),
                evict_clusters=tuple(m.evict_clusters),
                fresh=m.fresh,
            )
            for m in problems
        ]
        t1 = time.perf_counter()
        results = self._engine.schedule(batch)
        self.last_split = {"decode": t1 - t0, "engine": time.perf_counter() - t1}
        return results

    def score_and_assign(self, request):
        """The wire route: a ``ScoreAndAssignRequest`` in, a
        ``ScoreAndAssignResponse`` out."""
        pb = _pb()
        results = self.solve(request.snapshot_version, request.placement_jsons,
                             request.problems)
        t0 = time.perf_counter()
        resp = pb.ScoreAndAssignResponse(snapshot_version=self._version)
        for r in result_records(results):
            msg = resp.results.add(key=r.key, affinity_name=r.affinity_name, error=r.error)
            for name, n in r.clusters:
                msg.clusters.add(name=name, replicas=n)
            msg.feasible.extend(r.feasible)
        self.last_split["encode"] = time.perf_counter() - t0
        return resp


class StaleSnapshotError(Exception):
    pass


class SolverGrpcServer:
    """Serves a SolverService over gRPC, optionally mTLS (same credential
    contract as the estimator server, grpcconnection/config.go)."""

    def __init__(
        self,
        service: SolverService,
        address: str = "127.0.0.1:0",
        *,
        server_cert: Optional[bytes] = None,
        server_key: Optional[bytes] = None,
        client_ca: Optional[bytes] = None,
        max_workers: int = 4,
    ):
        import grpc

        pb = _pb()
        self._service = service
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[("grpc.so_reuseport", 0),
                     ("grpc.max_receive_message_length", 256 << 20),
                     ("grpc.max_send_message_length", 256 << 20)],
        )

        # served-RPC accounting, and ``solver.sync`` / ``solver.solve``
        # spans recorded under the CALLER's wave (trace context decoded
        # from the invocation metadata): the engine's own spans nest inside
        # solver.solve
        from ..utils.metrics import solver_requests
        from ..utils.tracing import decode_trace_metadata, tracer

        def _ctx(context):
            return decode_trace_metadata(context.invocation_metadata())

        def sync(request, context):
            solver_requests.inc(method="SyncClusters")
            with tracer.server_span(
                "solver.sync", _ctx(context),
                clusters=len(request.clusters),
            ):
                version = self._service.sync_clusters(
                    [state_to_cluster(m) for m in request.clusters],
                    request.snapshot_version,
                )
            return pb.SyncClustersResponse(snapshot_version=version)

        def score(request, context):
            solver_requests.inc(method="ScoreAndAssign")
            with tracer.server_span(
                "solver.solve", _ctx(context), rows=len(request.problems),
            ) as sp:
                try:
                    return self._service.score_and_assign(request)
                except StaleSnapshotError as e:
                    sp.attrs["error"] = "stale_snapshot"
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION, str(e)
                    )

        handlers = {
            "SyncClusters": grpc.unary_unary_rpc_method_handler(
                sync,
                request_deserializer=pb.SyncClustersRequest.FromString,
                response_serializer=pb.SyncClustersResponse.SerializeToString,
            ),
            "ScoreAndAssign": grpc.unary_unary_rpc_method_handler(
                score,
                request_deserializer=pb.ScoreAndAssignRequest.FromString,
                response_serializer=pb.ScoreAndAssignResponse.SerializeToString,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
        )
        if bool(server_cert) != bool(server_key) or (
            client_ca and not (server_cert and server_key)
        ):
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
            raise RuntimeError(f"solver gRPC server failed to bind {address}")

    def start(self) -> int:
        self._server.start()
        return self.port

    def stop(self, grace: Optional[float] = 0.5) -> None:
        self._server.stop(grace)

    def wait(self) -> None:
        self._server.wait_for_termination()
