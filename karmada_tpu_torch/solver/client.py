"""Control-plane side of the solver sidecar channel: the port's own copy
of ``karmada_tpu/solver/client.py``.

``RemoteSolver`` satisfies the engine seam the scheduler controller uses
(``schedule(problems) -> results``) over gRPC, with snapshot-version
fencing: cluster events push SyncClusters, ScoreAndAssign carries the
pushed version, and a FAILED_PRECONDITION answer (solver restarted, missed
sync) triggers one re-sync + retry. Mirrors the estimator client pattern
(estimator/grpc_transport.py; ref pkg/estimator/client/cache.go). ``grpc``
and ``solver_pb2`` are imported inside the methods that use them, so
``RemoteScheduleResult`` imports where they are absent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..scheduler import BindingProblem
from ..utils.backoff import CircuitBreakerOpen, Deadline, default_breaker
from ..utils.faultinject import apply_fault, fault_point
from ..utils.tracing import trace_metadata, tracer
from .service import SERVICE_NAME, _pb, cluster_to_state, encode_problems


@dataclass
class RemoteScheduleResult:
    """Wire-decoded ScheduleResult (same surface the engine returns)."""

    key: str
    clusters: dict = field(default_factory=dict)
    feasible: tuple = ()
    affinity_name: str = ""
    error: str = ""

    @property
    def success(self) -> bool:
        return not self.error


def call_with_resync(client, attempt, is_stale, resync):
    """The snapshot fence's recovery, shared by every solver client:
    ``attempt(1)``; when it fails stale (``is_stale(exc)``: the solver
    restarted or missed a sync) and ``client`` has a ``_cluster_source``,
    push the clusters once (``resync(clusters)``) and return
    ``attempt(2)``. Any other failure propagates."""
    try:
        return attempt(1)
    except Exception as exc:  # noqa: BLE001 — triaged by is_stale
        if not is_stale(exc) or client._cluster_source is None:
            raise
    resync(client._cluster_source())
    return attempt(2)


class RemoteSolver:
    def __init__(
        self,
        target: str,
        *,
        root_ca: Optional[bytes] = None,
        client_cert: Optional[bytes] = None,
        client_key: Optional[bytes] = None,
        timeout_seconds: float = 120.0,
        cluster_source=None,  # () -> list[Cluster]; used for re-sync
    ):
        if (client_cert or client_key) and not (root_ca and client_cert and client_key):
            raise ValueError(
                "incomplete client TLS config: client_cert/client_key require "
                "each other and root_ca"
            )
        import grpc

        pb = _pb()
        self.target = target
        opts = [("grpc.max_receive_message_length", 256 << 20),
                ("grpc.max_send_message_length", 256 << 20)]
        if root_ca is not None:
            creds = grpc.ssl_channel_credentials(
                root_certificates=root_ca,
                private_key=client_key,
                certificate_chain=client_cert,
            )
            self._channel = grpc.secure_channel(target, creds, options=opts)
        else:
            self._channel = grpc.insecure_channel(target, options=opts)
        self.timeout = timeout_seconds
        self._version = 0
        self._cluster_source = cluster_source
        # unified channel resilience (utils.backoff): the breaker marks
        # this sidecar degraded after consecutive transport failures so
        # the scheduler's in-proc fallback engages without burning a
        # doomed RPC per pass; half-open re-probes heal it automatically
        self.breaker = default_breaker(f"solver@{target}")
        self._sync = self._channel.unary_unary(
            f"/{SERVICE_NAME}/SyncClusters",
            request_serializer=pb.SyncClustersRequest.SerializeToString,
            response_deserializer=pb.SyncClustersResponse.FromString,
        )
        self._score = self._channel.unary_unary(
            f"/{SERVICE_NAME}/ScoreAndAssign",
            request_serializer=pb.ScoreAndAssignRequest.SerializeToString,
            response_deserializer=pb.ScoreAndAssignResponse.FromString,
        )

    # -- snapshot channel --------------------------------------------------

    def sync_clusters(
        self,
        clusters,
        *,
        timeout: Optional[float] = None,
        check_breaker: bool = True,
    ) -> int:
        """``check_breaker=False`` is for the re-sync inside ``schedule``:
        that caller already holds the breaker's admission (possibly the
        single half-open probe slot) and owns the outcome record."""
        if check_breaker and not self.breaker.allow():
            raise CircuitBreakerOpen(
                f"solver {self._channel!r} breaker is open"
            )
        self._version += 1
        req = _pb().SyncClustersRequest(snapshot_version=self._version)
        for cl in clusters:
            req.clusters.append(cluster_to_state(cl))
        ok = False
        try:
            with tracer.span(
                "solver.rpc", remote=True, peer=self.target,
                method="SyncClusters",
            ):
                md = trace_metadata(tracer.current_context())
                apply_fault(
                    fault_point("solver.rpc", "SyncClusters"),
                    "solver.rpc", "SyncClusters", channel=self._channel,
                )
                resp = self._sync(
                    req,
                    timeout=self.timeout if timeout is None else timeout,
                    metadata=md,
                )
            ok = True
        finally:
            # every admitted call records its outcome: a half-open probe
            # slot taken but never resolved would wedge the breaker. The
            # ungated form records nothing — the owning schedule() call
            # does.
            if check_breaker:
                (self.breaker.record_success if ok
                 else self.breaker.record_failure)()
        return resp.snapshot_version

    # -- engine seam -------------------------------------------------------

    def schedule(self, problems: Sequence[BindingProblem]) -> list:
        """Score the batch under ONE overall deadline budget: the re-sync-
        then-retry path (FAILED_PRECONDITION after a solver restart) used
        to stack ``self.timeout`` up to three times (score, sync, retry);
        every RPC now carries the REMAINING budget, so a dead or black-
        holed solver fails the whole call within 1x ``self.timeout`` —
        the standby-sync discipline HASolver already had, generalized."""
        import grpc

        if not self.breaker.allow():
            raise CircuitBreakerOpen(
                f"solver {self._channel!r} breaker is open"
            )
        deadline = Deadline(self.timeout)
        req = encode_problems(problems)
        ok = False

        def score_attempt(attempt: int):
            # one client span per WIRE attempt: a retried RPC is two
            # spans, so each server-side ``solver.solve`` span re-parents
            # under exactly one attempt — never under two parents
            with tracer.span(
                "solver.rpc", remote=True, peer=self.target,
                method="ScoreAndAssign", attempt=attempt,
            ):
                md = trace_metadata(tracer.current_context())
                return self._score(
                    req, timeout=deadline.attempt_timeout(), metadata=md
                )

        def stale(exc: Exception) -> bool:
            return (isinstance(exc, grpc.RpcError)
                    and exc.code() == grpc.StatusCode.FAILED_PRECONDITION)

        def attempt(n: int):
            req.snapshot_version = self._version
            return score_attempt(n)

        try:
            apply_fault(
                fault_point("solver.rpc", "ScoreAndAssign"),
                "solver.rpc", "ScoreAndAssign", channel=self._channel,
            )
            # a re-sync and the retry both run on the REMAINING budget
            # (this call holds the breaker admission, so the sync is
            # ungated)
            resp = call_with_resync(
                self, attempt, stale,
                lambda clusters: self.sync_clusters(
                    clusters, timeout=deadline.attempt_timeout(),
                    check_breaker=False,
                ),
            )
            ok = True
        finally:
            (self.breaker.record_success if ok
             else self.breaker.record_failure)()
        return [
            RemoteScheduleResult(
                key=m.key,
                clusters={tc.name: tc.replicas for tc in m.clusters},
                feasible=tuple(m.feasible),
                affinity_name=m.affinity_name,
                error=m.error,
            )
            for m in resp.results
        ]

    def close(self) -> None:
        self._channel.close()


class HASolver:
    """N solver sidecars, one active: the reference runs scheduler
    replicas behind leader election / a Service and any single live
    backend can answer. Here ``schedule()`` sticks to the active endpoint
    and fails over on transport errors; ``sync_clusters`` broadcasts
    best-effort so standbys hold warm snapshots (a cold standby heals
    anyway via the FAILED_PRECONDITION re-sync in RemoteSolver.schedule).

    Satisfies the same engine seam as RemoteSolver, so
    ``ControlPlane(solver=HASolver([...]))`` is a drop-in."""

    def __init__(
        self,
        targets: Sequence[str],
        *,
        cluster_source=None,
        **kw,
    ):
        if not targets:
            raise ValueError("HASolver needs at least one target")
        self._solvers = [
            RemoteSolver(t, cluster_source=cluster_source, **kw)
            for t in targets
        ]
        self._active = 0

    @property
    def _cluster_source(self):
        return self._solvers[0]._cluster_source

    @_cluster_source.setter
    def _cluster_source(self, fn) -> None:
        # the scheduler controller assigns this post-construction; every
        # backend heals independently, so each needs the source
        for s in self._solvers:
            s._cluster_source = fn

    @property
    def active_target(self) -> int:
        return self._active

    #: standby sync deadline: standby warmth is best-effort (a cold one
    #: heals via FAILED_PRECONDITION re-sync), so a black-holed standby
    #: must not stall the scheduler path for the full RPC timeout
    STANDBY_SYNC_TIMEOUT = 5.0

    def sync_clusters(self, clusters) -> int:
        from concurrent.futures import ThreadPoolExecutor

        import grpc

        results: list = [None] * len(self._solvers)
        errs: list = [None] * len(self._solvers)
        # fan-out threads inherit the caller's trace context so each
        # backend's solver.rpc span lands in the wave that synced
        ctx = tracer.current_context()

        def one(i: int) -> None:
            with tracer.activate(ctx):
                return _one(i)

        def _one(i: int) -> None:
            try:
                results[i] = self._solvers[i].sync_clusters(
                    clusters,
                    timeout=(
                        None
                        if i == self._active
                        else self.STANDBY_SYNC_TIMEOUT
                    ),
                )
            except (grpc.RpcError, CircuitBreakerOpen) as e:
                # standby down (or breaker-open, costing zero RPC): its
                # FAILED_PRECONDITION re-sync heals it later
                errs[i] = e

        # concurrent fan-out: N black-holed standbys cost ONE standby
        # deadline, not N of them stacked
        with ThreadPoolExecutor(max_workers=len(self._solvers)) as pool:
            list(pool.map(one, range(len(self._solvers))))
        live = [v for v in results if v is not None]
        if not live:
            err = next(e for e in errs if e is not None)
            raise err
        return max(live)

    def schedule(self, problems: Sequence[BindingProblem]) -> list:
        import grpc

        n = len(self._solvers)
        last_err: Optional[Exception] = None
        for i in range(n):
            idx = (self._active + i) % n
            try:
                res = self._solvers[idx].schedule(problems)
                self._active = idx
                return res
            except (grpc.RpcError, CircuitBreakerOpen) as e:
                # a breaker-open backend is skipped without burning an RPC
                last_err = e
        assert last_err is not None
        raise last_err

    def close(self) -> None:
        for s in self._solvers:
            s.close()
