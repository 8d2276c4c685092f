"""The port's estimator transport against the JAX package on the CPU.

The scenarios of ``tests/test_grpc_transport.py`` (wire round-trips, node
claims, pool fan-out and eviction, mTLS, naming-convention discovery, TLS
checks, bind failure), ``tests/test_estimator_batch.py`` (the batched
protocol and generation pings, the registry's one-RPC-per-server refresh,
the mixed-version unary fallback, per-column completeness, degraded passes,
scheduler parity, channel resilience under the breaker, quota-plugin wire
parity) and ``tests/test_estimator_fanout.py`` (a spawned multi-process
fleet, ``python -m karmada_tpu_torch.estimator --device cpu``), run on the
port's modules with the JAX tests' own values, timeouts and breaker
windows; where a JAX test compares with an engine, the port's placements
are also held to the JAX engine's. Across the packages, on one wire: a JAX
``EstimatorRegistry`` over ``GrpcEstimatorConnection``s to the port's
``EstimatorGrpcServer``, and the port's registry to the JAX server, answer
what the all-JAX pair answers. Tolerance: exact equality.
"""

import functools
import importlib
import subprocess

import numpy as np
import pytest

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu_torch
from karmada_tpu_torch.api.cluster import NO_SCHEDULE, Taint
from karmada_tpu_torch.estimator import accurate as _acc
from karmada_tpu_torch.estimator.accurate import (
    EstimatorRegistry,
    NodeCache,
    NodeSnapshot,
    NodeState,
)
from karmada_tpu_torch.estimator.fleet import spawn_estimator_fleet
from karmada_tpu_torch.estimator.grpc_transport import (
    EstimatorGrpcServer,
    GrpcEstimatorConnection,
    RemoteAccurateEstimator,
    conventional_target,
)
from karmada_tpu_torch.estimator.service import (
    EstimatorClientPool,
    EstimatorService,
    GetGenerationsRequest,
    MaxAvailableReplicasBatchRequest,
    MaxAvailableReplicasRequest,
    MultiClusterEstimatorService,
    UnschedulableReplicasRequest,
    UnsupportedMethodError,
)
from karmada_tpu_torch.scheduler import BindingProblem, ClusterSnapshot
from karmada_tpu_torch.utils.builders import dynamic_weight_placement, synthetic_fleet
from karmada_tpu_torch.utils.quantity import parse_resource_list

#: the port's estimators on the CPU (their node sums take the numpy mirror
#: at these sizes, the plain version of K8 above it)
AccurateEstimator = functools.partial(_acc.AccurateEstimator, device="cpu")
TensorScheduler = functools.partial(
    importlib.import_module("karmada_tpu_torch.scheduler").TensorScheduler, device="cpu")

DIMS = ["cpu", "memory", "pods"]


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def estimate_scene(pkg, n_clusters: int, fleet_seed: int, seed: int, count: int):
    """(snapshot, problems) of the parity and fan-out scenes in ``pkg``:
    dynamic weight, four request profiles, replicas 1-39."""
    b = mod(pkg, "utils.builders")
    q = mod(pkg, "utils.quantity")
    s = mod(pkg, "scheduler")
    snap = s.ClusterSnapshot(b.synthetic_fleet(n_clusters, seed=fleet_seed))
    rng = np.random.default_rng(seed)
    pl = b.dynamic_weight_placement()
    profiles = [
        q.parse_resource_list({"cpu": f"{250 * (p + 1)}m", "memory": f"{512 * (p + 1)}Mi"})
        for p in range(4)
    ]
    return snap, [
        s.BindingProblem(key=f"e{i}", placement=pl, replicas=int(rng.integers(1, 40)),
                         requests=profiles[int(rng.integers(0, 4))],
                         gvk="apps/v1/Deployment")
        for i in range(count)
    ]


def placed(results) -> list:
    return [(r.key, r.success, dict(r.clusters), r.error) for r in results]


def jax_plain(*scene) -> list:
    """The JAX engine's placements on the snapshot alone: the min-merge
    degeneracy's referent."""
    snap, problems = estimate_scene(karmada_tpu, *scene)
    return placed(JS.TensorScheduler(snap).schedule(problems))


# --------------------------------------------------------------------------
# tests/test_grpc_transport.py on the port
# --------------------------------------------------------------------------


def make_service(cluster: str, cpu_free: int, n_nodes: int = 2) -> EstimatorService:
    nodes = [
        NodeState(
            name=f"{cluster}-n{i}",
            allocatable={"cpu": cpu_free, "memory": 1 << 32, "pods": 110},
            requested={"cpu": 0, "memory": 0},
        )
        for i in range(n_nodes)
    ]
    est = AccurateEstimator(cluster, NodeSnapshot(nodes, DIMS))
    est.unschedulable["default/web"] = 3
    return EstimatorService(est)


def test_insecure_round_trip():
    svc = make_service("m1", cpu_free=4000)
    server = EstimatorGrpcServer(svc)
    port = server.start()
    try:
        conn = GrpcEstimatorConnection("m1", f"127.0.0.1:{port}")
        resp = conn.call(
            "MaxAvailableReplicas",
            MaxAvailableReplicasRequest(cluster="m1", resource_request={"cpu": 1000}),
        )
        # 2 nodes x 4000/1000
        assert resp.max_replicas == 8
        un = conn.call(
            "GetUnschedulableReplicas",
            UnschedulableReplicasRequest(cluster="m1", namespace="default", name="web"),
        )
        assert un.unschedulable_replicas == 3
        conn.close()
    finally:
        server.stop()


def test_node_claim_survives_wire():
    """node_selector + tolerations shape the estimate through the pb hop."""
    nodes = [
        NodeState(
            name="gpu-node",
            allocatable={"cpu": 8000, "memory": 1 << 33, "pods": 110},
            labels={"accel": "tpu"},
        ),
        NodeState(
            name="tainted",
            allocatable={"cpu": 8000, "memory": 1 << 33, "pods": 110},
            labels={"accel": "tpu"},
            taints=[Taint(key="dedicated", value="infra", effect=NO_SCHEDULE)],
        ),
        NodeState(name="plain", allocatable={"cpu": 8000, "memory": 1 << 33, "pods": 110}),
    ]
    svc = EstimatorService(AccurateEstimator("m1", NodeSnapshot(nodes, DIMS)))
    server = EstimatorGrpcServer(svc)
    port = server.start()
    try:
        conn = GrpcEstimatorConnection("m1", f"127.0.0.1:{port}")
        # selector only: tainted node excluded, plain node label-mismatched
        resp = conn.call(
            "MaxAvailableReplicas",
            MaxAvailableReplicasRequest(
                cluster="m1",
                resource_request={"cpu": 2000},
                node_selector={"accel": "tpu"},
            ),
        )
        assert resp.max_replicas == 4
        # toleration unlocks the tainted node
        resp = conn.call(
            "MaxAvailableReplicas",
            MaxAvailableReplicasRequest(
                cluster="m1",
                resource_request={"cpu": 2000},
                node_selector={"accel": "tpu"},
                tolerations=[{"key": "dedicated", "operator": "Exists"}],
            ),
        )
        assert resp.max_replicas == 8
        conn.close()
    finally:
        server.stop()


def test_pool_fanout_over_grpc_and_failure_unauthentic():
    servers = {}
    ports = {}
    for name, cpu in [("m1", 2000), ("m2", 6000)]:
        s = EstimatorGrpcServer(make_service(name, cpu))
        ports[name] = s.start()
        servers[name] = s

    def resolver(cluster):
        if cluster == "gone":  # unreachable member: refused connection
            return GrpcEstimatorConnection(cluster, "127.0.0.1:1", timeout_seconds=0.5)
        if cluster not in ports:
            return None
        return GrpcEstimatorConnection(cluster, f"127.0.0.1:{ports[cluster]}")

    pool = EstimatorClientPool(resolver, timeout_seconds=5.0)
    try:
        got = pool.max_available_replicas(
            ["m1", "m2", "gone", "unknown"], {"cpu": 1000}
        )
        assert got == {"m1": 4, "m2": 12, "gone": -1, "unknown": -1}
        # failed channel was evicted so recovery re-resolves
        assert pool.connection("m1") is not None
        assert "gone" not in pool._conns
    finally:
        for s in servers.values():
            s.stop()


@pytest.fixture(scope="module")
def mtls_certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pki")

    def run(*args):
        subprocess.run(args, check=True, capture_output=True, cwd=d)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
        "ca.key", "-out", "ca.crt", "-days", "1", "-subj", "/CN=karmada-ca")
    for who in ("server", "client"):
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout",
            f"{who}.key", "-out", f"{who}.csr", "-subj", f"/CN={who}")
        run("openssl", "x509", "-req", "-in", f"{who}.csr", "-CA", "ca.crt",
            "-CAkey", "ca.key", "-CAcreateserial", "-out", f"{who}.crt",
            "-days", "1", "-extfile", _ext_file(d, who))
    return {p.name: p.read_bytes() for p in d.iterdir() if p.suffix in (".crt", ".key")}


def _ext_file(d, who):
    ext = d / f"{who}.ext"
    ext.write_text("subjectAltName=IP:127.0.0.1,DNS:localhost\n")
    return str(ext)


def test_mtls_round_trip(mtls_certs):
    """mTLS both ways (ref: grpcconnection/config.go — server cert+key,
    client CA, require_client_auth)."""
    svc = make_service("secure", cpu_free=3000)
    server = EstimatorGrpcServer(
        svc,
        server_cert=mtls_certs["server.crt"],
        server_key=mtls_certs["server.key"],
        client_ca=mtls_certs["ca.crt"],
    )
    port = server.start()
    try:
        conn = GrpcEstimatorConnection(
            "secure",
            f"127.0.0.1:{port}",
            root_ca=mtls_certs["ca.crt"],
            client_cert=mtls_certs["client.crt"],
            client_key=mtls_certs["client.key"],
        )
        resp = conn.call(
            "MaxAvailableReplicas",
            MaxAvailableReplicasRequest(cluster="secure", resource_request={"cpu": 500}),
        )
        assert resp.max_replicas == 12
        conn.close()
        # a client without a certificate is rejected by client-auth
        bad = GrpcEstimatorConnection(
            "secure", f"127.0.0.1:{port}", root_ca=mtls_certs["ca.crt"],
            timeout_seconds=2.0,
        )
        with pytest.raises(Exception):
            bad.call(
                "MaxAvailableReplicas",
                MaxAvailableReplicasRequest(cluster="secure", resource_request={"cpu": 500}),
            )
        bad.close()
    finally:
        server.stop()


def test_conventional_target():
    assert conventional_target("karmada-scheduler-estimator", "m1", 10352) == (
        "karmada-scheduler-estimator-m1:10352"
    )
    assert conventional_target("est", "m2", 9000, host="127.0.0.1") == "127.0.0.1:9000"


def test_batch_request_matches_single_over_wire():
    """The wire path (single requests) agrees with the in-proc batch kernel."""
    svc = make_service("m1", cpu_free=5000, n_nodes=3)
    server = EstimatorGrpcServer(svc)
    port = server.start()
    try:
        conn = GrpcEstimatorConnection("m1", f"127.0.0.1:{port}")
        reqs = np.array([[1000, 1, 1], [2500, 1, 1], [7000, 1, 1]], np.int64)
        batch = svc.estimator.max_available_replicas(None, reqs)
        for row, expect in zip(reqs, batch):
            resp = conn.call(
                "MaxAvailableReplicas",
                MaxAvailableReplicasRequest(
                    cluster="m1",
                    resource_request={"cpu": int(row[0]), "memory": int(row[1]), "pods": int(row[2])},
                ),
            )
            assert resp.max_replicas == int(expect)
        conn.close()
    finally:
        server.stop()


def test_partial_tls_rejected(mtls_certs):
    """Incomplete TLS material fails loudly — never silent plaintext."""
    svc = make_service("m1", cpu_free=1000)
    with pytest.raises(ValueError):
        EstimatorGrpcServer(svc, server_cert=mtls_certs["server.crt"])
    with pytest.raises(ValueError):
        EstimatorGrpcServer(svc, client_ca=mtls_certs["ca.crt"])
    with pytest.raises(ValueError):
        GrpcEstimatorConnection("m1", "127.0.0.1:1", client_cert=mtls_certs["client.crt"])


def test_bind_failure_raises():
    svc = make_service("m1", cpu_free=1000)
    s1 = EstimatorGrpcServer(svc, address="127.0.0.1:0")
    try:
        with pytest.raises(RuntimeError):
            EstimatorGrpcServer(svc, address=f"127.0.0.1:{s1.port}")
    finally:
        s1.stop()


# --------------------------------------------------------------------------
# tests/test_estimator_batch.py on the port
# --------------------------------------------------------------------------


def make_member_caches(names, cpu_step=4000):
    return {
        name: NodeCache(
            DIMS,
            [
                NodeState(
                    name=f"{name}-n0",
                    allocatable={
                        "cpu": cpu_step * (i + 1),
                        "memory": 1 << 32,
                        "pods": 110,
                    },
                )
            ],
        )
        for i, name in enumerate(names)
    }


@pytest.fixture()
def wired_fleet():
    """Two real gRPC server processes' worth of clusters, hosted in-proc:
    server 1 hosts a+b, server 2 hosts c+d. Yields (caches, conns,
    registry, names)."""
    names = ["a", "b", "c", "d"]
    caches = make_member_caches(names)
    services = {
        n: EstimatorService(AccurateEstimator(n, caches[n])) for n in names
    }
    servers, conns = [], []
    registry = EstimatorRegistry()
    try:
        for hosted in (names[:2], names[2:]):
            srv = EstimatorGrpcServer(
                MultiClusterEstimatorService(
                    {n: services[n] for n in hosted}
                )
            )
            port = srv.start()
            servers.append(srv)
            conn = GrpcEstimatorConnection(
                "multi", f"127.0.0.1:{port}", timeout_seconds=5.0
            )
            conns.append(conn)
            for n in hosted:
                registry.register(
                    RemoteAccurateEstimator(n, conn, lambda: list(DIMS))
                )
        yield caches, conns, registry, names
    finally:
        for conn in conns:
            conn.close()
        for srv in servers:
            srv.stop()


def reqs_matrix(cpus):
    out = np.zeros((len(cpus), len(DIMS)), np.int64)
    out[:, 0] = cpus
    return out


class TestBatchWire:
    def test_batch_rpc_matches_unary(self, wired_fleet):
        """One batch RPC answers every hosted cluster; values equal the
        per-profile unary protocol's bit for bit."""
        caches, conns, registry, names = wired_fleet
        conn = conns[0]
        rows = [[1000, 0, 0], [2500, 0, 0], [500, 1 << 30, 0]]
        resp = conn.call(
            "MaxAvailableReplicasBatch",
            MaxAvailableReplicasBatchRequest(
                clusters=[], dims=DIMS, rows=rows
            ),
        )
        got = {r.cluster: list(r.max_replicas) for r in resp.results}
        assert sorted(got) == ["a", "b"]
        for cluster, vec in got.items():
            for row, expect in zip(rows, vec):
                unary = conn.call(
                    "MaxAvailableReplicas",
                    MaxAvailableReplicasRequest(
                        cluster=cluster,
                        resource_request={
                            d: int(v) for d, v in zip(DIMS, row) if v
                        },
                    ),
                )
                assert unary.max_replicas == expect
        assert conn.supports_batch is True

    def test_generations_ping(self, wired_fleet):
        caches, conns, registry, names = wired_fleet
        resp = conns[1].call("GetGenerations", GetGenerationsRequest())
        assert sorted(resp.generations) == ["c", "d"]
        g0 = resp.generations["c"]
        caches["c"].add_pod("c-n0", {"cpu": 100})
        resp = conns[1].call(
            "GetGenerations", GetGenerationsRequest(clusters=["c"])
        )
        assert resp.generations == {"c": g0 + 1}

    def test_registry_one_rpc_per_server_and_delta_refresh(
        self, wired_fleet
    ):
        """The steady-pass RPC shape the bench asserts: first pass = one
        batch per server; a no-movement refresh = one ping per server and
        NO profile fan-out; movement re-queries exactly the changed
        clusters."""
        caches, conns, registry, names = wired_fleet
        est = registry.make_batch_estimator(names, timeout_seconds=5.0)
        reqs = reqs_matrix([1000, 2000, 500])
        reps = np.asarray([5, 5, 5])

        out = est(reqs, reps)
        assert dict(registry.rpc_counts) == {"batch": 2, "unary": 0, "ping": 0}
        assert (out >= 0).all()

        # steady repeat: pure memo, zero wire traffic
        out2 = est(reqs, reps)
        assert dict(registry.rpc_counts) == {"batch": 2, "unary": 0, "ping": 0}
        assert (out2 == out).all()

        # no-movement refresh: one ping per server, memo survives
        registry.invalidate()
        out3 = est(reqs, reps)
        assert dict(registry.rpc_counts) == {"batch": 2, "unary": 0, "ping": 2}
        assert (out3 == out).all()

        # one member moves: its server re-queried (ping + batch), the
        # other server answers from its pinged-valid memo
        caches["b"].add_pod("b-n0", {"cpu": 1000})
        registry.invalidate()
        out4 = est(reqs, reps)
        assert dict(registry.rpc_counts) == {"batch": 3, "unary": 0, "ping": 4}
        b_col = names.index("b")
        assert out4[0, b_col] == out[0, b_col] - 1  # 1000m less free cpu
        others = [i for i in range(len(names)) if i != b_col]
        assert (out4[:, others] == out[:, others]).all()

    def test_hard_invalidate_refans_everything(self, wired_fleet):
        caches, conns, registry, names = wired_fleet
        est = registry.make_batch_estimator(names, timeout_seconds=5.0)
        reqs = reqs_matrix([1000])
        est(reqs, np.asarray([5]))
        registry.invalidate(drop=True)
        est(reqs, np.asarray([5]))
        assert registry.rpc_counts["batch"] == 4  # 2 servers x 2 full passes
        assert registry.rpc_counts["ping"] == 0


class TestMixedVersionFallback:
    @pytest.fixture()
    def old_and_new(self):
        """The same member state behind a batch-capable server AND an old
        server with the batch handler deliberately unregistered."""
        names = ["a", "b", "c"]
        caches = make_member_caches(names)
        services = {
            n: EstimatorService(AccurateEstimator(n, caches[n]))
            for n in names
        }
        new_srv = EstimatorGrpcServer(MultiClusterEstimatorService(services))
        old_srv = EstimatorGrpcServer(
            MultiClusterEstimatorService(services), enable_batch=False
        )
        try:
            yield names, new_srv.start(), old_srv.start()
        finally:
            new_srv.stop()
            old_srv.stop()

    def _registry(self, names, port):
        registry = EstimatorRegistry()
        conn = GrpcEstimatorConnection(
            "multi", f"127.0.0.1:{port}", timeout_seconds=5.0
        )
        for n in names:
            registry.register(
                RemoteAccurateEstimator(n, conn, lambda: list(DIMS))
            )
        return registry, conn

    def test_fallback_negotiation_and_parity(self, old_and_new):
        names, new_port, old_port = old_and_new
        reqs = reqs_matrix([1000, 2500, 700])
        reps = np.asarray([9, 9, 9])

        reg_new, conn_new = self._registry(names, new_port)
        reg_old, conn_old = self._registry(names, old_port)
        try:
            batch_out = reg_new.make_batch_estimator(
                names, timeout_seconds=5.0
            )(reqs, reps)
            fallback_out = reg_old.make_batch_estimator(
                names, timeout_seconds=5.0
            )(reqs, reps)
            # byte-identical placably: the min-merge sees the same matrix
            assert (batch_out == fallback_out).all()
            assert batch_out.dtype == fallback_out.dtype
            assert conn_old.supports_batch is False
            assert conn_new.supports_batch is True
            # the fallback actually fanned out per profile
            assert reg_old.rpc_counts["unary"] == 3 * len(names)
            # old servers cannot delta-gate: an invalidated pass re-pays
            # the unary fan-out (no ping protocol to ask)
            reg_old.invalidate()
            fallback_out2 = reg_old.make_batch_estimator(
                names, timeout_seconds=5.0
            )(reqs, reps)
            assert (fallback_out2 == fallback_out).all()
            assert reg_old.rpc_counts["unary"] == 2 * 3 * len(names)
            assert reg_old.rpc_counts["ping"] == 0
        finally:
            conn_new.close()
            conn_old.close()

    def test_unsupported_method_error_over_wire(self, old_and_new):
        names, _new_port, old_port = old_and_new
        conn = GrpcEstimatorConnection(
            "multi", f"127.0.0.1:{old_port}", timeout_seconds=5.0
        )
        try:
            with pytest.raises(UnsupportedMethodError):
                conn.call(
                    "MaxAvailableReplicasBatch",
                    MaxAvailableReplicasBatchRequest(
                        clusters=[], dims=DIMS, rows=[[1000, 0, 0]]
                    ),
                )
            assert conn.supports_batch is False
        finally:
            conn.close()

    def test_reprobe_after_reconnect(self, old_and_new):
        """Negotiation is per CONNECTION: after an evict/reconnect lands on
        an upgraded server, the fresh connection probes batch again."""
        names, new_port, old_port = old_and_new
        reqs = reqs_matrix([1000])
        reps = np.asarray([5])

        registry, conn_old = self._registry(names, old_port)
        try:
            est = registry.make_batch_estimator(names, timeout_seconds=5.0)
            est(reqs, reps)
            assert conn_old.supports_batch is False
            assert registry.rpc_counts["batch"] == 1  # the probe
            # reconnect: the server was upgraded (same members, batch on)
            conn_new = GrpcEstimatorConnection(
                "multi", f"127.0.0.1:{new_port}", timeout_seconds=5.0
            )
            for n in names:
                registry.register(
                    RemoteAccurateEstimator(n, conn_new, lambda: list(DIMS))
                )
            try:
                est(reqs, reps)
                assert conn_new.supports_batch is True
                assert registry.rpc_counts["batch"] == 2
                # and the batch path serves refreshes from generations now
                registry.invalidate()
                est(reqs, reps)
                assert registry.rpc_counts["ping"] == 1
                assert registry.rpc_counts["batch"] == 2
            finally:
                conn_new.close()
        finally:
            conn_old.close()

    def test_env_kill_switch_forces_unary(self, old_and_new, monkeypatch):
        names, new_port, _old_port = old_and_new
        monkeypatch.setenv("KARMADA_TPU_ESTIMATOR_BATCH", "0")
        registry, conn = self._registry(names, new_port)
        try:
            est = registry.make_batch_estimator(names, timeout_seconds=5.0)
            out = est(reqs_matrix([1000, 2000]), np.asarray([5, 5]))
            assert (out >= 0).all()
            assert registry.rpc_counts["batch"] == 0
            assert registry.rpc_counts["unary"] == 2 * len(names)
        finally:
            conn.close()


class TestPerColumnCompleteness:
    def test_straggler_does_not_block_healthy_memoization(self):
        """One dead server must not force the healthy clusters to re-pay
        the fan-out next pass (the old whole-matrix `complete` gate did)."""
        names = ["live1", "live2", "dead"]
        caches = make_member_caches(names[:2])
        services = {
            n: EstimatorService(AccurateEstimator(n, caches[n]))
            for n in names[:2]
        }
        srv = EstimatorGrpcServer(MultiClusterEstimatorService(services))
        port = srv.start()
        conn = GrpcEstimatorConnection(
            "multi", f"127.0.0.1:{port}", timeout_seconds=5.0
        )
        dead_conn = GrpcEstimatorConnection(
            "dead", "127.0.0.1:1", timeout_seconds=0.5
        )
        registry = EstimatorRegistry()
        try:
            for n in names[:2]:
                registry.register(
                    RemoteAccurateEstimator(n, conn, lambda: list(DIMS))
                )
            registry.register(
                RemoteAccurateEstimator("dead", dead_conn, lambda: list(DIMS))
            )
            est = registry.make_batch_estimator(names, timeout_seconds=5.0)
            reqs = reqs_matrix([1000, 2000])
            out = est(reqs, np.asarray([5, 5]))
            assert (out[:, :2] >= 0).all()
            assert (out[:, 2] == -1).all()
            batches_first = registry.rpc_counts["batch"]

            # healthy columns answered from memo; only the straggler is
            # re-attempted
            out2 = est(reqs, np.asarray([5, 5]))
            assert (out2 == out).all()
            assert (
                registry.rpc_counts["batch"] == batches_first + 1
            ), "only the dead server's group should re-fan"
        finally:
            conn.close()
            dead_conn.close()
            srv.stop()


class TestDegradedPassNeverReplayed:
    class FlakyConn:
        """In-proc transport seam with a kill switch: while ``down``, every
        call fails like an unreachable server."""

        def __init__(self, service):
            from karmada_tpu_torch.estimator.service import EstimatorConnection

            self._inner = EstimatorConnection("multi", service)
            self.down = False

        def call(self, method, request):
            if self.down:
                raise ConnectionError("server unreachable")
            return self._inner.call(method, request)

    def test_recovered_cluster_invalidates_replay_token(self):
        """The arming race: a pass degraded by a transiently-down server
        must never become replayable just because the server recovers in
        time for the post-pass confirmation ping — refresh_token has to
        answer None until a full pass re-answers the cluster."""
        caches = make_member_caches(["a"])
        svc = MultiClusterEstimatorService(
            {"a": EstimatorService(AccurateEstimator("a", caches["a"]))}
        )
        conn = self.FlakyConn(svc)
        registry = EstimatorRegistry()
        registry.register(RemoteAccurateEstimator("a", conn, lambda: DIMS))
        est = registry.make_batch_estimator(["a"], timeout_seconds=2.0)
        reqs = reqs_matrix([1000])
        reps = np.asarray([5])

        # healthy pass: memoized, confirmed, replayable
        out1 = est(reqs, reps)
        assert (out1 >= 0).all()
        token1 = est.refresh_token()
        assert token1 is not None

        # server drops; the invalidated pass cannot confirm -> -1
        registry.invalidate()
        conn.down = True
        out2 = est(reqs, reps)
        assert (out2 == -1).all()
        # server recovers JUST in time for the confirmation probe: the
        # generation still matches, so confirm_token could confirm — but
        # the degraded pass must not be replayable
        conn.down = False
        assert est.refresh_token() is None

        # the next full pass answers from the still-valid memo and
        # becomes replayable again
        out3 = est(reqs, reps)
        assert (out3 == out1).all()
        assert est.refresh_token() is not None


class TestSchedulerParity:
    def test_batch_and_fallback_placements_identical(self):
        """End to end through TensorScheduler: estimator-backed placements
        are identical between the batched protocol and the unary fallback,
        and identical to the snapshot-fed engine (min-merge degeneracy:
        each cluster's single node holds exactly the snapshot's free
        capacity)."""
        from karmada_tpu_torch.utils.builders import (
            dynamic_weight_placement,
            synthetic_fleet,
        )
        from karmada_tpu_torch.utils.quantity import parse_resource_list

        snap = ClusterSnapshot(synthetic_fleet(8, seed=77))
        dims = list(snap.dims)
        free = np.maximum(np.asarray(snap.available_cap), 0)
        services = {}
        for i, name in enumerate(snap.names):
            node = NodeState(
                name=f"{name}-n0",
                allocatable={d: int(free[i][r]) for r, d in enumerate(dims)},
            )
            services[name] = EstimatorService(
                AccurateEstimator(name, NodeCache(dims, [node]))
            )
        srv = EstimatorGrpcServer(MultiClusterEstimatorService(services))
        old_srv = EstimatorGrpcServer(
            MultiClusterEstimatorService(services), enable_batch=False
        )
        port, old_port = srv.start(), old_srv.start()

        rng = np.random.default_rng(3)
        pl = dynamic_weight_placement()
        profiles = [
            parse_resource_list(
                {"cpu": f"{250 * (p + 1)}m", "memory": f"{512 * (p + 1)}Mi"}
            )
            for p in range(4)
        ]
        problems = [
            BindingProblem(
                key=f"e{i}", placement=pl,
                replicas=int(rng.integers(1, 40)),
                requests=profiles[int(rng.integers(0, 4))],
                gvk="apps/v1/Deployment",
            )
            for i in range(96)
        ]

        def run(target_port):
            registry = EstimatorRegistry()
            conn = GrpcEstimatorConnection(
                "multi", f"127.0.0.1:{target_port}", timeout_seconds=5.0
            )
            try:
                for name in snap.names:
                    registry.register(
                        RemoteAccurateEstimator(
                            name, conn, lambda: list(dims)
                        )
                    )
                batch = registry.make_batch_estimator(
                    snap.names, timeout_seconds=5.0
                )
                eng = TensorScheduler(snap, extra_estimators=[batch])
                return eng.schedule(problems), registry
            finally:
                conn.close()

        try:
            res_batch, reg_batch = run(port)
            res_fallback, reg_fallback = run(old_port)
            assert reg_batch.rpc_counts["batch"] >= 1
            assert reg_batch.rpc_counts["unary"] == 0
            assert reg_fallback.rpc_counts["unary"] > 0
            plain = TensorScheduler(snap).schedule(problems)
            for a, b, c in zip(res_batch, res_fallback, plain):
                assert a.success == b.success == c.success
                assert dict(a.clusters) == dict(b.clusters) == dict(c.clusters)
            assert placed(res_batch) == jax_plain(8, 77, 3, 96)
        finally:
            srv.stop()
            old_srv.stop()


class TestChannelResilience:
    """The estimator channel under the unified resilience policy —
    wire failures reset the batch negotiation (re-probe before reuse), a
    breaker-open server answers -1 with zero executor/wire cost, and the
    breaker recovers half-open -> closed without operator action."""

    def _one_server_registry(self, name="a", reset="0.3"):
        import os

        os.environ["KARMADA_TPU_BREAKER_RESET_SECONDS"] = reset
        try:
            caches = make_member_caches([name])
            svc = MultiClusterEstimatorService(
                {name: EstimatorService(AccurateEstimator(name, caches[name]))}
            )
            srv = EstimatorGrpcServer(svc, "127.0.0.1:0")
            port = srv.start()
            conn = GrpcEstimatorConnection(
                name, f"127.0.0.1:{port}", timeout_seconds=2.0
            )
            registry = EstimatorRegistry()
            registry.register(
                RemoteAccurateEstimator(name, conn, lambda: list(DIMS))
            )
        finally:
            del os.environ["KARMADA_TPU_BREAKER_RESET_SECONDS"]
        return caches, svc, srv, port, conn, registry

    def test_wire_failure_resets_batch_negotiation(self):
        """A server that dies and returns mid-pass must re-probe the batch
        protocol before reuse: the returning build may be OLDER (no batch
        handler), and a pinned supports_batch=True would ship it batch
        RPCs forever."""
        caches, svc, srv, port, conn, registry = self._one_server_registry()
        try:
            est = registry.make_batch_estimator(["a"], timeout_seconds=2.0)
            out = est(reqs_matrix([1000]), np.asarray([5]))
            assert (out >= 0).all()
            assert conn.supports_batch is True

            srv.stop(0)
            registry.invalidate(drop=True)
            out = est(reqs_matrix([1000]), np.asarray([5]))
            assert (out == -1).all()
            # the wire failure reset the pin: next use re-negotiates
            assert conn.supports_batch is None

            # the server returns AS AN OLD BUILD on the same port
            old_srv = EstimatorGrpcServer(
                svc, f"127.0.0.1:{port}", enable_batch=False
            )
            old_srv.start()
            try:
                import grpc as _grpc

                _grpc.channel_ready_future(conn._channel).result(timeout=10)
                conn.breaker.record_success()  # heal: recovery is below
                registry.invalidate(drop=True)
                out = est(reqs_matrix([1000]), np.asarray([5]))
                assert (out >= 0).all()
                assert conn.supports_batch is False  # unary negotiated
                assert registry.rpc_counts["unary"] > 0
            finally:
                old_srv.stop(0)
        finally:
            try:
                srv.stop(0)
            except Exception:
                pass
            conn.close()

    def test_breaker_open_answers_unauthentic_with_zero_wire_cost(self):
        from karmada_tpu_torch.utils import backoff
        from karmada_tpu_torch.utils.metrics import circuit_state

        caches, svc, srv, port, conn, registry = self._one_server_registry(
            reset="30"
        )
        try:
            est = registry.make_batch_estimator(["a"], timeout_seconds=2.0)
            out = est(reqs_matrix([1000]), np.asarray([5]))
            assert (out >= 0).all()

            srv.stop(0)
            # burn passes until the breaker opens (each degraded pass
            # costs a ping and/or fetch attempt)
            for _ in range(4):
                registry.invalidate(drop=True)
                est(reqs_matrix([1000]), np.asarray([5]))
                if conn.breaker.state == backoff.OPEN:
                    break
            assert conn.breaker.state == backoff.OPEN
            assert (
                circuit_state.value(channel=f"estimator@127.0.0.1:{port}")
                == backoff.OPEN
            )
            # breaker-open pass: -1 immediately, ZERO new wire traffic
            before = dict(registry.rpc_counts)
            registry.invalidate(drop=True)
            out = est(reqs_matrix([1000]), np.asarray([5]))
            assert (out == -1).all()
            assert dict(registry.rpc_counts) == before
            # degraded and never replayable
            assert est.refresh_token() is None
        finally:
            conn.close()

    def test_breaker_recovers_half_open_to_closed_without_operator(self):
        import time as _time

        from karmada_tpu_torch.utils import backoff
        from karmada_tpu_torch.utils.metrics import circuit_state

        caches, svc, srv, port, conn, registry = self._one_server_registry(
            reset="0.3"
        )
        try:
            est = registry.make_batch_estimator(["a"], timeout_seconds=2.0)
            out1 = est(reqs_matrix([1000]), np.asarray([5]))
            assert (out1 >= 0).all()

            srv.stop(0)
            for _ in range(4):
                registry.invalidate(drop=True)
                est(reqs_matrix([1000]), np.asarray([5]))
                if conn.breaker.state == backoff.OPEN:
                    break
            assert conn.breaker.state == backoff.OPEN

            # server returns on the same port; after the reset window the
            # next pass IS the half-open probe and closes the breaker —
            # no operator action, no registry surgery
            srv2 = EstimatorGrpcServer(svc, f"127.0.0.1:{port}")
            srv2.start()
            try:
                import grpc as _grpc

                _grpc.channel_ready_future(conn._channel).result(timeout=10)
                _time.sleep(0.35)  # past the breaker reset window
                registry.invalidate(drop=True)
                out2 = est(reqs_matrix([1000]), np.asarray([5]))
                assert (out2 == out1).all()
                assert conn.breaker.state == backoff.CLOSED
                assert (
                    circuit_state.value(
                        channel=f"estimator@127.0.0.1:{port}"
                    )
                    == backoff.CLOSED
                )
                assert est.refresh_token() is not None
            finally:
                srv2.stop(0)
        finally:
            conn.close()


class TestQuotaPluginWireParity:
    """The batch matrix path must apply the
    ResourceQuota plugin's namespace cap identically to the per-profile
    unary path — for every (namespace, profile) the batch row's answer
    over the wire equals the unary answer with the same namespace."""

    def _quota_service(self):
        from karmada_tpu_torch.estimator.accurate import ResourceQuotaPlugin

        caches = make_member_caches(["q"], cpu_step=64_000)
        plugin = ResourceQuotaPlugin({
            "teamA": {"cpu": 3_000},  # caps cpu-requesting profiles at 3/req
            "teamB": {"cpu": 10_000},
        })
        return EstimatorService(
            AccurateEstimator("q", caches["q"], quota_plugin=plugin)
        )

    def _parity(self, conn):
        cpus = [1000, 500, 250]
        rows = reqs_matrix(cpus).tolist()
        for ns in ("teamA", "teamB", "unquotad", ""):
            batch = conn.call(
                "MaxAvailableReplicasBatch",
                MaxAvailableReplicasBatchRequest(
                    clusters=["q"], dims=list(DIMS), rows=rows,
                    namespaces=[ns] * len(rows),
                ),
            )
            got = list(batch.results[0].max_replicas)
            want = [
                conn.call(
                    "MaxAvailableReplicas",
                    MaxAvailableReplicasRequest(
                        cluster="q",
                        resource_request={
                            d: int(v) for d, v in zip(DIMS, row) if v > 0
                        },
                        namespace=ns,
                    ),
                ).max_replicas
                for row in rows
            ]
            assert got == want, (ns, got, want)
        return True

    def test_inproc_parity_and_cap_applied(self):
        from karmada_tpu_torch.estimator.service import EstimatorConnection
        from karmada_tpu_torch.utils.features import (
            RESOURCE_QUOTA_ESTIMATE,
            feature_gate,
        )

        svc = self._quota_service()
        conn = EstimatorConnection("q", svc)
        feature_gate.set(RESOURCE_QUOTA_ESTIMATE, True)
        try:
            assert self._parity(conn)
            # and the cap actually bites: 1000m profile in teamA fits 3
            resp = conn.call(
                "MaxAvailableReplicasBatch",
                MaxAvailableReplicasBatchRequest(
                    clusters=["q"], dims=list(DIMS),
                    rows=reqs_matrix([1000]).tolist(),
                    namespaces=["teamA"],
                ),
            )
            assert list(resp.results[0].max_replicas) == [3]
        finally:
            feature_gate.set(RESOURCE_QUOTA_ESTIMATE, False)

    def test_grpc_wire_parity_and_namespace_roundtrip(self):
        from karmada_tpu_torch.utils.features import (
            RESOURCE_QUOTA_ESTIMATE,
            feature_gate,
        )

        svc = self._quota_service()
        srv = EstimatorGrpcServer(
            MultiClusterEstimatorService({"q": svc})
        )
        port = srv.start()
        conn = GrpcEstimatorConnection(
            "q", f"127.0.0.1:{port}", timeout_seconds=5.0
        )
        feature_gate.set(RESOURCE_QUOTA_ESTIMATE, True)
        try:
            assert self._parity(conn)
        finally:
            feature_gate.set(RESOURCE_QUOTA_ESTIMATE, False)
            conn.close()
            srv.stop()

    def test_namespace_free_batch_unchanged(self):
        """Old clients (no namespaces field) keep the pre-quota answers
        even with a plugin registered and the feature on."""
        from karmada_tpu_torch.estimator.service import EstimatorConnection
        from karmada_tpu_torch.utils.features import (
            RESOURCE_QUOTA_ESTIMATE,
            feature_gate,
        )

        svc = self._quota_service()
        conn = EstimatorConnection("q", svc)
        feature_gate.set(RESOURCE_QUOTA_ESTIMATE, True)
        try:
            resp = conn.call(
                "MaxAvailableReplicasBatch",
                MaxAvailableReplicasBatchRequest(
                    clusters=["q"], dims=list(DIMS),
                    rows=reqs_matrix([1000]).tolist(),
                ),
            )
            assert list(resp.results[0].max_replicas) == [64]  # node fit
        finally:
            feature_gate.set(RESOURCE_QUOTA_ESTIMATE, False)


# --------------------------------------------------------------------------
# tests/test_estimator_fanout.py on the port: a spawned fleet of
# ``python -m karmada_tpu_torch.estimator --device cpu`` servers
# --------------------------------------------------------------------------


C, B, SERVERS = 16, 500, 2


@pytest.fixture()
def estimator_fleet():
    clusters = synthetic_fleet(C, seed=77)
    snap = ClusterSnapshot(clusters)
    dims = list(snap.dims)
    free = np.maximum(np.asarray(snap.available_cap), 0)
    with spawn_estimator_fleet(
        snap.names, free, dims, n_servers=SERVERS, index=snap.index,
        timeout_seconds=5.0, device="cpu",
    ) as fleet:
        yield snap, fleet.registry


def make_problems(snap):
    rng = np.random.default_rng(17)
    pl = dynamic_weight_placement()
    profiles = [
        parse_resource_list(
            {"cpu": f"{250 * (p + 1)}m", "memory": f"{512 * (p + 1)}Mi"}
        )
        for p in range(4)
    ]
    return [
        BindingProblem(
            key=f"e{i}", placement=pl,
            replicas=int(rng.integers(1, 40)),
            requests=profiles[int(rng.integers(0, 4))],
            gvk="apps/v1/Deployment",
        )
        for i in range(B)
    ]


class TestEstimatorFanout:
    def test_live_fanout_identity_and_memo(self, estimator_fleet):
        snap, registry = estimator_fleet
        batch = registry.make_batch_estimator(
            snap.names, timeout_seconds=5.0
        )
        problems = make_problems(snap)
        eng = TensorScheduler(snap, extra_estimators=[batch])
        res = eng.schedule(problems)
        assert registry.fanout_seconds_total > 0, "no live fan-out happened"

        # memo: a repeat pass answers from the profile memo, not the wire
        f0 = registry.fanout_seconds_total
        res2 = eng.schedule(problems)
        assert registry.fanout_seconds_total == f0
        # invalidation (the cluster-event staleness hook) re-queries live
        registry.invalidate()
        eng.schedule(problems)
        assert registry.fanout_seconds_total > f0

        # identity vs the snapshot-fed engine (min-merge degeneracy)
        plain = TensorScheduler(snap).schedule(problems)
        for a, b in zip(res, plain):
            assert a.success == b.success
            assert dict(a.clusters) == dict(b.clusters)
        for a, b in zip(res2, plain):
            assert dict(a.clusters) == dict(b.clusters)
        assert placed(res) == placed(res2) == jax_plain(C, 77, 17, B)

    def test_dead_server_answers_unauthentic(self, estimator_fleet):
        snap, registry = estimator_fleet
        # point one cluster at a dead target: it must answer -1 (ignored by
        # the min-merge) without failing the batch
        dead = GrpcEstimatorConnection(
            "dead", "127.0.0.1:1", timeout_seconds=0.5
        )
        dims = list(snap.dims)
        registry.register(
            RemoteAccurateEstimator(snap.names[0], dead, lambda: dims)
        )
        batch = registry.make_batch_estimator(
            snap.names, timeout_seconds=5.0
        )
        reqs = np.zeros((3, len(dims)), np.int64)
        reqs[:, 0] = 250
        out = batch(reqs, np.asarray([5, 5, 5]))
        assert (out[:, 0] == -1).all()
        assert (out[:, 1:] >= 0).all()
        dead.close()


# --------------------------------------------------------------------------
# across the packages, on one wire
# --------------------------------------------------------------------------


def _wire_run(client_pkg, server_pkg, batch: bool) -> list:
    """``client_pkg``'s registry over its GrpcEstimatorConnections to two
    ``server_pkg`` servers hosting two clusters each (``enable_batch=False``
    without ``batch``: the old-server shape): a cold pass, a no-movement
    refresh, a pod event on one cluster, a unary MaxAvailableReplicas with
    a node claim, then an engine pass of ``client_pkg`` fed by the
    registry. Returns every answer and the registry's RPC counts."""
    sacc, ssvc = mod(server_pkg, "estimator.accurate"), mod(server_pkg, "estimator.service")
    strans = mod(server_pkg, "estimator.grpc_transport")
    cacc, csvc = mod(client_pkg, "estimator.accurate"), mod(client_pkg, "estimator.service")
    ctrans = mod(client_pkg, "estimator.grpc_transport")
    kw = {"device": "cpu"} if server_pkg is karmada_tpu_torch else {}
    snap, problems = estimate_scene(client_pkg, 4, 77, 5, 64)
    dims = list(snap.dims)
    free = np.maximum(np.asarray(snap.available_cap), 0)
    caches = {
        name: sacc.NodeCache(dims, [sacc.NodeState(
            name="n0", allocatable={d: int(free[i][r]) for r, d in enumerate(dims)},
            labels={"zone": f"z{i % 2}"})])
        for i, name in enumerate(snap.names)
    }
    services = {n: ssvc.EstimatorService(sacc.AccurateEstimator(n, caches[n], **kw))
                for n in snap.names}
    servers, conns, out = [], [], []
    registry = cacc.EstimatorRegistry()
    try:
        for hosted in (snap.names[:2], snap.names[2:]):
            srv = strans.EstimatorGrpcServer(
                ssvc.MultiClusterEstimatorService({n: services[n] for n in hosted}),
                enable_batch=batch)
            port = srv.start()
            servers.append(srv)
            conn = ctrans.GrpcEstimatorConnection("multi", f"127.0.0.1:{port}",
                                                  timeout_seconds=5.0)
            conns.append(conn)
            for n in hosted:
                registry.register(ctrans.RemoteAccurateEstimator(n, conn, lambda: dims))
        est = registry.make_batch_estimator(snap.names, timeout_seconds=5.0)
        reqs = np.zeros((3, len(dims)), np.int64)
        reqs[:, 0] = (500, 1500, 4000)
        reps = np.asarray([5, 5, 5])
        for step in range(3):
            if step == 2:
                caches[snap.names[1]].add_pod("n0", {"cpu": 1000})
            if step:
                registry.invalidate()
            out.append(est(reqs, reps).tolist())
            out.append(dict(registry.rpc_counts))
        out.append(conns[0].call("MaxAvailableReplicas", csvc.MaxAvailableReplicasRequest(
            cluster=snap.names[0], resource_request={"cpu": 250},
            node_selector={"zone": "z0"})).max_replicas)
        eng_kw = {"device": "cpu"} if client_pkg is karmada_tpu_torch else {}
        eng = mod(client_pkg, "scheduler").TensorScheduler(
            snap, extra_estimators=[est], **eng_kw)
        out.append(placed(eng.schedule(problems)))
        return out
    finally:
        for conn in conns:
            conn.close()
        for srv in servers:
            srv.stop(0)


@pytest.mark.parametrize("batch", [True, False], ids=["batch", "unary-fallback"])
@pytest.mark.parametrize("client_pkg,server_pkg", [
    (karmada_tpu, karmada_tpu_torch), (karmada_tpu_torch, karmada_tpu),
    (karmada_tpu_torch, karmada_tpu_torch)], ids=["jax-registry-torch-server",
                                                   "torch-registry-jax-server",
                                                   "torch-registry-torch-server"])
def test_estimator_wire_across_packages_equals_all_jax(client_pkg, server_pkg, batch):
    """Each pair's answers, RPC counts and engine placements equal the
    all-JAX pair's."""
    want = _wire_run(karmada_tpu, karmada_tpu, batch)
    assert want[1] == ({"batch": 2, "unary": 0, "ping": 0} if batch
                       else {"batch": 2, "unary": 12, "ping": 0})
    assert _wire_run(client_pkg, server_pkg, batch) == want


@pytest.mark.parametrize("env,value,batch", [
    ("KARMADA_TPU_ESTIMATOR_PING_SECONDS", "3600", True),
    ("KARMADA_TPU_ESTIMATOR_FALLBACK_WIDTH", "1", False),
    ("KARMADA_TPU_ESTIMATOR_FALLBACK_WIDTH", "4", False),
], ids=["ping-trust-window", "fallback-width-1", "fallback-width-4"])
def test_estimator_env_knob_equals_jax(monkeypatch, env, value, batch):
    """The registry's operator settings, set for both packages: the port's
    registry over the port's servers answers, and counts its RPCs, as the
    all-JAX pair does under the same setting. Inside the ping trust window
    an ``invalidate()`` sends no ping (and a pod event inside it is not
    seen, the window's staleness contract); the unary fallback's window
    width changes no answer and no RPC count."""
    default = _wire_run(karmada_tpu, karmada_tpu, batch)
    monkeypatch.setenv(env, value)
    want = _wire_run(karmada_tpu, karmada_tpu, batch)
    if env.endswith("PING_SECONDS"):
        assert [want[i]["ping"] for i in (1, 3, 5)] == [0, 0, 0]
        assert default[3]["ping"] > 0
    else:
        assert want == default
    assert _wire_run(karmada_tpu_torch, karmada_tpu_torch, batch) == want


@pytest.mark.parametrize("action", ["error", "drop", "delay"])
def test_injected_estimator_rpc_fault_equals_jax(action):
    """Each package's ``estimator.rpc`` seam armed alike (the first
    GetGenerations ping faulted): a failed ping leaves its clusters
    unconfirmed, so the pass re-fetches them with a batch RPC; the answers,
    RPC counts and the fired-event log equal the JAX package's."""
    def run(pkg):
        fi = mod(pkg, "utils.faultinject")
        acc, svc = mod(pkg, "estimator.accurate"), mod(pkg, "estimator.service")
        trans = mod(pkg, "estimator.grpc_transport")
        kw = {"device": "cpu"} if pkg is karmada_tpu_torch else {}
        caches = {n: acc.NodeCache(DIMS, [acc.NodeState(
            name="n0", allocatable={"cpu": 8000 * (i + 1), "memory": 1 << 34, "pods": 110})])
            for i, n in enumerate(("a", "b"))}
        srv = trans.EstimatorGrpcServer(svc.MultiClusterEstimatorService({
            n: svc.EstimatorService(acc.AccurateEstimator(n, c, **kw))
            for n, c in caches.items()}))
        port = srv.start()
        conn = trans.GrpcEstimatorConnection("multi", f"127.0.0.1:{port}", timeout_seconds=5.0)
        registry = acc.EstimatorRegistry()
        for n in caches:
            registry.register(trans.RemoteAccurateEstimator(n, conn, lambda: list(DIMS)))
        est = registry.make_batch_estimator(["a", "b"], timeout_seconds=5.0)
        fi.arm(f"estimator.rpc={action},match=GetGenerations,count=1,delay=0.01", seed=1)
        try:
            out = []
            for step in range(3):
                if step:
                    registry.invalidate()
                out.append(est(reqs_matrix([1000, 3000]), np.asarray([4, 4])).tolist())
                out.append(dict(registry.rpc_counts))
            out.append([(e.point, e.action, e.key) for e in fi.injector().log])
            return out
        finally:
            fi.disarm()
            conn.close()
            srv.stop(0)

    want = run(karmada_tpu)
    assert want[-1] == [("estimator.rpc", action, "GetGenerations:multi")]
    assert want[3] == ({"batch": 2, "unary": 0, "ping": 1} if action != "delay"
                       else {"batch": 1, "unary": 0, "ping": 1})
    assert run(karmada_tpu_torch) == want
