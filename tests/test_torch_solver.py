"""The port's solver sidecar against the JAX package on the CPU.

The port's ``SolverService`` (engine on ``device="cpu"``) behind its
``SolverGrpcServer``, its ``RemoteSolver`` and ``HASolver``, and the
protobuf-free core (``sync_clusters`` / ``solve``) are held to the JAX
in-process ``TensorScheduler`` on the same seeded clusters and problems:
the scenarios of ``tests/test_solver_sidecar.py`` (loopback, the stale
re-sync, HA failover and the cold standby, the deadline budget). Across the
packages, on one wire: a JAX ``RemoteSolver`` against the port's server and
the port's client against the JAX server answer what the all-JAX pair
answers; the unchanged JAX control plane schedules through a ``python -m
karmada_tpu_torch.solver --device cpu`` child, its bindings equal to a JAX
plane on the in-process engine; the port's ``ControlPlane(solver=...)``
equals the JAX plane over the JAX sidecar on ``run_both`` (with the quota
and priority reroutes and the degraded fallback); and the estimator-aware
sidecar (``solver.__main__.estimator_service``) equals the JAX engine fed
by the JAX registry. Tolerance: exact equality (integer placements) on the
fields the JAX tests compare (key, placements, error, feasible set,
affinity name).
"""

import importlib
import sys
import threading
import time

import numpy as np
import pytest

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.solver as JSOL
import karmada_tpu_torch
import karmada_tpu_torch.solver as TSOL
from karmada_tpu_torch.localup import scrape_line, spawn_child

from test_torch_controlplane import run_both

PKGS = (karmada_tpu, karmada_tpu_torch)


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def fleet(pkg, n, seed):
    return mod(pkg, "utils.builders").synthetic_fleet(n, seed=seed)


def make_problems(pkg, clusters, n=40, seed=0):
    """``tests/test_solver_sidecar.py``'s ``_problems`` in ``pkg``."""
    b = mod(pkg, "utils.builders")
    req = mod(pkg, "utils.quantity").parse_resource_list({"cpu": "250m", "memory": "512Mi"})
    rng = np.random.default_rng(seed)
    pls = [
        b.dynamic_weight_placement(),
        b.duplicated_placement(),
        b.static_weight_placement({clusters[0].name: 2, clusters[1].name: 1}),
    ]
    return [
        mod(pkg, "scheduler").BindingProblem(
            key=f"b{i}",
            placement=pls[i % 3],
            replicas=int(rng.integers(0, 20)),
            requests=req,
            gvk="apps/v1/Deployment",
            prev={clusters[int(j)].name: int(rng.integers(1, 5))
                  for j in rng.choice(len(clusters), 2, replace=False)},
            fresh=bool(rng.random() < 0.2),
        )
        for i in range(n)
    ]


def outcome(results):
    return [(r.key, dict(r.clusters), r.error, tuple(sorted(r.feasible)), r.affinity_name)
            for r in results]


def jax_in_proc(n_clusters, fleet_seed, n=40, seed=0):
    """The JAX in-process engine's answer: the referent of every test."""
    clusters = fleet(karmada_tpu, n_clusters, fleet_seed)
    snap = JS.ClusterSnapshot(sorted(clusters, key=lambda c: c.name))
    return outcome(JS.TensorScheduler(snap).schedule(
        make_problems(karmada_tpu, clusters, n, seed)))


def serve(pkg, service=None):
    sol = mod(pkg, "solver")
    if service is None:
        service = (sol.SolverService(device="cpu") if pkg is karmada_tpu_torch
                   else sol.SolverService())
    srv = sol.SolverGrpcServer(service, "127.0.0.1:0")
    return service, srv, srv.start()


@pytest.fixture(scope="module")
def loopback():
    service, server, port = serve(karmada_tpu_torch)
    client = TSOL.RemoteSolver(f"127.0.0.1:{port}")
    yield client, service
    client.close()
    server.stop()


def test_loopback_matches_jax_in_proc_engine(loopback):
    client, _ = loopback
    clusters = fleet(karmada_tpu_torch, 12, 3)
    client.sync_clusters(clusters)
    remote = client.schedule(make_problems(karmada_tpu_torch, clusters))
    assert outcome(remote) == jax_in_proc(12, 3)


def test_stale_snapshot_resyncs(loopback):
    client, service = loopback
    clusters = fleet(karmada_tpu_torch, 8, 4)
    client.sync_clusters(clusters)
    # simulate a solver restart losing the snapshot
    service._engine = None
    service._version = 0
    client._cluster_source = lambda: clusters
    results = client.schedule(make_problems(karmada_tpu_torch, clusters, n=5))
    assert service.snapshot_version == client._version
    assert outcome(results) == jax_in_proc(8, 4, n=5)


class TestHASolver:
    """HA solver replicas on the port: schedule() sticks to the active
    backend, fails over on transport errors, and standbys answer the JAX
    engine's placements because syncs broadcast (or the FAILED_PRECONDITION
    re-sync heals a cold one)."""

    def test_failover_mid_storm_is_placement_identical(self):
        servers = [serve(karmada_tpu_torch)[1:] for _ in range(2)]
        ha = TSOL.HASolver([f"127.0.0.1:{port}" for _, port in servers])
        try:
            clusters = fleet(karmada_tpu_torch, 12, 5)
            problems = make_problems(karmada_tpu_torch, clusters, n=30, seed=9)
            ha._cluster_source = lambda: clusters
            ha.sync_clusters(clusters)
            want = jax_in_proc(12, 5, n=30, seed=9)
            assert outcome(ha.schedule(problems)) == want
            assert ha.active_target == 0
            # kill the active backend: the next schedule must fail over
            # and stay identical
            servers[0][0].stop(0)
            assert outcome(ha.schedule(problems)) == want
            assert ha.active_target == 1
        finally:
            for srv, _ in servers:
                srv.stop(0)
            ha.close()

    def test_cold_standby_heals_via_resync(self):
        (_, srv_a, pa), (_, srv_b, pb) = serve(karmada_tpu_torch), serve(karmada_tpu_torch)
        ha = TSOL.HASolver([f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"])
        try:
            clusters = fleet(karmada_tpu_torch, 10, 6)
            problems = make_problems(karmada_tpu_torch, clusters, n=12, seed=2)
            ha._cluster_source = lambda: clusters
            # sync ONLY the active (simulates b joining later)
            ha._solvers[0].sync_clusters(clusters)
            res_a = ha.schedule(problems)
            srv_a.stop(0)
            res_b = ha.schedule(problems)  # b is cold -> re-sync path
            assert outcome(res_a) == outcome(res_b) == jax_in_proc(10, 6, n=12, seed=2)
        finally:
            srv_a.stop(0)
            srv_b.stop(0)
            ha.close()


class TestDeadlineBudget:
    """One overall deadline budget threads through the port client's
    schedule(): score, re-sync and retry share it."""

    def test_stalled_resync_path_fails_within_one_budget(self):
        import grpc

        svc = TSOL.SolverService(device="cpu")
        stall = threading.Event()
        real_sync = svc.sync_clusters
        real_score = svc.score_and_assign

        def slow_sync(clusters, version):
            time.sleep(1.2)  # succeeds, but eats most of the 1.5s budget
            return real_sync(clusters, version)

        def stalling_score(request):
            if svc.snapshot_version == request.snapshot_version:
                stall.wait(timeout=30.0)  # the RETRY black-holes
            return real_score(request)

        svc.sync_clusters = slow_sync
        svc.score_and_assign = stalling_score
        _, srv, port = serve(karmada_tpu_torch, svc)
        clusters = fleet(karmada_tpu_torch, 6, 3)
        solver = TSOL.RemoteSolver(f"127.0.0.1:{port}", timeout_seconds=1.5,
                                   cluster_source=lambda: clusters)
        try:
            problems = make_problems(karmada_tpu_torch, clusters, n=4, seed=1)
            t0 = time.perf_counter()
            with pytest.raises(grpc.RpcError):
                solver.schedule(problems)
            elapsed = time.perf_counter() - t0
            assert elapsed < 1.5 * 1.4, f"schedule took {elapsed:.2f}s"
        finally:
            stall.set()
            solver.close()
            srv.stop(0)

    def test_dead_solver_fails_within_one_budget(self):
        import grpc

        clusters = fleet(karmada_tpu_torch, 4, 2)
        solver = TSOL.RemoteSolver("127.0.0.1:1", timeout_seconds=1.0,
                                   cluster_source=lambda: clusters)
        try:
            t0 = time.perf_counter()
            with pytest.raises(grpc.RpcError):
                solver.schedule(make_problems(karmada_tpu_torch, clusters, n=2, seed=4))
            assert time.perf_counter() - t0 < 1.8
        finally:
            solver.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    (karmada_tpu, karmada_tpu_torch), (karmada_tpu_torch, karmada_tpu),
    (karmada_tpu_torch, karmada_tpu_torch)], ids=["jax-client-torch-server",
                                                   "torch-client-jax-server",
                                                   "torch-client-torch-server"])
def test_wire_across_packages_equals_all_jax(client_pkg, server_pkg):
    """One wire, two packages: each pair's answers (a cold sync, a second
    batch, and a FAILED_PRECONDITION re-sync after the server lost its
    snapshot) equal the all-JAX pair's, result for result."""
    def run(cpkg, spkg):
        service, srv, port = serve(spkg)
        clusters = fleet(cpkg, 16, 11)
        client = mod(cpkg, "solver").RemoteSolver(
            f"127.0.0.1:{port}", cluster_source=lambda: clusters)
        try:
            client.sync_clusters(clusters)
            out = [outcome(client.schedule(make_problems(cpkg, clusters, 50, s)))
                   for s in (0, 1)]
            service._engine, service._version = None, 0  # a restart
            out.append(outcome(client.schedule(make_problems(cpkg, clusters, 50, 2))))
            assert service.snapshot_version == client._version == 2
            return out
        finally:
            client.close()
            srv.stop(0)

    want = run(karmada_tpu, karmada_tpu)
    assert want[0] == jax_in_proc(16, 11, 50, 0)
    assert run(client_pkg, server_pkg) == want


def test_core_fences_versions_and_equals_jax():
    """The protobuf-free core: problems as ``ProblemRecord``s (placements by
    canonical JSON), results as ``ResultRecord``s; a stale version raises
    ``StaleSnapshotError``, a re-sync answers the same rows, and an equal
    placement JSON maps to one Placement object across requests."""
    svc_mod = mod(karmada_tpu_torch, "solver.service")
    svc = svc_mod.SolverService(device="cpu")
    clusters = fleet(karmada_tpu_torch, 12, 3)
    with pytest.raises(svc_mod.StaleSnapshotError):
        svc.solve(0, [], [])
    assert svc.sync_clusters(clusters, 1) == 1
    jsons, records = svc_mod.encode_records(make_problems(karmada_tpu_torch, clusters))
    assert len(jsons) == 3 and [r.placement_idx for r in records[:4]] == [0, 1, 2, 0]
    want = jax_in_proc(12, 3)
    got = svc.solve(1, jsons, records)
    assert outcome(got) == want
    assert set(svc.last_split) == {"decode", "engine"}
    recs = svc_mod.result_records(got)
    assert [(r.key, dict(r.clusters), r.error, r.feasible, r.affinity_name)
            for r in recs] == [w if not w[2] else (w[0], {}, w[2], (), w[4]) for w in want]
    pl = svc._placement(jsons[0])
    with pytest.raises(svc_mod.StaleSnapshotError, match="mismatch"):
        svc.solve(0, jsons, records)
    svc.sync_clusters(clusters, 2)
    assert outcome(svc.solve(2, jsons, records)) == want
    assert svc._placement(jsons[0]) is pl
    # the wire route over the same core
    req = svc_mod.encode_problems(make_problems(karmada_tpu_torch, clusters))
    req.snapshot_version = 2
    resp = svc.score_and_assign(req)
    assert set(svc.last_split) == {"decode", "engine", "encode"}
    assert [(m.key, {c.name: c.replicas for c in m.clusters}, m.error, tuple(m.feasible),
             m.affinity_name) for m in resp.results] == [
        w if not w[2] else (w[0], {}, w[2], (), w[4]) for w in want]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_solver_process_backend_probe(device):
    """``python -m karmada_tpu_torch.solver --report-backend``: the port
    line, then ``solver backend cpu`` on the CPU; asked for CUDA where torch
    has none, ``solver backend error`` and exit code 4."""
    import torch

    proc = spawn_child([sys.executable, "-m", "karmada_tpu_torch.solver",
                        "--report-backend", "--device", device], device=device)
    try:
        assert int(scrape_line(proc, r"port (\d+)", timeout=120)) > 0
        kind = scrape_line(proc, r"solver backend (\w+)", timeout=120)
        if device == "cpu" or torch.cuda.is_available():
            assert kind == device
        else:
            assert kind == "error"
            assert proc.wait(timeout=30) == 4
    finally:
        proc.kill()
        proc.wait(timeout=10)


def _propagation(cp, cli):
    """``test_propagation_e2e_with_out_of_process_solver``'s scenario, then a
    scale and a second Deployment: the bindings after each settle."""
    from karmada_tpu.api import PropagationPolicy, PropagationSpec, ResourceSelector
    from karmada_tpu.api.core import ObjectMeta
    from karmada_tpu.utils.builders import dynamic_weight_placement, new_deployment

    for i in range(1, 4):
        cli.cmd_join(cp, f"member{i}")
    cp.store.apply(PropagationPolicy(
        meta=ObjectMeta(name="web-policy", namespace="default"),
        spec=PropagationSpec(
            resource_selectors=[ResourceSelector(api_version="apps/v1", kind="Deployment")],
            placement=dynamic_weight_placement(),
        ),
    ))
    states = []

    def bindings():
        return sorted((rb.meta.namespaced_name, [(tc.name, tc.replicas) for tc in rb.spec.clusters],
                       [(c.type, c.status, c.reason) for c in rb.status.conditions])
                      for rb in cp.store.list("ResourceBinding"))

    for name, replicas in (("web", 6), ("web", 11), ("api", 7)):
        cp.store.apply(new_deployment(name, replicas=replicas))
        cp.settle()
        states.append(bindings())
    works = sorted(w.meta.namespaced_name for w in cp.store.list("Work")
                   if w.meta.namespace.startswith("karmada-es-"))
    return states, works


def test_jax_plane_schedules_through_torch_sidecar_process():
    """The unchanged JAX control plane (``karmada_tpu.cli.cmd_init(solver=
    karmada_tpu.solver.RemoteSolver(...))``) against a ``python -m
    karmada_tpu_torch.solver --device cpu`` child: every binding and Work
    equals a JAX plane's on the in-process engine."""
    from karmada_tpu import cli

    proc = spawn_child([sys.executable, "-m", "karmada_tpu_torch.solver",
                        "--address", "127.0.0.1:0"], device="cpu")
    try:
        port = int(scrape_line(proc, r"port (\d+)", timeout=120))
        solver = JSOL.RemoteSolver(f"127.0.0.1:{port}")
        try:
            got = _propagation(cli.cmd_init(solver=solver), cli)
        finally:
            solver.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    want = _propagation(cli.cmd_init(), cli)
    assert got == want
    assert sum(r for _, r in got[0][0][0][1]) == 6 and got[1]


# --------------------------------------------------------------------------
# the port's ControlPlane(solver=...) against the JAX plane over its sidecar
# --------------------------------------------------------------------------


def _sidecar_plane(p, record, variant):
    """A plane over its own package's sidecar (a server in this process):
    propagation, scale; then the variant's wave: bindings in a quota'd
    namespace (rerouted to the in-process engine), a priority policy (the
    same), or a stopped sidecar (the degraded fallback; the next wave after
    the sidecar returns re-syncs first)."""
    sol = mod(p.pkg, "solver")
    metrics = mod(p.pkg, "utils.metrics")
    service = sol.SolverService(device="cpu") if p.torch else sol.SolverService()
    srv = sol.SolverGrpcServer(service, "127.0.0.1:0")
    port = srv.start()
    solver = sol.RemoteSolver(f"127.0.0.1:{port}", timeout_seconds=5.0)
    seen = {"calls": 0}
    real_solve = service.solve if p.torch else service.score_and_assign

    def counting(*args):
        seen["calls"] += 1
        return real_solve(*args)

    if p.torch:
        service.solve = counting
    else:
        service.score_and_assign = counting
    degraded0 = metrics.degraded_passes.value(channel="solver")
    try:
        cp = p.plane(solver=solver)
        for i in range(1, 4):
            cp.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
        cp.settle()
        cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement()))
        cp.store.apply(p.b.new_deployment("web", replicas=6))
        cp.settle()
        record(cp)
        cp.store.apply(p.b.new_deployment("web", replicas=9))
        cp.settle()
        record(cp)
        calls = seen["calls"]
        assert calls >= 2 and service.snapshot_version >= 1
        if variant == "quota":
            cp.store.apply(p.pol.FederatedResourceQuota(
                meta=p.core.ObjectMeta(name="quota", namespace="default"),
                spec=p.pol.FederatedResourceQuotaSpec(overall={"cpu": 2000})))
            cp.store.apply(p.b.new_deployment("quotad", replicas=8, cpu="500m"))
            cp.settle()
            record(cp)
            # the wave enforced quota in process: the sidecar saw none of it
            assert seen["calls"] == calls
            rb = cp.store.get("ResourceBinding", "default/quotad-deployment")
            assert any(c.reason == "QuotaExceeded" for c in rb.status.conditions)
        elif variant == "priority":
            cp.store.apply(p.cpp("prio", p.b.dynamic_weight_placement(), priority=10))
            cp.store.apply(p.b.new_deployment("urgent", namespace="prod", replicas=4))
            cp.settle()
            record(cp)
            rb = cp.store.get("ResourceBinding", "prod/urgent-deployment")
            assert rb.spec.priority == 10 and rb.spec.clusters
            assert seen["calls"] == calls
        else:
            srv.stop(0)
            cp.store.apply(p.b.new_deployment("web", replicas=4))
            cp.settle()
            record(cp)
            assert metrics.degraded_passes.value(channel="solver") > degraded0
            assert not cp.scheduler._solver_synced
            import grpc

            srv = sol.SolverGrpcServer(service, f"127.0.0.1:{port}")
            srv.start()
            grpc.channel_ready_future(solver._channel).result(timeout=10)
            cp.store.apply(p.b.new_deployment("web", replicas=5))
            cp.settle()
            record(cp)
            assert cp.scheduler._solver_synced and seen["calls"] > calls
    finally:
        solver.close()
        srv.stop(0)


@pytest.mark.parametrize("variant", ["quota", "priority", "degraded"])
def test_controlplane_over_sidecar_equals_jax(variant, monkeypatch):
    run_both(lambda p, record: _sidecar_plane(p, record, variant), monkeypatch)


# --------------------------------------------------------------------------
# the estimator-aware sidecar
# --------------------------------------------------------------------------


def _estimator_scene(pkg, clusters=8, nodes=40, bindings=300):
    import chip_smoke

    return chip_smoke.estimator_workload(pkg, clusters, nodes, bindings)


@pytest.mark.parametrize("route", ["core", "wire"])
def test_estimator_aware_sidecar_equals_jax_registry(route):
    """``estimator_service`` over 2 servers of 4 clusters each, behind
    in-process ``EstimatorConnection``s: a cold solve (one batch RPC a
    server), the same request (one ping a server, nothing fetched) and the
    same request after pod events on 2 clusters (one batch RPC for each
    server hosting one) each equal the JAX engine fed by the JAX
    registry over the same node states."""
    from karmada_tpu_torch.estimator import service as tsvc
    from karmada_tpu_torch.estimator.accurate import AccurateEstimator, NodeCache
    from karmada_tpu_torch.solver.__main__ import estimator_service
    from karmada_tpu_torch.solver.service import encode_records

    snap, per_cluster, problems = _estimator_scene(karmada_tpu_torch)
    caches = {n: NodeCache(snap.dims, per_cluster[n]) for n in snap.names}
    conns = {}
    for s in range(2):
        hosted = snap.names[4 * s:4 * s + 4]
        conn = tsvc.EstimatorConnection("multi", tsvc.MultiClusterEstimatorService({
            n: tsvc.EstimatorService(AccurateEstimator(n, caches[n], device="cpu"))
            for n in hosted}))
        conns.update({n: conn for n in hosted})
    service, registry = estimator_service(conns, device="cpu")

    jsnap, jper, jproblems = _estimator_scene(karmada_tpu)
    jacc = mod(karmada_tpu, "estimator.accurate")
    jcaches = {n: jacc.NodeCache(jsnap.dims, jper[n]) for n in jsnap.names}
    jreg = jacc.EstimatorRegistry()
    for n in jsnap.names:
        jreg.register(jacc.AccurateEstimator(n, jcaches[n]))
    jeng = JS.TensorScheduler(jsnap, extra_estimators=[
        jreg.make_batch_estimator(jsnap.names)])

    if route == "wire":
        _, srv, port = serve(karmada_tpu_torch, service)
        client = TSOL.RemoteSolver(f"127.0.0.1:{port}")
        client.sync_clusters(list(snap.clusters))

        def solve():
            return client.schedule(problems)
    else:
        service.sync_clusters(list(snap.clusters), 1)
        jsons, records = encode_records(problems)

        def solve():
            return service.solve(1, jsons, records)
    moved = snap.names[::4][:2]
    want_rpcs = ({"batch": 2, "unary": 0, "ping": 0}, {"batch": 2, "unary": 0, "ping": 2},
                 {"batch": 4, "unary": 0, "ping": 4})
    try:
        for step in range(3):
            if step == 2:
                for n in moved:
                    caches[n].add_pod("n0", {"cpu": 2000, "memory": 4 << 30})
                    jcaches[n].add_pod("n0", {"cpu": 2000, "memory": 4 << 30})
                jreg.invalidate()
            got = outcome(solve())
            assert got == outcome(jeng.schedule(jproblems)), f"step {step}"
            assert registry.rpc_counts == want_rpcs[step], f"step {step}"
            assert {n for n, _ in registry._memo} == set(snap.names)
    finally:
        if route == "wire":
            client.close()
            srv.stop(0)


# --------------------------------------------------------------------------
# chip_smoke's sidecar phases, rehearsed small on the CPU
# --------------------------------------------------------------------------


def test_sidecar_phase_rehearsal(capsys):
    """``chip_smoke.run_sidecar`` after a small config-5 storm: every
    request's rows equal the storm's numpy-checked cold and last passes,
    and the version-0 request raises."""
    import torch

    import chip_smoke

    cpu = torch.device("cpu")
    storm = chip_smoke.run_fleet_storm(cpu, "cpu", bindings=1200, clusters=150)
    out = chip_smoke.run_sidecar(cpu, "cpu", storm["digests"], bindings=1200, clusters=150)
    assert set(out["walls"]) == {"cold", "repeat", "re-synced", "drift"}
    assert set(out["splits"]["cold"]) == {"client encode", "decode", "engine", "encode",
                                          "client decode"}
    printed = capsys.readouterr().out
    assert printed.count("1200 ok / 0 bad") >= 4 and "raised StaleSnapshotError" in printed


def test_sidecar_estimator_phase_rehearsal(capsys):
    """``chip_smoke.run_sidecar_estimator`` on a small estimator phase's
    state: RPC counts per pass, every cluster memoized, rows equal to the
    estimator phase's."""
    import torch

    import chip_smoke

    cpu = torch.device("cpu")
    est = chip_smoke.run_estimator(cpu, "cpu", clusters=8, nodes=2100, bindings=1000)
    out = chip_smoke.run_sidecar_estimator(cpu, "cpu", est)
    assert out["rpcs"] == {"cold": {"batch": 4, "unary": 0, "ping": 0},
                           "quiet": {"batch": 0, "unary": 0, "ping": 4},
                           "pod events": {"batch": 4, "unary": 0, "ping": 4}}
    assert capsys.readouterr().out.count("1000 ok / 0 bad") >= 5


def test_sidecar_controller_phase_rehearsal(capsys):
    """``chip_smoke.run_sidecar_controller`` at 800 x 60: the cold wave on
    the sidecar, the fallback wave (300 rows, the fleet route) on the
    controller's engine with one degraded pass, the recovery wave
    re-synced, a cluster event's wave re-synced through the controller's
    handler with no unscaled row moved; every written placement held to
    the numpy divider."""
    import torch

    import chip_smoke

    out = chip_smoke.run_sidecar_controller(torch.device("cpu"), "cpu", bindings=800,
                                            clusters=60, scale=300)
    assert set(out["waves"]) == {"cold wave", "fallback wave", "recovery wave",
                                 "cluster-event wave"}
    printed = capsys.readouterr().out
    assert "800 ok / 0 bad" in printed and printed.count("300 ok / 0 bad") == 3
    assert "(syncs 3), 0 unscaled rows moved" in printed
    assert "solver sidecar unavailable (ConnectionError)" in printed


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_injected_solver_rpc_fault_takes_the_fallback(pkg):
    """``solver.rpc=error`` armed on the first ScoreAndAssign: the client
    raises a ``grpc.RpcError`` that is also a ``FaultError``, the
    controller serves that wave on its in-process engine (one degraded
    pass) and the next wave re-syncs and goes to the sidecar; the written
    placements equal the JAX in-process engine's on both packages."""
    import grpc

    fi = mod(pkg, "utils.faultinject")
    u = mod(pkg, "utils")
    metrics = mod(pkg, "utils.metrics")
    service, srv, port = serve(pkg)
    solver = mod(pkg, "solver").RemoteSolver(f"127.0.0.1:{port}")
    kw = {"device": "cpu"} if pkg is karmada_tpu_torch else {}
    store, rt = u.Store(), u.Runtime()
    ctl = mod(pkg, "controllers.scheduler_controller").SchedulerController(
        store, rt, solver=solver, **kw)
    import chip_smoke

    clusters = fleet(pkg, 12, 3)
    probs = [p for p in make_problems(pkg, clusters) if p.replicas]
    snap = mod(pkg, "scheduler").ClusterSnapshot(clusters)
    cluster_objs, rbs, _ = chip_smoke.binding_objects(pkg, snap, probs)
    degraded0 = metrics.degraded_passes.value(channel="solver")
    fi.arm("solver.rpc=error,match=ScoreAndAssign,count=1", seed=1)
    try:
        store.apply_many(cluster_objs)
        store.apply_many(rbs[:20])
        rt.run_until_settled()
        assert metrics.degraded_passes.value(channel="solver") == degraded0 + 1
        assert not ctl._solver_synced and service.snapshot_version == 1
        err = fi.injected_error("solver.rpc", "x")
        assert isinstance(err, grpc.RpcError) and isinstance(err, fi.FaultError)
        store.apply_many(rbs[20:])
        rt.run_until_settled()
        assert ctl._solver_synced and service.snapshot_version == 2
        assert [(e.point, e.action) for e in fi.injector().log] == [("solver.rpc", "error")]
    finally:
        fi.disarm()
        solver.close()
        srv.stop(0)
    want = {k: v for k, v, _, _, _ in jax_in_proc(12, 3) if v}
    got = {rb.meta.namespaced_name: {tc.name: tc.replicas for tc in rb.spec.clusters}
           for rb in rbs}
    assert got == {k: want.get(k, {}) for k in got} and len(got) == len(probs)
