"""The port's TensorScheduler against the JAX engine, result by result.

Both packages build the same BASELINE workloads from the same seeds
(``chip_smoke.build_workload``, the bench.py recipes) and schedule them;
every result must agree on key, placed clusters, error and affinity name.
Tolerance: exact equality (integer placements).

Also here: the branches the port does not implement raise, the snapshot
state carries across packages bit for bit, and the port imports neither jax
nor the JAX package.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.utils.builders  # noqa: F401  (build_workload imports it by name)

import karmada_tpu_torch
import karmada_tpu_torch.scheduler as TS
import karmada_tpu_torch.utils.builders as TB
from karmada_tpu_torch.api import ClusterAffinityTerm, Placement

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]


def outcome(results):
    return [(r.key, dict(r.clusters), r.error, r.affinity_name, tuple(r.feasible))
            for r in results]


def both(config, bindings=None, clusters=None):
    return (
        chip_smoke.build_workload(karmada_tpu, config, bindings, clusters),
        chip_smoke.build_workload(karmada_tpu_torch, config, bindings, clusters),
    )


@pytest.mark.parametrize(
    "config,bindings,clusters",
    [(1, None, None), (2, None, None), (4, 1000, None), (5, 512, 256)],
)
def test_schedule_equals_jax_general_path(config, bindings, clusters):
    """Configs 1 and 2 as bench.py builds them, config 4 with its 500
    clusters and 1,000 bindings, config 5 at 512 x 256 (padded * C > 2^16,
    so the estimate and divide tensor path runs, not the host-small one).
    The JAX engine is held on its host general path, the path ported."""
    (sj, pj), (st, pt) = both(config, bindings, clusters)
    jax_eng = JS.TensorScheduler(sj)
    jax_eng.fleet_threshold = len(pj) + 1  # keep it off the fleet table
    want = jax_eng.schedule(pj)
    port = TS.TensorScheduler(st, device="cpu")
    got = port.schedule(pt)
    assert outcome(got) == outcome(want)
    assert sum(r.success for r in got) > 0
    if config == 5:
        assert 512 * st.num_clusters > 1 << 16


def test_schedule_equals_jax_fleet_path():
    """The JAX engine's default route for config 5 is its device-resident
    fleet table; the port's general path gives the same placements."""
    (sj, pj), (st, pt) = both(5, 512, 256)
    want = JS.TensorScheduler(sj).schedule(pj)
    got = TS.TensorScheduler(st, device="cpu").schedule(pt)
    assert outcome(got) == outcome(want)


def test_schedule_matches_numpy_divider_oracle():
    """chip_smoke's per-row check (host pack -> numpy estimate -> host
    spread selection -> numpy divider) agrees with the engine's tensor path."""
    _, (st, pt) = both(4, 600, None)
    port = TS.TensorScheduler(st, device="cpu")
    assert chip_smoke.oracle_check(port, pt, port.schedule(pt)) == 0


def test_snapshot_from_arrays_round_trip():
    """The JAX snapshot's arrays rebuild a port snapshot without
    re-packing; the port's own packing of the same seeded fleet gives the
    same arrays; and the engine answers identically on either."""
    (sj, pj), (st, pt) = both(5, 300, 200)
    jax_arrays = TS.snapshot_arrays(sj)
    port_arrays = TS.snapshot_arrays(st)
    assert jax_arrays.keys() == port_arrays.keys()
    for name in jax_arrays:
        np.testing.assert_array_equal(port_arrays[name], jax_arrays[name], err_msg=name)
    rebuilt = TS.snapshot_from_arrays(jax_arrays, sj.names, sj.dims)
    for name, arr in TS.snapshot_arrays(rebuilt).items():
        np.testing.assert_array_equal(arr, jax_arrays[name], err_msg=name)
    assert rebuilt.mask_token == st.mask_token
    want = TS.TensorScheduler(st, device="cpu").schedule(pt)
    got = TS.TensorScheduler(rebuilt, device="cpu").schedule(pt)
    assert outcome(got) == outcome(want)


def test_snapshot_arrays_carry_the_model_pack():
    """Under the nine default grades the JAX snapshot's model pack crosses
    to the port bit for bit, the port packs the same seeded fleet to the
    same arrays, and the rebuilt snapshot schedules identically."""
    sj, _ = chip_smoke.build_workload(karmada_tpu, 5, 300, 200, models=True)
    st, pt = chip_smoke.build_workload(karmada_tpu_torch, 5, 300, 200, models=True)
    jax_arrays = TS.snapshot_arrays(sj)
    port_arrays = TS.snapshot_arrays(st)
    assert jax_arrays.keys() == port_arrays.keys()
    for name in jax_arrays:
        np.testing.assert_array_equal(port_arrays[name], jax_arrays[name], err_msg=name)
    assert jax_arrays["has_models"].all() and jax_arrays["model_min_bounds"].shape == (200, 9, 4)
    rebuilt = TS.snapshot_from_arrays(jax_arrays, sj.names, sj.dims)
    for name, arr in TS.snapshot_arrays(rebuilt).items():
        np.testing.assert_array_equal(arr, jax_arrays[name], err_msg=name)
    want = TS.TensorScheduler(st, device="cpu").schedule(pt)
    got = TS.TensorScheduler(rebuilt, device="cpu").schedule(pt)
    assert outcome(got) == outcome(want)


def test_update_snapshot_keeps_cluster_set():
    fleet = TB.synthetic_fleet(40, seed=1)
    eng = TS.TensorScheduler(TS.ClusterSnapshot(fleet), device="cpu")
    assert eng.update_snapshot(TS.ClusterSnapshot(TB.synthetic_fleet(40, seed=1)))
    assert not eng.update_snapshot(TS.ClusterSnapshot(TB.synthetic_fleet(41, seed=1)))


def _engine():
    snap = TS.ClusterSnapshot([TB.new_cluster(f"m{i}") for i in range(4)])
    return snap, TS.TensorScheduler(snap, device="cpu")


@pytest.mark.parametrize("branch", ["mesh"])
def test_unported_branches_raise(branch):
    """Where the JAX engine would take a branch the port does not carry (a
    device mesh), the port raises instead of answering differently. (The
    provenance and preemption planes are served: tests/test_torch_explain.py
    and tests/test_torch_preempt.py; remote estimators and the solver
    sidecar: tests/test_torch_estimator_wire.py and
    tests/test_torch_solver.py.)"""
    snap, eng = _engine()
    prob = TS.BindingProblem(key="b", placement=TB.dynamic_weight_placement(),
                             replicas=3, requests={"cpu": 100})
    with pytest.raises(NotImplementedError):
        TS.TensorScheduler(snap, mesh=object(), device="cpu")
    # the disarmed settings stay accepted
    eng.set_quota(None)
    eng.set_explain(None)
    eng.set_preemption(None)
    assert eng.schedule([prob])[0].success


@pytest.mark.parametrize("route", ["fleet", "general"])
def test_wide_snapshot_schedules_equal_to_jax(route):
    """16,385 clusters, one past the 16384 the card's division kernel once
    sorted in shared memory: 300 config-5 bindings through the fleet table
    (and through the general path), every result equal to the JAX
    engine's."""
    (sj, pj), (st, pt) = both(5, 300, 16_385)
    assert st.num_clusters == 16_385
    jax_eng = JS.TensorScheduler(sj)
    eng = TS.TensorScheduler(st, device="cpu")
    if route == "general":
        jax_eng.fleet_threshold = eng.fleet_threshold = len(pt) + 1
    want = jax_eng.schedule(pj)
    got = eng.schedule(pt)
    assert (eng._fleet is not None) == (route == "fleet")
    assert outcome(got) == outcome(want)
    assert sum(r.success for r in got) > len(pt) // 2


@pytest.mark.parametrize("route", ["fleet", "general"])
def test_wide_quota_wave_equals_jax(route):
    """A FederatedResourceQuota wave over 17 resource dims (one past the 16
    K12 holds in one tile): chip_smoke's ``wide_quota_scene`` in both
    packages, half the namespaces bound on the 17th dim. The admitted and
    denied rows, the placements and the debited ``remaining`` equal the
    JAX engine's, and the partition equals ``admit_wave_np``."""
    from karmada_tpu_torch.refimpl.quota_np import admit_wave_np
    from karmada_tpu_torch.scheduler.quota import QUOTA_EXCEEDED_ERROR

    sj, pj, qj = chip_smoke.wide_quota_scene(karmada_tpu, 800, 300)
    st, pt, qt = chip_smoke.wide_quota_scene(karmada_tpu_torch, 800, 300)
    assert len(qt.dims) == 17 and qt.dims == qj.dims
    np.testing.assert_array_equal(qt.remaining, qj.remaining)
    jax_eng = JS.TensorScheduler(sj)
    eng = TS.TensorScheduler(st, device="cpu")
    if route == "general":
        jax_eng.fleet_threshold = eng.fleet_threshold = len(pt) + 1
    jax_eng.set_quota(qj)
    eng.set_quota(qt)
    rem0 = qt.remaining.copy()
    want = jax_eng.schedule(pj)
    got = eng.schedule(pt)
    assert (eng._fleet is not None) == (route == "fleet")
    assert outcome(got) == outcome(want)
    np.testing.assert_array_equal(eng.quota.remaining, jax_eng.quota.remaining)
    denied = np.array([r.error == QUOTA_EXCEEDED_ERROR for r in got])
    ns_ids, demand = chip_smoke.wave_demand(st, pt, qt.ns_index)
    flags, _ = admit_wave_np(ns_ids, demand, rem0)
    np.testing.assert_array_equal(~denied, np.asarray(flags, bool))
    assert denied.any() and not denied.all()


def test_chip_smoke_wide_engines_rehearse_on_cpu(capsys):
    """chip_smoke's served-limits phase at a small size on the CPU: the
    fleet engine's rows against the numpy divider, the 17-dim quota wave
    against ``admit_wave_np`` and the 17-dim preemption wave against
    ``preempt_and_place_np``; each raises on any difference."""
    out = chip_smoke.check_wide_engines(torch.device("cpu"), "cpu", clusters=1200,
                                        bindings=400, quota_bindings=600, residents=400,
                                        preempt_clusters=80, surge=20)
    assert set(out) == {"wide fleet", "wide quota", "wide preemption"}
    assert out["wide preemption"]["dims"] == 17 and out["wide preemption"]["victims"] > 0
    printed = capsys.readouterr().out
    assert "400 ok / 0 bad" in printed and "K12 at 17 dims" in printed
    assert "K15 at 17 dims" in printed


def _modules(pkg_dir: pathlib.Path) -> list[str]:
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg_dir.rglob("*.py")
    )


def test_port_imports_without_jax_or_karmada_tpu():
    """Every module of the port imports with jax blocked and a finder that
    refuses karmada_tpu and karmada_tpu.*."""
    mods = _modules(ROOT / "karmada_tpu_torch")
    assert {"karmada_tpu_torch.ops.explain", "karmada_tpu_torch.ops.preempt",
            "karmada_tpu_torch.utils.explainstore", "karmada_tpu_torch.utils.tracing",
            "karmada_tpu_torch.refimpl.explain_np",
            "karmada_tpu_torch.refimpl.preempt_np",
            "karmada_tpu_torch.controllers.scheduler_controller",
            "karmada_tpu_torch.controllers.rebalance", "karmada_tpu_torch.utils.store",
            "karmada_tpu_torch.utils.worker", "karmada_tpu_torch.utils.metrics",
            "karmada_tpu_torch.controlplane", "karmada_tpu_torch.controllers.propagation",
            "karmada_tpu_torch.controllers.detector", "karmada_tpu_torch.interpreter.native",
            "karmada_tpu_torch.utils.member", "karmada_tpu_torch.webhook.chain",
            "karmada_tpu_torch.utils.faultinject", "karmada_tpu_torch.utils.register",
            "karmada_tpu_torch.controllers.cluster", "karmada_tpu_torch.controllers.failover",
            "karmada_tpu_torch.controllers.dependencies",
            "karmada_tpu_torch.controllers.extras", "karmada_tpu_torch.controllers.remedy",
            "karmada_tpu_torch.controllers.hpa_sync", "karmada_tpu_torch.utils.backoff",
            "karmada_tpu_torch.utils.net", "karmada_tpu_torch.localup",
            "karmada_tpu_torch.estimator.service",
            "karmada_tpu_torch.estimator.grpc_transport",
            "karmada_tpu_torch.estimator.fleet", "karmada_tpu_torch.estimator.__main__",
            "karmada_tpu_torch.estimator.proto.estimator_pb2",
            "karmada_tpu_torch.estimator.proto.estimator_batch_pb2",
            "karmada_tpu_torch.solver", "karmada_tpu_torch.solver.service",
            "karmada_tpu_torch.solver.client", "karmada_tpu_torch.solver.__main__",
            "karmada_tpu_torch.solver.proto.solver_pb2",
            "karmada_tpu_torch.api.autoscaling", "karmada_tpu_torch.api.networking",
            "karmada_tpu_torch.utils.cron",
            "karmada_tpu_torch.controllers.replica_calculator",
            "karmada_tpu_torch.controllers.autoscaling", "karmada_tpu_torch.controllers.mcs",
            "karmada_tpu_torch.controllers.mci", "karmada_tpu_torch.metricsadapter",
            "karmada_tpu_torch.metricsadapter.provider",
            "karmada_tpu_torch.interpreter.facade", "karmada_tpu_torch.interpreter.exprlang",
            "karmada_tpu_torch.interpreter.declarative",
            "karmada_tpu_torch.interpreter.thirdparty",
            "karmada_tpu_torch.interpreter.webhook", "karmada_tpu_torch.search",
            "karmada_tpu_torch.search.backend", "karmada_tpu_torch.search.registry",
            "karmada_tpu_torch.search.proxy", "karmada_tpu_torch.search.opensearch",
            "karmada_tpu_torch.search.proxyserver"} <= set(mods)
    code = f"""
import importlib, importlib.abc, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "karmada_tpu" or name.startswith("karmada_tpu."):
            raise ImportError("port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
for m in {mods!r}:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m == "karmada_tpu" or m.startswith("karmada_tpu.")]
assert not bad, bad
print(len({mods!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) > 20


#: the port's modules that chip_smoke.py imports: the card's machine has
#: neither grpc nor protobuf
NO_WIRE_MODULES = (
    "karmada_tpu_torch.estimator.service", "karmada_tpu_torch.estimator.accurate",
    "karmada_tpu_torch.estimator.grpc_transport", "karmada_tpu_torch.solver",
    "karmada_tpu_torch.solver.service", "karmada_tpu_torch.solver.client",
    "karmada_tpu_torch.solver.__main__", "karmada_tpu_torch.controllers.scheduler_controller",
    "karmada_tpu_torch.controlplane", "karmada_tpu_torch.utils.backoff",
    "karmada_tpu_torch.utils.faultinject", "karmada_tpu_torch.utils.tracing",
    "karmada_tpu_torch.metricsadapter", "karmada_tpu_torch.controllers.autoscaling",
    "karmada_tpu_torch.controllers.mcs", "karmada_tpu_torch.interpreter.webhook",
    "karmada_tpu_torch.interpreter.declarative", "karmada_tpu_torch.search",
)


def test_chip_smoke_imports_without_grpc_or_protobuf():
    """``chip_smoke`` and every module of the port it imports load with
    grpc blocked and a finder that refuses google.protobuf, and the
    in-process seams it drives (the solver core, the estimator service
    behind ``EstimatorConnection``, ``RemoteAccurateEstimator``, the
    controller's sidecar branch) run there: none of them imports the
    wire."""
    code = f"""
import importlib, importlib.abc, sys
sys.modules["grpc"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "google.protobuf" or name.startswith("google.protobuf."):
            raise ImportError("must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
for m in {NO_WIRE_MODULES!r}:
    importlib.import_module(m)
import chip_smoke
import karmada_tpu_torch.solver as sol
from karmada_tpu_torch.estimator import service as es
from karmada_tpu_torch.estimator.accurate import AccurateEstimator, NodeCache, NodeState
from karmada_tpu_torch.solver.__main__ import estimator_service
from karmada_tpu_torch.solver.service import encode_records, result_records
from karmada_tpu_torch.utils.builders import synthetic_fleet, dynamic_weight_placement
from karmada_tpu_torch.scheduler import BindingProblem, ClusterSnapshot
clusters = synthetic_fleet(6, seed=1)
snap = ClusterSnapshot(clusters)
conn = es.EstimatorConnection("multi", es.MultiClusterEstimatorService({{
    n: es.EstimatorService(AccurateEstimator(n, NodeCache(snap.dims, [NodeState(
        name="n0", allocatable={{"cpu": 64000, "memory": 1 << 36, "pods": 110}})]),
        device="cpu")) for n in snap.names}}))
svc, reg = estimator_service({{n: conn for n in snap.names}}, device="cpu")
assert isinstance(svc, sol.SolverService)
svc.sync_clusters(clusters, 1)
probs = [BindingProblem(key=f"b{{i}}", placement=dynamic_weight_placement(), replicas=3,
                        requests={{"cpu": 500}}) for i in range(5)]
jsons, recs = encode_records(probs)
res = result_records(svc.solve(1, jsons, recs))
assert all(sum(n for _, n in r.clusters) == 3 for r in res), res
assert reg.rpc_counts == {{"batch": 1, "unary": 0, "ping": 0}}, reg.rpc_counts
bad = [m for m in sys.modules if (m == "grpc" and sys.modules[m] is not None)
       or m.startswith("google.protobuf")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_no_jax_or_karmada_tpu_imports_in_source():
    files = sorted((ROOT / "karmada_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "karmada_tpu"), f"{path}: {name}"


@pytest.mark.parametrize("script", ("k2_variants.py", "k12_k15_variants.py",
                                    "k8_k14_variants.py", "k1_k13_variants.py",
                                    "k6_k7_variants.py", "kernel_variants.py",
                                    "launch_floors.py", "plane_waves.py"))
def test_timing_scripts_import_without_jax_or_karmada_tpu(script):
    """The card's timing scripts import neither jax nor the JAX package: in
    their source, and when imported with jax blocked and a finder that
    refuses karmada_tpu."""
    path = ROOT / script
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "karmada_tpu"), name
    code = f"""
import importlib, importlib.abc, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "karmada_tpu" or name.startswith("karmada_tpu."):
            raise ImportError("must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
importlib.import_module({path.stem!r})
assert not [m for m in sys.modules if m == "karmada_tpu" or m.startswith("karmada_tpu.")]
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_launch_floor_builds_are_named_by_their_sources(tmp_path, monkeypatch):
    """A launch floor's build is named by a hash of its source text and of
    the shared headers: the same sources name the same build, which a
    second run loads without a compiler (``start`` finds nothing to build),
    and an edited header names another. The smoke imports the floors, not
    the timing harness."""
    import shutil

    import launch_floors
    from karmada_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    d = tmp_path / "csrc"
    shutil.copytree(launch_floors.CSRC, d)
    names = {n: launch_floors._paths(n, str(d))[2] for n in launch_floors.PORT_FLOORS}
    assert names == {n: launch_floors._paths(n, launch_floors.CSRC)[2]
                     for n in launch_floors.PORT_FLOORS}
    assert len(set(names.values())) == len(names)
    for n, so in names.items():
        assert pathlib.Path(so).parent == tmp_path / "build"
        text = launch_floors._paths(n, str(d))[0]
        assert text.count("launch_floor_launch") == 1
        assert text.startswith((d / f"{n}.cu").read_text())
    (tmp_path / "build").mkdir()
    for so in names.values():
        pathlib.Path(so).touch()
    monkeypatch.setattr(native, "nvcc", lambda: pytest.fail("a built floor was built again"))
    started = launch_floors.start(d=str(d))
    assert started["procs"] == {} and launch_floors.finish(started) == {}
    (d / "divmagic.cuh").write_text((d / "divmagic.cuh").read_text() + "\n// edited\n")
    for n, so in names.items():
        assert launch_floors._paths(n, str(d))[2] != so
    smoke = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {a.name for node in ast.walk(smoke) if isinstance(node, ast.Import)
                for a in node.names}
    assert "launch_floors" in imported and "kernel_variants" not in imported


def test_chip_smoke_refuses_without_cuda():
    """No card: the smoke exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_referent_processes_equal_one_process():
    """``chip_smoke.referent_mismatches`` on forked workers (as ``main``
    runs it: the pieces solved by ``REFERENT_PROCESSES`` processes) counts
    what it counts in this process: no row off a pass of the engine, and
    exactly the rows a result or a written tuple was changed in. Run in a
    fresh interpreter, which has no JAX threads to fork."""
    code = """
import torch, chip_smoke as cs
import karmada_tpu_torch
from karmada_tpu_torch.scheduler import TensorScheduler
from karmada_tpu_torch.scheduler.core import ScheduleResult
snap, problems = cs.build_workload(karmada_tpu_torch, 5, 1200, 60, False)
engine = TensorScheduler(snap, chunk_size=256, device=torch.device("cpu"))
res = list(engine.schedule(problems))
bent = [res[i] if i % 97 else ScheduleResult(res[i].key, dict(res[i].clusters, zz=1),
                                            res[i].feasible, error=res[i].error)
        for i in range(len(res))]
cs.REFERENT_PIECE = 100
counts = []
for procs in (1, 3):
    cs.REFERENT_PROCESSES = procs
    counts.append((cs.oracle_check(engine, problems, res),
                   cs.oracle_check(engine, problems, bent),
                   cs.referent_mismatches(engine, problems[:500], [
                       cs.expected_row(p, r) for p, r in zip(problems[:500], bent)],
                       cs.expected_row)))
print(counts)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    bent = len(range(0, 1200, 97))
    assert out.stdout.strip() == str([(0, bent, len(range(0, 500, 97)))] * 2)
