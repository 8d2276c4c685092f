"""The port's store checkpoint and the plane's resume against the JAX package
on the CPU.

A checkpoint pickles the objects of the package that wrote it, so each
package resumes its own: ``tests/test_store.py::TestCheckpointResume`` on
both stores and both planes, where a new plane restores the checkpoint and
settles; the resumed planes' states (bindings, Works, member objects,
templates, the autoscalers) must equal each other through ``run_both``
(``tests/test_torch_controlplane.py``), and each resumed plane's placements
the ones its package checkpointed. ``tests/test_concurrency_torture.py``'s
checkpoint case runs on the port's store: a checkpoint taken while writers
run deserializes into a coherent store. ``chip_smoke.run_plane``'s resume
wave runs on config 4 at 300 templates x 40 clusters on both planes, its
dry-solve first pass included. Tolerance: exact equality."""

import calendar
import os
import sys
import threading

import pytest

import chip_smoke
from test_torch_autoscaling import CONFIG4_TEMPLATES, config4_plane, replicas
from test_torch_controlplane import (  # noqa: F401 (fixture)
    PKGS,
    _one_torch_thread,
    mod,
    run_both,
)


def _configmap(pkg, key, **spec):
    core = mod(pkg, "api.core")
    ns, _, name = key.rpartition("/")
    return core.Resource(api_version="v1", kind="ConfigMap",
                         meta=core.ObjectMeta(name=name, namespace=ns), spec=spec)


def test_round_trip_preserves_objects(tmp_path):
    """Each package's store: checkpoint one object, restore it into a fresh
    store, which replays it as Added; the same count and events on both."""
    got = []
    for pkg in PKGS:
        store_mod = mod(pkg, "utils.store")
        s = store_mod.Store()
        s.apply(_configmap(pkg, "ns/a", data={"k": "v"}))
        path = str(tmp_path / f"{pkg.__name__}.bin")
        n = s.checkpoint(path)
        s2 = store_mod.Store()
        seen = []
        s2.watch("Resource", lambda e: seen.append((e.type, e.key)), replay=False)
        got.append((n, s2.restore(path), seen, s2.get("Resource", "ns/a").spec,
                    type(s2.get("Resource", "ns/a")).__module__.split(".")[0],
                    os.path.exists(f"{path}.tmp")))
    assert got[0][:4] == got[1][:4] == (1, 1, [("Added", "ns/a")], {"data": {"k": "v"}})
    assert [g[4] for g in got] == [pkg.__name__ for pkg in PKGS]
    assert not any(g[5] for g in got)


def _resume(tmp_path, order, autoscalers):
    """``TestCheckpointResume``'s plane: two members, a dynamic-weight
    Deployment of 6; with ``autoscalers``, a FederatedHPA whose samples sit
    at its target and a CronFederatedHPA that fired at 09:00. The plane is
    checkpointed and a new plane on the same clock restores it: ``order``
    "join-restore" joins new members first (the JAX test's
    ``cmd_local_up``), "restore-join" restores first and joins the same
    member states (``localup.py``'s order), with the old plane's member
    watches dropped."""

    def scenario(p, record):
        p.clock.now = float(calendar.timegm((2026, 1, 1, 8, 59, 30, 0, 0, 0)))
        a = mod(p.pkg, "api.autoscaling")
        cp = p.make_plane(2)
        cp.store.apply(p.b.new_deployment("web", replicas=6))
        cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
        if autoscalers:
            cp.store.apply(p.b.new_deployment("batch", replicas=3))
        cp.settle()
        if autoscalers:
            rb = cp.store.get("ResourceBinding", "default/web-deployment")
            for tc in rb.spec.clusters:
                cp.members.get(tc.name).pod_metrics["default/web"] = {
                    "pods": tc.replicas, "ready_pods": tc.replicas, "cpu_utilization": 50.0}
            cp.store.apply(a.FederatedHPA(
                meta=p.core.ObjectMeta(name="web-hpa", namespace="default"),
                spec=a.FederatedHPASpec(
                    scale_target_ref=a.ScaleTargetRef(kind="Deployment", name="web"),
                    max_replicas=20, metrics=[a.MetricSpec(target_average_utilization=50)])))
            cp.store.apply(a.CronFederatedHPA(
                meta=p.core.ObjectMeta(name="morning", namespace="default"),
                spec=a.CronFederatedHPASpec(
                    scale_target_ref=a.ScaleTargetRef(kind="Deployment", name="batch"),
                    rules=[a.CronFederatedHPARule(name="up", schedule="0 9 * * *",
                                                  target_replicas=5)])))
            cp.settle()
            p.clock.now += 60
            cp.settle()
        record(cp)
        before = {rb.meta.namespaced_name: [(tc.name, tc.replicas) for tc in rb.spec.clusters]
                  for rb in cp.store.list("ResourceBinding")}
        path = str(tmp_path / f"{p.pkg.__name__}-plane.bin")
        written = cp.store.checkpoint(path)
        p.clock.now += 30
        cp2 = p.plane()
        members = [cp.members.get(n) for n in sorted(cp.members.names())]
        if order == "join-restore":
            for i in (1, 2):
                cp2.join_cluster(p.b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
            assert cp2.store.restore(path) == written
        else:
            for m in members:
                m._watchers.clear()
            assert cp2.store.restore(path) == written
            for m in members:
                cp2.join_cluster(cp2.store.get("Cluster", m.name), m)
        cp2.settle()
        record(cp2)
        after = {rb.meta.namespaced_name: [(tc.name, tc.replicas) for tc in rb.spec.clusters]
                 for rb in cp2.store.list("ResourceBinding")}
        assert after == before
        assert cp2.members.get("member1").get("apps/v1/Deployment", "default", "web") is not None
        if autoscalers:
            assert cp2.store.get("Resource", "default/batch").spec["replicas"] == 5
            cron = cp2.store.get("CronFederatedHPA", "default/morning")
            assert [h.applied_replicas for h in cron.status.execution_histories] == [5]
            assert cp2.store.get("Resource", "default/web").spec["replicas"] == 6

    return scenario


@pytest.mark.parametrize("order,autoscalers", [("join-restore", False), ("restore-join", False),
                                               ("restore-join", True)])
def test_control_plane_resume_equals_jax(order, autoscalers, tmp_path, monkeypatch):
    """Each package resumes its own checkpoint into a new plane: the
    resumed planes equal each other, and each keeps its placements."""
    run_both(_resume(tmp_path, order, autoscalers), monkeypatch)


def test_checkpoint_under_concurrent_writers_is_coherent(tmp_path):
    """The port's ``Store.checkpoint`` taken mid-storm deserializes into a
    store whose objects are internally consistent."""
    store_mod = mod(PKGS[1], "utils.store")
    store = store_mod.Store()
    stop = threading.Event()

    def writer(seed):
        i = 0
        while not stop.is_set():
            store.apply(_configmap(PKGS[1], f"ns/k{(seed * 7 + i) % 8}", payload=i))
            i += 1

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for round_i in range(25):
            path = str(tmp_path / f"snap{round_i}.pkl")
            store.checkpoint(path)
            restored = store_mod.Store()
            n = restored.restore(path)
            assert n == len(restored.list("Resource"))
            for obj in restored.list("Resource"):
                assert obj.meta.resource_version > 0
                assert "payload" in obj.spec
    finally:
        stop.set()
        for th in threads:
            th.join()
        sys.setswitchinterval(old)


def config4_resume_wave(tmp_path, rounds: list):
    """``chip_smoke.plane_autoscale_waves``' resume waves on config 4 at 300
    x 40 with FederatedHPAs at their target: ``chip_smoke.resume_plane``
    into a plane with the drift rebalancer (the old plane's member watches
    dropped, restore, then the same members joined), the settle, then the
    resumed plane's first drift round, which dry-solves every binding on
    the resumed scheduler's new engine, and the settle after it. The
    resumed planes equal each other; each keeps every placement and member
    object spec through the resume; each round's stats go to ``rounds``."""

    def scenario(p, record):
        cp = config4_plane(p)
        up, _, _ = chip_smoke.autoscale_picks(CONFIG4_TEMPLATES, set(), (10, 0, 0), 0, 0)
        rep0 = {i: (i % 40) + 1 for i in up}
        chip_smoke.set_samples(cp, {i: chip_smoke.HPA_TARGET for i in up})
        for hpa in chip_smoke.hpa_objects(p.pkg, sorted(up), rep0, window=300):
            cp.store.apply(hpa)
        cp.settle()
        record(cp)
        before = [chip_smoke.written(rb) for rb in chip_smoke.sorted_bindings(cp.store)]
        objs = {k: spec for k, (_, spec) in chip_smoke.member_state(cp).items()}
        p.clock.now += 60
        cp2, written, restored, _ = chip_smoke.resume_plane(
            p.pkg, cp, str(tmp_path / f"{p.pkg.__name__}.ckpt"), clock=p.clock,
            enable_drift_rebalancer=True, **({"device": "cpu"} if p.torch else {}))
        assert written == restored
        cp2.drift_rebalancer.active = False
        cp2.settle()
        record(cp2)
        rbs = chip_smoke.sorted_bindings(cp2.store)
        assert [chip_smoke.written(rb) for rb in rbs] == before
        assert {k: spec for k, (_, spec) in chip_smoke.member_state(cp2).items()} == objs
        assert all(replicas(cp2, f"d{i}") == r for i, r in rep0.items())
        stats = cp2.drift_rebalancer.rebalance_once()
        assert stats["scored"] == len(rbs)
        rounds.append(stats)
        cp2.settle()
        record(cp2)

    return scenario


def test_config4_resume_wave_equals_jax_plane(tmp_path, monkeypatch):
    rounds = []
    run_both(config4_resume_wave(tmp_path, rounds), monkeypatch)
    assert len(rounds) == 2 and rounds[0] == rounds[1]
