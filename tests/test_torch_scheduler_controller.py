"""The port's scheduler process (``Store``, ``Runtime``,
``SchedulerController`` and the ``ContinuousDescheduler`` scoring through
it) against the JAX package's, on the CPU. Each case drives both packages'
planes on the same objects (``chip_smoke.binding_objects`` from one seeded
recipe) with one injected clock, and compares every binding's
``spec.clusters``, graceful-eviction tasks, ``scheduler_observed_generation``
and ``scheduler_observed_affinity_name``, ``last_scheduled_time`` and its
``Scheduled`` and ``Preempted`` conditions (status, reason, message).
Metric families are process-global in each package, so counters are
compared by their increments. Tolerance: exact equality. Also a CPU
rehearsal of chip_smoke's ``run_controller`` phase."""

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.controllers.rebalance  # noqa: F401
import karmada_tpu.controllers.scheduler_controller  # noqa: F401
import karmada_tpu.utils.builders  # noqa: F401  (chip_smoke builds by name)

import karmada_tpu_torch
import karmada_tpu_torch.controllers.rebalance  # noqa: F401

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)
NAMESPACES = ("team-a", "team-b", "team-c", "team-d")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def mod(pkg, name):
    return __import__(f"{pkg.__name__}.{name}", fromlist=["x"])


class Clock:
    """One injected clock for both packages' planes."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def recipe(pkg, clusters: int = 40, bindings: int = 300, seed: int = 5):
    """(snapshot, problems): ``synthetic_fleet`` and three row families in
    four namespaces: chip_smoke's mixed rows (the four strategies,
    zero-replica, previous-site and fresh rows), config 4's spread rows,
    and rows with three ordered ClusterAffinities terms (every third one
    too large for its first group)."""
    api = mod(pkg, "api")
    b = mod(pkg, "utils.builders")
    q = mod(pkg, "utils.quantity")
    s = mod(pkg, "scheduler")
    fleet = b.synthetic_fleet(clusters, seed=3)
    snap = s.ClusterSnapshot(fleet)
    n_mixed, n_spread = bindings * 2 // 3, bindings // 6
    problems = chip_smoke.mixed_problems(pkg, fleet, n_mixed, seed)
    rng = np.random.default_rng(seed + 1)
    req = q.parse_resource_list({"cpu": "250m", "memory": "512Mi"})
    spread = b.dynamic_weight_placement(spread_constraints=[
        api.SpreadConstraint(spread_by_field="region", min_groups=2, max_groups=4),
        api.SpreadConstraint(spread_by_field="cluster", min_groups=2, max_groups=10)])
    for i in range(n_spread):
        problems.append(s.BindingProblem(
            key=f"s{i}", placement=spread, replicas=int(rng.integers(1, 40)), requests=req,
            gvk="apps/v1/Deployment"))
    groups = (("t0", "t1", "t2"), tuple(f"t{k}" for k in range(3, 9)),
              tuple(f"t{k}" for k in range(9, 16)))
    terms = [api.ClusterAffinityTerm(
        affinity_name=f"group-{k}", label_selector=api.LabelSelector(match_expressions=[
            api.LabelSelectorRequirement(key="tier", operator="In", values=list(g))]))
        for k, g in enumerate(groups)]
    ranked = (b.dynamic_weight_placement(cluster_affinities=list(terms)),
              b.aggregated_placement(cluster_affinities=list(terms)))
    big = q.parse_resource_list({"cpu": "64", "memory": "1Gi"})
    for i in range(bindings - n_mixed - n_spread):
        problems.append(s.BindingProblem(
            key=f"r{i}", placement=ranked[i % 2], replicas=int(rng.integers(1, 30)),
            requests=big if i % 3 == 0 else req, gvk="apps/v1/Deployment",
            fresh=bool(rng.random() < 0.1)))
    for i, p in enumerate(problems):
        p.namespace = NAMESPACES[i % len(NAMESPACES)]
        p.key = f"{p.namespace}/{p.key}"
    return snap, problems


class Plane:
    """One package's scheduler process over its own copy of a recipe."""

    def __init__(self, pkg, clock, snap, problems, limits=None, **ctl_kw):
        self.pkg = pkg
        u = mod(pkg, "utils")
        self.store, self.rt = u.Store(), u.Runtime()
        kw = {} if pkg is karmada_tpu else {"device": "cpu"}
        self.ctl = mod(pkg, "controllers.scheduler_controller").SchedulerController(
            self.store, self.rt, clock=clock, **kw, **ctl_kw)
        self.desched = mod(pkg, "controllers.rebalance").ContinuousDescheduler(
            self.store, self.rt, self.ctl, clock=clock)
        self.desched.active = False  # rounds run by hand
        self.snap, self.problems = snap, problems
        self.clusters, self.rbs, self.frqs = chip_smoke.binding_objects(
            pkg, snap, problems, limits)
        self.store.apply_many(self.clusters)
        self.store.apply_many(self.frqs)

    def rb(self, key):
        return self.store.get("ResourceBinding", key)

    def view(self) -> list:
        out = []
        for rb in sorted(self.store.list("ResourceBinding"),
                         key=lambda r: r.meta.namespaced_name):
            out.append((
                rb.meta.namespaced_name, rb.meta.generation,
                [(tc.name, tc.replicas) for tc in rb.spec.clusters],
                [(t.from_cluster, t.replicas, t.reason, t.producer, t.message,
                  t.creation_timestamp) for t in rb.spec.graceful_eviction_tasks],
                rb.status.scheduler_observed_generation,
                rb.status.scheduler_observed_affinity_name,
                rb.status.last_scheduled_time,
                [(c.type, c.status, c.reason, c.message) for c in rb.status.conditions
                 if c.type in ("Scheduled", "Preempted")],
            ))
        return out


class Pair:
    """The same recipe in both packages, driven in turn."""

    def __init__(self, recipe_fn=recipe, limits=None, **ctl_kw):
        self.clock = Clock()
        self.planes = []
        for pkg in PKGS:
            snap, problems = recipe_fn(pkg)
            self.planes.append(Plane(pkg, self.clock, snap, problems, limits, **ctl_kw))
        self.jax, self.port = self.planes

    def each(self, fn) -> list:
        return [fn(pl) for pl in self.planes]

    def settle(self) -> list:
        self.clock.now += 1.0
        steps = self.each(lambda pl: pl.rt.run_until_settled())
        self.same()
        return steps

    def same(self) -> list:
        a, b = self.jax.view(), self.port.view()
        assert len(a) == len(b)
        bad = [(x, y) for x, y in zip(a, b) if x != y]
        assert not bad, bad[:3]
        return b

    def cold(self) -> list:
        self.each(lambda pl: pl.store.apply_many(pl.rbs))
        return self.settle()


def engine_passes(pkg) -> tuple[int, float]:
    """(engine passes, bindings attempted) so far in ``pkg``'s process:
    ``scheduler_pass_seconds`` observes once per engine pass,
    ``schedule_attempts`` counts every binding of a pass."""
    m = mod(pkg, "utils.metrics")
    summary = m.scheduler_pass_seconds.summary()
    return (summary["count"] if summary else 0,
            sum(m.schedule_attempts.samples().values()))


def passes_since(before) -> list:
    return [tuple(a - b for a, b in zip(engine_passes(pkg), was))
            for pkg, was in zip(PKGS, before)]


def test_cold_wave_round_trips_then_settles_idle():
    pair = Pair()
    pair.cold()
    for pl in pair.planes:
        # every binding's problem equals its recipe row, fresh flags included
        assert all(pl.ctl._problem_cache[p.key] == p for p in pl.problems)
        assert pl.rt.pending() == 0  # the write-back's echoes enqueued nothing
    views = pair.same()
    assert sum(1 for v in views if v[7] and v[7][0][1]) > 200
    assert any(v[5] for v in views)  # some ranked rows name their group
    before = [engine_passes(pkg) for pkg in PKGS]
    assert pair.settle() == [0, 0] and passes_since(before) == [(0, 0), (0, 0)]
    # a resync of every binding: Duplicated and zero-replica rows reschedule,
    # the write-back is change-detected
    for pl in pair.planes:
        for rb in pl.rbs:
            pl.ctl.worker.enqueue(("ResourceBinding", rb.meta.namespaced_name))
    pair.settle()
    moved = passes_since(before)
    assert moved[0] == moved[1] and moved[1][0] == 1 and moved[1][1] > 0


def dirty_wave(pair, mutate) -> set:
    """One wave in both planes: ``mutate(plane)`` answers the bindings to
    apply (or enqueues keys itself). The dirty-row set the wave hands the
    engine must be exactly the keys whose cached problem was replaced (its
    content moved); every other key keeps its one problem object."""
    recs = []
    for pl in pair.planes:
        old = dict(pl.ctl._problem_cache)
        changed = mutate(pl)
        probe = set()
        pl.ctl._dirty_problem_keys = probe  # the set the wave hands the engine
        pl.store.apply_many(changed)
        recs.append((pl, old, probe))
    pair.settle()
    probes = []
    for pl, old, probe in recs:
        cache = pl.ctl._problem_cache
        replaced = {k for k, p in cache.items() if p is not old.get(k)}
        assert probe == replaced
        assert all(cache[k] != old[k] for k in replaced if k in old)
        probes.append(probe)
    assert probes[0] == probes[1]
    return probes[1]


def test_steady_problems_keep_identity_and_scale_waves_mark_dirty():
    pair = Pair()
    pair.cold()

    def resync(pl):
        for rb in pl.rbs:
            pl.ctl.worker.enqueue(("ResourceBinding", rb.meta.namespaced_name))
        return []

    before = [engine_passes(pkg) for pkg in PKGS]
    dirty_wave(pair, resync)  # rows whose placement the cold wave moved
    # the same again: every rebuilt problem equals its cached one
    assert dirty_wave(pair, resync) == set()
    moved = passes_since(before)
    assert moved[0] == moved[1] and moved[1][0] == 2
    idx = np.random.default_rng(7).choice(len(pair.port.rbs), 60, replace=False)
    moved = set()

    def scale(pl):
        out = []
        for n, i in enumerate(idx):
            rb = pl.rbs[i]
            rb.spec.replicas = rb.spec.replicas + 5 if n % 2 else max(rb.spec.replicas - 3, 0)
            rb.meta.generation += 1
            out.append(rb)
            moved.add(rb.meta.namespaced_name)
        return out

    before = [engine_passes(pkg) for pkg in PKGS]
    dirty = dirty_wave(pair, scale)
    assert dirty <= moved and len(dirty) > 40
    assert passes_since(before) == [(1, 60), (1, 60)]


def test_scheduler_name_filter():
    pair = Pair(lambda pkg: recipe(pkg, bindings=120))
    for pl in pair.planes:
        for i, rb in enumerate(pl.rbs):
            if i % 3 == 0:
                rb.spec.scheduler_name = "other-scheduler"
    pair.cold()
    for pl in pair.planes:
        for i, rb in enumerate(pl.rbs):
            assert (rb.status.conditions == []) == (i % 3 == 0)
    # a cluster event re-enqueues only this scheduler's bindings
    pair.each(lambda pl: pl.store.apply(pl.clusters[0]))
    assert len(pair.jax.ctl.worker) == len(pair.port.ctl.worker) == 80


def test_cluster_heartbeat_join_and_leave():
    pair = Pair()
    pair.cold()
    engines = pair.each(lambda pl: pl.ctl._engine)
    # a status heartbeat over the same cluster set: the snapshot is swapped
    # into the same engine
    for pl in pair.planes:
        chip_smoke.drift_snapshots(pl.pkg, pl.ctl._snapshot, 1, seed=3)
        pl.store.apply(pl.clusters[1])
    pair.settle()
    assert pair.each(lambda pl: pl.ctl._engine) == engines
    # a join rebuilds the engine
    for pl in pair.planes:
        b = mod(pl.pkg, "utils.builders")
        pl.store.apply(b.new_cluster("member-new", cpu="4096", memory="16384Gi", pods=50_000,
                                     labels={"tier": "t0", "env": "prod"}, region="region-0",
                                     zone="region-0-z0", provider="aws"))
    pair.settle()
    rebuilt = pair.each(lambda pl: pl.ctl._engine)
    assert all(a is not b for a, b in zip(engines, rebuilt))
    assert any("member-new" in dict(v[2]) for v in pair.same())
    # a leave rebuilds it again; bindings there reschedule with it as prev
    pair.each(lambda pl: pl.store.delete("Cluster", "member-new"))
    pair.settle()
    assert all(a is not b for a, b in zip(rebuilt, pair.each(lambda pl: pl.ctl._engine)))


def metric_values(pkg, fam):
    return dict(getattr(mod(pkg, "utils.metrics"), fam).samples())


def increments(pkg, fam, before) -> dict:
    after = metric_values(pkg, fam)
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def test_quota_denials_and_a_raise_reenqueue_only_that_namespace():
    limits = {ns: {"cpu": 60_000} for ns in NAMESPACES}
    pair = Pair(limits=limits)
    fams = ("unschedulable_total", "quota_denied")
    before = {(pkg, f): metric_values(pkg, f) for pkg in PKGS for f in fams}
    pair.cold()
    views = pair.same()
    denied = {v[0] for v in views if v[7] and v[7][0][2] == "QuotaExceeded"}
    assert len(denied) > 20
    inc = {(pkg, f): increments(pkg, f, before[(pkg, f)]) for pkg in PKGS for f in fams}
    for f in fams:
        assert inc[(karmada_tpu, f)] == inc[(karmada_tpu_torch, f)]
    assert sum(inc[(karmada_tpu_torch, "quota_denied")].values()) == len(denied)
    # a resync inside one quota generation: the denied stay parked, nothing
    # counts twice
    mid = {(pkg, f): metric_values(pkg, f) for pkg in PKGS for f in fams}
    for pl in pair.planes:
        for rb in pl.rbs:
            pl.ctl.worker.enqueue(("ResourceBinding", rb.meta.namespaced_name))
    pair.settle()
    for pkg in PKGS:
        assert increments(pkg, "quota_denied", mid[(pkg, "quota_denied")]) == {}
    # raise team-b: exactly its denied bindings are re-enqueued
    raised = "team-b"
    for pl in pair.planes:
        frq = pl.store.get("FederatedResourceQuota", f"{raised}/quota")
        frq.spec.overall = {"cpu": 1 << 40}
        pl.store.apply(frq)
        assert {k for _, k in pl.ctl.worker._queued} == {
            k for k in denied if k.startswith(raised + "/")}
    pair.settle()
    views = pair.same()
    assert not any(v[0].startswith(raised + "/") and v[7][0][2] == "QuotaExceeded"
                   for v in views)
    assert any(v[7] and v[7][0][2] == "QuotaExceeded" for v in views)


@pytest.mark.parametrize("armed", ["1", "0"])
def test_preemption_wave(monkeypatch, armed):
    monkeypatch.setenv("KARMADA_TPU_PREEMPTION", armed)
    scenes = {}

    def scene(pkg):
        snap, low, hi, req = chip_smoke.preemption_scene(160, 32, 12, pkg=pkg)
        scenes[pkg] = (snap, low, hi, req)
        return snap, low

    pair = Pair(scene)
    pair.cold()
    for pl in pair.planes:
        snap, low, hi, req = scenes[pl.pkg]
        placements = [{tc.name: tc.replicas for tc in rb.spec.clusters} for rb in pl.rbs]
        for cl, sat in zip(snap.clusters, chip_smoke.saturated_clusters(
                snap.clusters, placements, req, pkg=pl.pkg)):
            cl.status = sat.status
        pl.store.apply(snap.clusters[0])
    pair.settle()
    before = {pkg: metric_values(pkg, "preemptions_total") for pkg in PKGS}
    for pl in pair.planes:
        _, hi_rbs, _ = chip_smoke.binding_objects(pl.pkg, scenes[pl.pkg][0], scenes[pl.pkg][2])
        pl.store.apply_many(hi_rbs)
    pair.settle()
    views = pair.same()
    preempted = [v for v in views if any(c[0] == "Preempted" for c in v[7])]
    hi_placed = [v for v in views if "/hi" in v[0] and v[2]]
    if armed == "1":
        assert preempted and hi_placed
        assert all(t[2] == "PreemptedByHigherPriority" for v in preempted for t in v[3])
    else:
        assert not preempted and not hi_placed
    incs = [increments(pkg, "preemptions_total", before[pkg]) for pkg in PKGS]
    assert incs[0] == incs[1] and sum(incs[1].values()) == len(preempted)


def test_dry_solve_leaves_quota_and_explain_untouched():
    limits = {ns: {"cpu": 1 << 30} for ns in NAMESPACES}
    pair = Pair(limits=limits)
    pair.cold()
    results = []
    for pl in pair.planes:
        engine = pl.ctl._inproc_engine()
        estore = mod(pl.pkg, "utils.explainstore").ExplainStore(cap=8)
        engine.set_explain(estore)
        pl.ctl._ensure_engine_quota(engine)
        before = engine.quota.remaining.copy()
        rbs = pl.rbs[:40]
        for rb in rbs:
            rb.spec.replicas += 3  # pending scale-ups: a leaky dry solve would debit
        problems = [pl.ctl._problem_for(rb.meta.namespaced_name, rb, True) for rb in rbs]
        res = pl.ctl.dry_solve(problems)
        assert np.array_equal(engine.quota.remaining, before)
        assert engine.explain is estore and not estore.captures()
        results.append([(r.key, dict(r.clusters), r.error, r.affinity_name) for r in res])
    assert results[0] == results[1]


def drift_recipe(pkg):
    """Dynamic-weight and Aggregated rows only (``rebalance_np`` divides
    without static weights or spread selection)."""
    b = mod(pkg, "utils.builders")
    q = mod(pkg, "utils.quantity")
    s = mod(pkg, "scheduler")
    fleet = b.synthetic_fleet(40, seed=9)
    snap = s.ClusterSnapshot(fleet)
    rng = np.random.default_rng(13)
    pls = (b.dynamic_weight_placement(), b.aggregated_placement())
    problems = []
    for i in range(240):
        ns = NAMESPACES[i % 4]
        problems.append(s.BindingProblem(
            key=f"{ns}/d{i}", placement=pls[int(i % 5 == 4)],
            replicas=int(rng.integers(1, 60)),
            requests=q.parse_resource_list({"cpu": f"{250 * (1 + i % 4)}m",
                                            "memory": "512Mi"}),
            gvk="apps/v1/Deployment", namespace=ns))
    return snap, problems


@pytest.mark.parametrize("budget", ["0", "2", ""])
def test_descheduler_round_equals_jax_and_rebalance_np(monkeypatch, budget):
    from karmada_tpu_torch.refimpl.preempt_np import rebalance_np

    if budget:
        monkeypatch.setenv("KARMADA_TPU_DESCHEDULE_MAX_DISRUPTION", budget)
    else:
        monkeypatch.delenv("KARMADA_TPU_DESCHEDULE_MAX_DISRUPTION", raising=False)
    pair = Pair(drift_recipe)
    pair.cold()
    for pl in pair.planes:
        chip_smoke.drift_snapshots(pl.pkg, pl.ctl._snapshot, 2, seed=17)
        pl.store.apply(pl.clusters[0])
    pair.settle()
    before = {pkg: metric_values(pkg, "preemptions_total") for pkg in PKGS}
    cands = pair.port.desched._candidates()
    current = {rb.meta.namespaced_name: {tc.name: tc.replicas for tc in rb.spec.clusters}
               for _, rb, _ in cands}
    pair.clock.now += 1.0
    stats = pair.each(lambda pl: pl.desched.rebalance_once())
    assert stats[0] == stats[1]
    if budget == "0":
        assert stats[1] is None
        return
    n = int(budget or 64)
    trig = stats[1]["triggered"]
    assert len(trig) == min(n, stats[1]["drifted"]) and trig
    engine = pair.port.ctl._engine
    problems = [p for _, _, p in cands]
    assert chip_smoke.drift_referent(engine, problems, current, n) == trig
    # the referent's chunked preselection equals one rebalance_np over all rows
    saved = engine.chunk_size
    engine.chunk_size = 32
    try:
        assert chip_smoke.drift_referent(engine, problems, current, n) == trig
    finally:
        engine.chunk_size = saved
    rows = {}
    for start in range(0, len(problems), engine.chunk_size):
        chunk = problems[start:start + engine.chunk_size]
        compiled = [engine._compiled(p.placement) for p in chunk]
        feasible, strategy, replicas, _, requests, _, _ = engine._pack_chunk(chunk, compiled, 0)
        avail = engine._availability_np(requests, replicas)
        for i, p in enumerate(chunk):
            rows[p.key] = (feasible[i], int(strategy[i]), int(replicas[i]), avail[i])
    keys = [p.key for p in problems]
    assert rebalance_np(keys, names=engine.snapshot.names, current=current,
                        candidates={k: v[0] for k, v in rows.items()},
                        strategies={k: v[1] for k, v in rows.items()},
                        replicas={k: v[2] for k, v in rows.items()},
                        avail={k: v[3] for k, v in rows.items()}, budget=n)[1] == trig
    incs = [increments(pkg, "preemptions_total", before[pkg]) for pkg in PKGS]
    assert incs[0] == incs[1] == {(("reason", "RebalanceTriggered"),): float(len(trig))}
    pair.settle()
    for key in trig:
        rb = pair.port.rb(key)
        assert rb.status.last_scheduled_time >= rb.spec.reschedule_triggered_at


def store_trace(pkg) -> list:
    """A fixed script against one package's Store and Worker: the events
    a watcher sees, replay, a ConflictError, a double delete, a batched
    drain and a poisoned key's bisection."""
    u = mod(pkg, "utils")
    api = mod(pkg, "api")
    store = u.Store()
    log = []

    def rb(name, ns="ns"):
        return api.ResourceBinding(meta=api.ObjectMeta(name=name, namespace=ns))

    store.apply(rb("a"))
    store.apply(rb("b"))
    store.watch("ResourceBinding", lambda e: log.append((e.type, e.key)))
    store.watch("ResourceBinding", lambda e: log.append(("quiet", e.key)), replay=False)
    log.append(("rv", store.get("ResourceBinding", "ns/a").meta.resource_version))
    try:
        store.apply(rb("a"), expected_rv=0)  # 0: the object must not exist
    except mod(pkg, "utils.store").ConflictError:
        log.append(("conflict",))
    store.apply(store.get("ResourceBinding", "ns/b"), expected_rv=2)
    log.append(("deleted", store.delete("ResourceBinding", "ns/a") is not None,
                store.delete("ResourceBinding", "ns/a") is None))
    log.append(("errors", store.apply_many([rb("c"), rb("d")])))
    log.append(("keys", sorted(u.obj_key(o) for o in store.list("ResourceBinding")),
                u.obj_kind(rb("x"))))

    def admission(kind, obj):
        if obj.meta.name.startswith("bad"):
            raise ValueError(f"{kind} {obj.meta.name} refused")

    gated = u.Store(admission=admission)
    gated.watch_all(lambda e: log.append(("all", e.type, e.kind, e.key)))
    log.append(("refused", [(o.meta.name, str(e)) for o, e in
                            gated.apply_many([rb("ok"), rb("bad1"), rb("ok2")])]))
    rt = u.Runtime()
    batches = []

    def batch(keys):
        batches.append(list(keys))
        if "poison" in keys:
            raise RuntimeError("poisoned")
        return {k: u.DONE for k in keys}

    w = rt.new_worker("w", lambda k: u.REQUEUE if k == "poison" else u.DONE,
                      reconcile_batch=batch, batch_size=4)
    for k in ("k1", "k2", "k3", "k1", "k4", "poison", "k5"):
        w.enqueue(k)
    log.append(("queued", len(w)))
    log.append(("steps", rt.run_until_settled(max_steps=200)))
    log.append(("batches", batches[:8], len(w)))
    return log


def test_store_and_worker_behave_as_jax():
    assert store_trace(karmada_tpu_torch) == store_trace(karmada_tpu)


def test_metric_exposition_equals_jax():
    """The port's Registry renders the same Prometheus text as the JAX
    package's for the same counter, gauge and histogram samples."""
    texts = []
    for pkg in PKGS:
        m = mod(pkg, "utils.metrics")
        reg = m.Registry()
        c = reg.counter("t_total", 'help with "quotes" and \\ a backslash')
        c.inc(reason="QuotaExceeded")
        c.inc(2, reason='a "b"\nc')
        reg.gauge("t_depth", "depth").set(7, worker="scheduler")
        h = reg.histogram("t_seconds", "seconds", buckets=m.E2E_BUCKETS)
        for v in (0.001, 0.3, 42.0, 1000.0):
            h.observe(v)
        texts.append((reg.render(), h.summary(), c.value(reason="QuotaExceeded")))
    assert texts[0] == texts[1]


def test_controller_phase_rehearsal(capsys):
    """chip_smoke's controller phase at a small size on the CPU: every
    wave's check raises on any difference."""
    out = chip_smoke.run_controller(torch.device("cpu"), "cpu", bindings=500, clusters=120,
                                    scale=40, quota_rows=500, residents=400, surge=24)
    assert set(out["waves"]) >= {"cold", "scale", "drift", "quota", "surge", "victims"}
    printed = capsys.readouterr().out
    assert "500 ok / 0 bad" in printed and "rebalance_np's set equal" in printed
    assert "500 placed, 0 not written" in printed
    assert "held to the numpy divider with their clusters excluded" in printed


def test_settle_wave_fails_when_a_reconcile_raises():
    """The smoke's waves fail on an engine error that the worker catches
    and requeues, after one engine call and without retries."""
    snap, problems = recipe(karmada_tpu_torch, clusters=12, bindings=30)
    u = karmada_tpu_torch.utils
    store, rt = u.Store(), u.Runtime()
    ctl = karmada_tpu_torch.controllers.SchedulerController(store, rt, device="cpu")
    ctl.worker.MAX_RETRIES = ctl.worker.POISON_TOLERANCE = 0
    clusters, rbs, _ = chip_smoke.binding_objects(karmada_tpu_torch, snap, problems)
    store.apply_many(clusters)
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("kernel launch failed")

    ctl._inproc_engine = broken
    store.apply_many(rbs)
    with pytest.raises(AssertionError, match="(?s)31 reconcile errors.*kernel launch failed"):
        chip_smoke.settle_wave("broken wave", rt, ctl, torch.device("cpu"), "cpu")
    assert len(calls) == 1 and rt.pending() == 0
    assert chip_smoke.unwritten(rbs) == len(rbs)
