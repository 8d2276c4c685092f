"""The port's engine under the quota plane against the JAX engine, on the
CPU, on the tiny-batch, general and fleet routes: the same FRQs packed by
each package's ``build_quota_snapshot``, the same waves, and after every
pass the same admitted/denied partition, the same placements and affinity
names, and the same working ``remaining`` after the debit. The cases mirror
tests/test_quota_plane.py (``TestEngineAdmission`` and the engine-level
``TestReviewRegressions``), plus the fleet's avail-max bound under a cap
above every summary answer and a CPU rehearsal of chip_smoke's quota phase.
Tolerance: exact equality (integer placements)."""

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.utils.builders  # noqa: F401  (chip_smoke builds by name)

import karmada_tpu_torch
import karmada_tpu_torch.scheduler as TS

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)
ROUTES = ("tiny", "general", "fleet")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def outcome(results):
    return [(r.key, dict(r.clusters), r.error, r.affinity_name, tuple(r.feasible))
            for r in results]


def mod(pkg, name):
    return __import__(f"{pkg.__name__}.{name}", fromlist=["x"])


def fleet_for(pkg, route):
    """Four clusters for the tiny-batch route, 300 for the general and the
    fleet routes (the general route's padded rows x clusters pass 2^16)."""
    b = mod(pkg, "utils.builders")
    if route == "tiny":
        return [b.new_cluster(f"m{i}", cpu="1000", memory="2000Gi") for i in range(4)]
    return [b.new_cluster(f"m{i}", cpu=str(1000 + 7 * i), memory="2000Gi", pods=100_000)
            for i in range(300)]


class Pair:
    """The same scenario in both packages: one engine each, driven in turn
    by ``do(fn)`` where fn(pkg, engine, snapshot) returns what to compare."""

    def __init__(self, route, fleet_threshold=None):
        self.route = route
        self.snaps, self.engines = [], []
        for pkg in PKGS:
            snap = mod(pkg, "scheduler").ClusterSnapshot(fleet_for(pkg, route))
            eng = (JS.TensorScheduler(snap, chunk_size=1024) if pkg is karmada_tpu
                   else TS.TensorScheduler(snap, chunk_size=1024, device="cpu"))
            if route == "general":
                eng.fleet_threshold = 10**9
            self.snaps.append(snap)
            self.engines.append(eng)

    def set_quota(self, frqs_fn, generation):
        for pkg, snap, eng in zip(PKGS, self.snaps, self.engines):
            eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
                frqs_fn(pkg, snap), snap, generation=generation))

    def schedule(self, waves_fn):
        """Both engines schedule ``waves_fn(pkg, snap)``; returns the port's
        results after asserting outcomes and remaining equal."""
        out = []
        for pkg, snap, eng in zip(PKGS, self.snaps, self.engines):
            out.append(eng.schedule(waves_fn(pkg, snap)))
        assert outcome(out[1]) == outcome(out[0])
        rem = [None if e.quota is None else e.quota.remaining for e in self.engines]
        if rem[0] is not None:
            np.testing.assert_array_equal(rem[1], rem[0])
        return out[1]


def frq(pkg, ns, overall, static=(), used=None):
    pol = mod(pkg, "api.policy")
    core = mod(pkg, "api.core")
    q = pol.FederatedResourceQuota(
        meta=core.ObjectMeta(name="q", namespace=ns),
        spec=pol.FederatedResourceQuotaSpec(
            overall=dict(overall),
            static_assignments=[pol.StaticClusterAssignment(cluster_name=c, hard=dict(h))
                                for c, h in static]),
    )
    if used is not None:
        q.status = pol.FederatedResourceQuotaStatus(overall=dict(overall),
                                                    overall_used=dict(used))
    return q


def problem(pkg, key, ns, replicas, prev=None, placement=None):
    b = mod(pkg, "utils.builders")
    return mod(pkg, "scheduler").BindingProblem(
        key=key, placement=placement or b.dynamic_weight_placement(),
        replicas=replicas, requests={"cpu": 1000}, gvk="apps/v1/Deployment",
        prev=dict(prev or {}), namespace=ns,
    )


def rows(route):
    """Wave size per route: a few rows on the tiny route, 300 on the general
    route (padded past 2^16 cells), 700 on the fleet route (an admitted half
    still passes the fleet threshold)."""
    return {"tiny": 4, "general": 300, "fleet": 700}[route]


@pytest.mark.parametrize("route", ROUTES)
def test_fifo_denial_and_unquotad_passthrough(route):
    pair = Pair(route)
    n = rows(route)
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 2000 * (n // 2) + 1000})], 1)

    def wave(pkg, s):
        return [problem(pkg, f"a/b{i}", "a", 2) for i in range(n)] + [
            problem(pkg, "z/b0", "z", 2)]

    res = pair.schedule(wave)
    errs = [r.error for r in res]
    assert errs[: n // 2] == [""] * (n // 2)
    assert errs[n // 2 :][:-1] == [TS.QUOTA_EXCEEDED_ERROR] * (n - n // 2)
    assert errs[-1] == ""
    if route == "fleet":
        assert all(e._fleet is not None for e in pair.engines)


@pytest.mark.parametrize("route", ROUTES)
def test_delta_demand_admits_steady_reschedule(route):
    """A binding already holding its replicas has zero delta demand."""
    pair = Pair(route)
    n = rows(route)
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 4000}, used={"cpu": 4000})], 1)

    def wave(pkg, s):
        held = [problem(pkg, f"a/held{i}", "a", 2, prev={"m0": 1, "m1": 1})
                for i in range(n)]
        return held + [problem(pkg, "a/new", "a", 2)]

    res = pair.schedule(wave)
    assert all(r.success for r in res[:-1])
    assert res[-1].error == TS.QUOTA_EXCEEDED_ERROR


@pytest.mark.parametrize("route", ROUTES)
def test_denied_partition_replays_until_generation_bump(route):
    pair = Pair(route)
    n = rows(route)
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 3000})], 1)
    waves = [[problem(pkg, f"a/b{i}", "a", 2) for i in range(n)] for pkg in PKGS]

    def wave(pkg, s):
        return waves[PKGS.index(pkg)]

    res1 = pair.schedule(wave)
    assert [r.success for r in res1[:3]] == [True, False, False]
    port = pair.engines[1]
    sub = port._quota_cache[2]
    res2 = pair.schedule(wave)  # the replay: same partition, same sub-list
    assert outcome(res2) == outcome(res1) and port._quota_cache[2] is sub
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 2000 * n})], 2)
    res3 = pair.schedule(wave)
    assert all(r.success for r in res3)


@pytest.mark.parametrize("route", ROUTES)
def test_static_caps_bound_placement(route):
    """A static-assignment cap bounds a cluster's replicas on every route
    (the fleet folds it into the namespace's interned profile slot)."""
    pair = Pair(route)
    n = rows(route)
    pair.set_quota(lambda pkg, s: [frq(pkg, "c", {"cpu": 10**9},
                                       static=[("m0", {"cpu": 3000})])], 1)

    def wave(pkg, s):
        return [problem(pkg, f"c/f{i}", "c", 8 if route == "tiny" else 40)
                for i in range(n)] + [problem(pkg, "free", "", 40)]

    res = pair.schedule(wave)
    assert all(r.success for r in res)
    assert all(r.clusters.get("m0", 0) <= 3 for r in res[:-1])


def test_cap_change_drops_fleet_but_generation_bump_does_not():
    pair = Pair("fleet")
    pair.set_quota(lambda pkg, s: [frq(pkg, "c", {"cpu": 10_000_000})], 1)
    pair.schedule(lambda pkg, s: [problem(pkg, f"c/f{i}", "c", 4) for i in range(300)])
    port = pair.engines[1]
    fleet = port._fleet
    assert fleet is not None
    pair.set_quota(lambda pkg, s: [frq(pkg, "c", {"cpu": 9_000_000})], 2)
    assert port._fleet is fleet
    port.set_quota(None)
    assert port._fleet is fleet
    pair.set_quota(lambda pkg, s: [frq(pkg, "c", {"cpu": 9_000_000})], 2)
    assert port._fleet is fleet
    pair.set_quota(lambda pkg, s: [frq(pkg, "c", {"cpu": 10_000_000},
                                       static=[("m1", {"cpu": 1000})])], 3)
    assert port._fleet is None and pair.engines[0]._fleet is None
    pair.schedule(lambda pkg, s: [problem(pkg, f"c/f{i}", "c", 4) for i in range(300)])


@pytest.mark.parametrize("route", ROUTES)
def test_cross_pass_debit_within_generation(route):
    """Consecutive passes within one generation share the debited remaining."""
    pair = Pair(route)
    n = rows(route)
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 2000 * n + 2000})], 1)
    r1 = pair.schedule(lambda pkg, s: [problem(pkg, f"a/x{i}", "a", 2) for i in range(n)])
    assert all(r.success for r in r1)
    r2 = pair.schedule(lambda pkg, s: [problem(pkg, "a/y", "a", 3)])
    assert r2[0].error == TS.QUOTA_EXCEEDED_ERROR
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 4000}, used={"cpu": 2000})], 2)
    assert pair.schedule(lambda pkg, s: [problem(pkg, "a/y", "a", 2)])[0].success


@pytest.mark.parametrize("route", ROUTES)
def test_failed_solve_charges_nothing(route):
    """A pass that dies mid-solve leaves its demand uncharged and drops the
    partition cache; the retry re-admits, and the committed wave is
    charged."""
    pair = Pair(route)
    n = rows(route)
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 2000 * n})], 1)
    for eng in pair.engines:
        inner = eng._schedule_inner

        def dying(problems, _inner=inner, _eng=eng):
            _eng._schedule_inner = _inner
            raise RuntimeError("mid-solve death")

        eng._schedule_inner = dying
        with pytest.raises(RuntimeError):
            eng.schedule([problem(karmada_tpu if eng is pair.engines[0]
                                  else karmada_tpu_torch, "a/x", "a", 2)])
        assert eng._quota_cache is None
    res = pair.schedule(lambda pkg, s: [problem(pkg, f"a/x{i}", "a", 2) for i in range(n)])
    assert all(r.success for r in res)
    r2 = pair.schedule(lambda pkg, s: [problem(pkg, "a/y", "a", 1)])
    assert r2[0].error == TS.QUOTA_EXCEEDED_ERROR


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scenario", ["replay_rest", "same_shape", "new_shape",
                                      "no_demand", "switched_off"])
def test_delta_admission_equals_jax(route, scenario, monkeypatch):
    """A wave whose problem objects moved in a minority of positions within
    one quota generation: both engines admit only the changed rows and
    replay the rest uncharged (the JAX engine's delta admission; a full
    admission would charge the unchanged rows again), or, with
    ``KARMADA_TPU_DELTA_SOLVE=0``, both run the full admission."""
    if scenario == "switched_off":
        monkeypatch.setenv("KARMADA_TPU_DELTA_SOLVE", "0")
    pair = Pair(route)
    n = rows(route)
    # room for about two thirds of the wave's first pass
    pair.set_quota(lambda pkg, s: [frq(pkg, "a", {"cpu": 2000 * (2 * n // 3) + 1000})], 1)
    waves = [[problem(pkg, f"a/b{i}", "a", 2) for i in range(n)] for pkg in PKGS]
    pair.schedule(lambda pkg, s: waves[PKGS.index(pkg)])
    moved = {"replay_rest": [0], "same_shape": [n - 1], "new_shape": [0, 1],
             "no_demand": [1], "switched_off": [0]}[scenario]
    for k, pkg in enumerate(PKGS):
        for i in moved:
            prev = {"m0": 2} if scenario == "no_demand" else None
            reps = 1 if scenario == "new_shape" else 2
            waves[k][i] = problem(pkg, f"a/b{i}", "a", reps, prev=prev)
    port = pair.engines[1]
    sub0 = port._quota_cache[2]
    res = pair.schedule(lambda pkg, s: waves[PKGS.index(pkg)])
    if scenario == "same_shape":  # the changed denied row stays denied
        assert res[n - 1].error == TS.QUOTA_EXCEEDED_ERROR
        assert port._quota_cache[2] is not sub0
    if scenario == "switched_off":  # a full admission charges every row again
        assert sum(r.error == TS.QUOTA_EXCEEDED_ERROR for r in res) > n // 2


def test_spread_selection_sees_capped_availability():
    """Group selection ranks spread groups on cap-folded availability: a
    capped group that cannot fit loses to an uncapped one."""
    pair = Pair("tiny")
    pair.set_quota(lambda pkg, s: [frq(pkg, "c", {"cpu": 10_000_000},
                                       static=[("m0", {"cpu": 1000}),
                                               ("m1", {"cpu": 1000})])], 1)

    def wave(pkg, s):
        api = mod(pkg, "api")
        b = mod(pkg, "utils.builders")
        pl = b.dynamic_weight_placement(spread_constraints=[api.SpreadConstraint(
            spread_by_field="cluster", min_groups=2, max_groups=2)])
        return [problem(pkg, "c/spread", "c", 8, placement=pl)]

    res = pair.schedule(wave)[0]
    assert res.success and sum(res.clusters.values()) == 8
    assert res.clusters.get("m0", 0) <= 1 and res.clusters.get("m1", 0) <= 1


def test_disarmed_quota_is_the_plain_engine():
    pair = Pair("fleet")
    res = pair.schedule(lambda pkg, s: [problem(pkg, f"a/x{i}", "a", 2) for i in range(300)])
    assert all(r.success for r in res) and pair.engines[1].quota is None


def estimators(n: int) -> list:
    """``n`` out-of-tree estimators, each answering -1 (no answer), MAX_INT32
    and a real value on different clusters (which cluster gives which
    answer shifts with the estimator), for any batch."""
    def answer(k):
        def est(requests, replicas):
            b, j = len(replicas), np.arange(300)
            row = np.where((j + k) % 3 == 0, -1,
                           np.where((j + k) % 3 == 1, 2**31 - 1, 3 + (7 * j + 13 * k) % 40))
            return np.broadcast_to(row.astype(np.int32), (b, 300)).copy()
        return est

    return [answer(k) for k in range(n)]


def general_pair(n_estimators: int):
    """Both engines over the 300-cluster fleet with ``n_estimators``
    ``estimators``, on the general route."""
    engines = []
    for pkg in PKGS:
        snap = mod(pkg, "scheduler").ClusterSnapshot(fleet_for(pkg, "general"))
        kw = dict(chunk_size=1024, extra_estimators=estimators(n_estimators))
        eng = (JS.TensorScheduler(snap, **kw) if pkg is karmada_tpu
               else TS.TensorScheduler(snap, device="cpu", **kw))
        eng.fleet_threshold = 10**9
        engines.append((pkg, snap, eng))
    return engines


def test_caps_beyond_the_merge_slots_raise():
    """K1's merge form takes any number of extra answers: static-assignment
    caps beside 4 estimators (5 answers) and beside 8 (9 answers) place as
    the JAX engine places, where the port used to raise."""
    for n in (4, 8):
        outs = []
        for pkg, snap, eng in general_pair(n):
            eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
                [frq(pkg, "c", {"cpu": 10**9}, static=[("m0", {"cpu": 1000}),
                                                      ("m2", {"cpu": 5000})])],
                snap, 1))
            outs.append(outcome(eng.schedule(
                [problem(pkg, f"c/{i}", "c", 3 + i % 60) for i in range(300)])))
        assert outs[1] == outs[0]
        placed = [o for o in outs[1] if not o[2]]
        assert placed and all(o[1].get("m0", 0) <= 1 for o in placed)


@pytest.mark.parametrize("n", [5, 9])
def test_extra_estimators_past_four_equal_jax(n):
    """5 and 9 out-of-tree estimators and no caps, on the general route:
    one merge over every answer, as in the JAX engine."""
    outs = []
    for pkg, _snap, eng in general_pair(n):
        outs.append(outcome(eng.schedule(
            [problem(pkg, f"z/{i}", "", 3 + i % 60) for i in range(300)])))
    assert outs[1] == outs[0]
    # every row placed, none on a cluster past the smallest real answer
    answers = np.stack([est(None, [0])[0] for est in estimators(n)]).astype(np.int64)
    cap = np.where(answers == -1, 2**31 - 1, answers).min(axis=0)
    assert all(not o[2] for o in outs[1])
    assert all(v <= cap[int(name[1:])] for o in outs[1] for name, v in o[1].items())


def test_avail_max_bound_under_a_cap_above_every_summary_answer():
    """The fleet's avail-max bound: a cap on clusters with no summary turns
    their cells into answers far above every summary answer. The JAX fleet
    reads its bound from a host mirror without the caps; the port reads it
    from the cap-folded device table. Both engines' placements, and the
    numpy divider's on cap-folded availability, are compared."""
    outs, bounds = [], []
    for pkg in PKGS:
        b = mod(pkg, "utils.builders")
        clusters = [b.new_cluster(f"m{i}", cpu="2", memory="64Gi", pods=1000)
                    for i in range(6)]
        for cl in clusters[4:]:  # no ResourceSummary
            cl.status.resource_summary.allocatable = {}
        snap = mod(pkg, "scheduler").ClusterSnapshot(clusters)
        eng = (JS.TensorScheduler(snap) if pkg is karmada_tpu
               else TS.TensorScheduler(snap, device="cpu"))
        eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
            [frq(pkg, "c", {"cpu": 10**12},
                 static=[("m4", {"cpu": 10**9}), ("m5", {"cpu": 10**9 + 7})])],
            snap, 1))
        probs = [problem(pkg, f"c/{i}", "c", 60 + i % 40) for i in range(300)]
        outs.append(outcome(eng.schedule(probs)))
        bounds.append(eng._fleet._avail_max)
        if pkg is karmada_tpu_torch:
            port, port_probs = eng, probs
    # the port's bound sees the folded caps, the JAX bound does not
    assert bounds[1] == 10**6 and bounds[0] == 2
    port_res = port.schedule(port_probs)
    assert chip_smoke.oracle_check(port, port_probs, port_res) == 0
    # on this case the JAX engine's variant choice still places as the
    # numpy divider does
    assert outs[1] == outs[0]


def test_quota_phase_rehearses_on_cpu_and_equals_jax(capsys):
    """chip_smoke's quota phase end to end on the CPU at a small size (cold,
    steady replay, surge, raise, delta, the general-route pass; every
    partition against admit_wave_np, admitted rows against the numpy
    divider; the surge wave replayed with provenance armed, every denied row
    carrying the QuotaExceeded bit), and the
    JAX engine driven through the same cold and surge passes answers the
    same."""
    cpu = torch.device("cpu")
    out = chip_smoke.run_quota(cpu, "cpu", bindings=1500, clusters=200, general_rows=500)
    assert out["denied"]["cold"] == 0 and out["denied"]["surge"] > 0
    assert out["admitted"]["surge"] > 0
    assert out["explain"]["denied"] == out["denied"]["surge"]
    assert out["explain"]["captures"] == 1
    printed = capsys.readouterr().out
    assert printed.count(" 0 bad") == 3 and "its denials" in printed
    assert "rebuilt rows admitted again" in printed
    # the JAX engine on the same cold and surge waves
    res = []
    for pkg in PKGS:
        snap, problems = chip_smoke.quota_workload(pkg, 600, 120)
        s = mod(pkg, "scheduler")
        eng = (JS.TensorScheduler(snap, chunk_size=4096) if pkg is karmada_tpu
               else TS.TensorScheduler(snap, chunk_size=4096, device="cpu"))
        limits = {ns: dict(chip_smoke.GENEROUS) for ns in chip_smoke.QUOTA_NAMESPACES}
        eng.set_quota(s.build_quota_snapshot(chip_smoke.quota_frqs(pkg, snap, limits),
                                             snap, 1))
        cold = eng.schedule(problems)
        used = chip_smoke.cpu_usage(problems, cold)
        surge = [s.BindingProblem(key=p.key, placement=p.placement,
                                  replicas=p.replicas + 3 * (i % 2 == 0),
                                  requests=p.requests, gvk=p.gvk,
                                  prev=dict(r.clusters) if r.success else dict(p.prev),
                                  namespace=p.namespace)
                 for i, (p, r) in enumerate(zip(problems, cold))]
        limits = {ns: {"cpu": used[ns]["cpu"] + 1500} for ns in used}
        eng.set_quota(s.build_quota_snapshot(
            chip_smoke.quota_frqs(pkg, snap, limits, used), snap, 2))
        res.append((outcome(cold), outcome(eng.schedule(surge)), eng.quota.remaining))
    assert res[1][0] == res[0][0] and res[1][1] == res[0][1]
    np.testing.assert_array_equal(res[1][2], res[0][2])
    assert any(r[2] == TS.QUOTA_EXCEEDED_ERROR for r in res[1][1])


def test_cap_blind_bound_at_config5_width():
    """The cap-blind avail-max bound at config 5's width: 5000 clusters,
    two of them without a summary and capped at 10^6 replicas (10^6 + 7 on
    the second), and 40 dynamic-weight rows of 61-178 replicas whose
    division leaves a remainder on the capped pair. At this width the
    cluster index takes 13 bits of the JAX fleet's packed dispense key,
    leaving 14 weight bits, and the capped weights times the replicas pass
    ``div_f32``'s 2^24 product bound; the JAX fleet picks that variant from
    a bound that does not see the caps. The port (K2's wide form only)
    equals the numpy divider on every row; the JAX engine does not: it
    hands the remainder to another cluster (a fault of the reference,
    recorded in ROADMAP.md, section C)."""
    outs, bounds = [], []
    for pkg in PKGS:
        b = mod(pkg, "utils.builders")
        clusters = [b.new_cluster(f"m{i}", cpu="2", memory="64Gi", pods=1000)
                    for i in range(5000)]
        for cl in (clusters[1234], clusters[4321]):  # no ResourceSummary
            cl.status.resource_summary.allocatable = {}
        snap = mod(pkg, "scheduler").ClusterSnapshot(clusters)
        eng = (JS.TensorScheduler(snap) if pkg is karmada_tpu
               else TS.TensorScheduler(snap, device="cpu"))
        eng.fleet_threshold = 16  # the rows ride the fleet table
        eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
            [frq(pkg, "c", {"cpu": 10**12},
                 static=[("m1234", {"cpu": 10**9}), ("m4321", {"cpu": 10**9 + 7000})])],
            snap, 1))
        probs = [problem(pkg, f"c/{i}", "c", 61 + 3 * i) for i in range(40)]
        outs.append(outcome(eng.schedule(probs)))
        assert eng._fleet is not None
        bounds.append(eng._fleet._avail_max)
        if pkg is karmada_tpu_torch:
            port, port_probs = eng, probs
    assert bounds == [2, 10**6 + 7]
    port_res = port.schedule(port_probs)
    assert outcome(port_res) == outs[1]
    assert chip_smoke.oracle_check(port, port_probs, port_res) == 0
    assert all(sum(o[1].values()) == 61 + 3 * i for i, o in enumerate(outs[1]))
    # the reference fault: rows where the JAX engine differs from the divider
    differ = [i for i, (j, t) in enumerate(zip(outs[0], outs[1])) if j != t]
    assert differ and all(sum(outs[0][i][1].values()) == 61 + 3 * i for i in differ)
