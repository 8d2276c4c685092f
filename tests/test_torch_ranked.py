"""The ranked multi-term path (ordered ClusterAffinities failover) of the
port against the JAX engine, on the CPU: ``first_fit_group`` and
``affinity_group_rank`` against the JAX package's, the engine on the cases
of tests/test_failover_chaos.py::TestRankedOrderedFailover, the ranked path
under static-assignment quota caps on the tiny-batch and general routes, a
batch mixing ranked, single-term and multi-term-with-spread rows, and a CPU
rehearsal of chip_smoke's ranked phase. Every result must agree on key,
placed clusters, error, affinity name and feasible set, and with the port's
copy of the ordered-failover referent (``refimpl/failover_np.py``).
Tolerance: exact equality (integer placements)."""

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.ops.masks as JM
import karmada_tpu.scheduler as JS
import karmada_tpu.utils.builders  # noqa: F401  (chip_smoke builds by name)
from karmada_tpu.refimpl.failover_np import solve_one_ordered as jax_solve_one

import karmada_tpu_torch
import karmada_tpu_torch.ops.masks as TM
import karmada_tpu_torch.scheduler as TS
from karmada_tpu_torch.refimpl.failover_np import solve_one_ordered

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)


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


def engine(pkg, snap, **kw):
    if pkg is karmada_tpu:
        return JS.TensorScheduler(snap, **kw)
    return TS.TensorScheduler(snap, device="cpu", **kw)


# --------------------------------------------------------------------------
# first_fit_group
# --------------------------------------------------------------------------


def test_affinity_group_rank_equals_jax():
    rng = np.random.default_rng(0)
    terms = rng.random((5, 3, 17)) < 0.3
    np.testing.assert_array_equal(TM.affinity_group_rank(terms), JM.affinity_group_rank(terms))
    assert TM.affinity_group_rank(np.array([[True, False, True], [False, True, True]])
                                  ).tolist() == [0, 1, 0]
    assert TM.affinity_group_rank(np.zeros((2, 3), bool)).tolist() == [2, 2, 2]


def port_groups(arrays, with_base=True):
    """The port's ``first_fit_group`` (its plain version: CPU tensors) on
    numpy ``arrays`` keyed by ``chip_smoke.GROUP_ARGS``."""
    got = TM.first_fit_group(*(torch.from_numpy(np.ascontiguousarray(arrays[k]))
                               for k in chip_smoke.GROUP_ARGS), with_base=with_base)
    assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.bool]
    return tuple(g.numpy() for g in got)


def jax_group_args(a):
    """The JAX ``first_fit_group``'s arguments for the port's: the [B, T, C]
    candidate stack and per-row live-term counts, int64 sums' inputs."""
    return (a["base"][:, None, :] & a["terms"][a["cp_idx"]], a["term_len"][a["cp_idx"]],
            a["avail"].astype(np.int64), a["replicas"].astype(np.int64),
            a["prev"].astype(np.int64), a["dynamic"], a["fresh"])


def check_groups(a):
    """Port == JAX under numpy == JAX's backend-generic body under jnp (the
    CPU backend), for rank and fit; ``selected`` equals the candidate stack
    (or, with_base off, the term masks) at each row's rank."""
    import jax.numpy as jnp

    rank, fit, selected = port_groups(a)
    jargs = jax_group_args(a)
    want = JM.first_fit_group(*jargs)
    on_device = JM._first_fit_group_kernel(jnp, *map(jnp.asarray, jargs))
    for w in (want, on_device):
        np.testing.assert_array_equal(rank, np.asarray(w[0]))
        np.testing.assert_array_equal(fit, np.asarray(w[1]))
    rows = np.arange(len(rank))
    np.testing.assert_array_equal(selected, jargs[0][rows, rank])
    _r, _f, term_only = port_groups(a, with_base=False)
    np.testing.assert_array_equal(term_only, a["terms"][a["cp_idx"]][rows, rank])
    return rank, fit


@pytest.mark.parametrize("seed", range(6))
def test_first_fit_group_equals_jax(seed):
    """Every cohort of the divider's predicate (fresh, scale-up, scale-down,
    steady, non-dynamic strategies), empty terms, rows with fewer live
    terms than T, and availability near int32."""
    rng = np.random.default_rng(seed)
    b, t, c, u = 64, int(rng.integers(1, 5)), int(rng.integers(1, 30)), 5
    terms = rng.random((u, t, c)) < rng.uniform(0.0, 0.8, (u, t, 1))
    base = rng.random((b, c)) < rng.uniform(0.3, 1.0, (b, 1))
    cp_idx = rng.integers(0, u, b).astype(np.int32)
    term_len = rng.integers(1, t + 1, u).astype(np.int32)
    avail = rng.integers(0, 50, (b, c)).astype(np.int32)
    avail[rng.random((b, c)) < 0.02] = 2**31 - 1
    replicas = rng.integers(0, 120, b).astype(np.int32)
    prev = np.where(rng.random((b, c)) < 0.2, rng.integers(1, 20, (b, c)), 0).astype(np.int32)
    steady = rng.random(b) < 0.2
    replicas[steady] = prev.sum(axis=1)[steady]
    check_groups({"base": base, "terms": terms, "cp_idx": cp_idx, "term_len": term_len,
                  "avail": avail, "replicas": replicas, "prev": prev,
                  "dynamic": rng.random(b) < 0.7, "fresh": rng.random(b) < 0.2})


@pytest.mark.parametrize("t,c", [(1, 1), (4, 1), (9, 1), (4, 37), (1, 5000), (4, 5000),
                                 (9, 5000)])
def test_first_fit_group_edge_cases_equal_jax(t, c):
    """``chip_smoke.group_edge_batch``, the batch K17 is held to on the
    card: T past one register group (9), term_len below T, all-false and
    all-true terms (dead ones included), padded rows, one cluster and 5000
    with MAX_INT32 answers (int64 sums past 2^31), zero replicas, steady
    rows at exactly their previous sum, fresh and non-dynamic rows."""
    a = chip_smoke.group_edge_batch(np.random.default_rng(100 * t + c), 96, t, c)
    rank, fit = check_groups(a)
    pad = 96 - 96 // 8
    # padded rows: placement 0's last live term, no fit
    assert (rank[pad:] == max(int(a["term_len"][0]) - 1, 0)).all() and not fit[pad:].any()
    # a placement with every term empty never fits
    assert not fit[a["cp_idx"] == 1].any()
    if c == 5000:  # the int64 sums did pass 2^31
        dyn_sums = (a["avail"].astype(np.int64) * a["base"]).sum(axis=1)[a["dynamic"]]
        assert dyn_sums.max() > 2**31
    if t > 1:  # a fallback group was selected somewhere
        assert (fit & (rank > 0)).any()


def test_first_fit_group_seeded_chunk_equals_jax():
    """``chip_smoke.group_batch``, the seeded ranked chunk K17 is timed on,
    at a reduced size."""
    check_groups(chip_smoke.group_batch(np.random.default_rng(8), b=256, c=700))


def test_first_fit_group_checks_its_inputs():
    """The wrapper's shape checks (on the meta device, no kernel) and the
    plain version on CPU tensors launching nothing."""
    a = chip_smoke.group_edge_batch(np.random.default_rng(1), 16, 3, 9)
    args = [torch.from_numpy(np.ascontiguousarray(a[k])) for k in chip_smoke.GROUP_ARGS]
    before = TM.first_fit_group.launches
    TM.first_fit_group(*args)
    assert TM.first_fit_group.launches == before
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):  # not one CUDA device
        TM.first_fit_group(*meta)


def test_solve_one_ordered_copy_equals_jax():
    rng = np.random.default_rng(4)
    for _ in range(40):
        c = 12
        terms = rng.random((3, c)) < 0.4
        base = rng.random(c) < 0.9
        avail = rng.integers(0, 20, c).astype(np.int32)
        prev = np.where(rng.random(c) < 0.2, 3, 0).astype(np.int32)
        args = (terms, base, int(rng.integers(0, 4)), int(rng.integers(1, 60)),
                rng.integers(0, 5, c).astype(np.int32), avail, prev, bool(rng.random() < 0.3))
        got, want = solve_one_ordered(*args), jax_solve_one(*args)
        assert (got[1], got[2]) == (want[1], want[2])
        assert (got[0] is None) == (want[0] is None)
        if got[0] is not None:
            np.testing.assert_array_equal(got[0], want[0])


# --------------------------------------------------------------------------
# the engine, on the failover chaos cases
# --------------------------------------------------------------------------


def group_term(pkg, group):
    api = mod(pkg, "api")
    return api.ClusterAffinityTerm(
        affinity_name=f"grp-{group}",
        label_selector=api.LabelSelector(match_labels={"group": group}))


def grouped_snapshot(pkg, n_primary, n_fallback, primary_cpu, fallback_cpu, **kw):
    b = mod(pkg, "utils.builders")
    clusters = [b.new_cluster(f"p{i}", cpu=primary_cpu, memory="400Gi",
                              labels={"group": "primary"}, **kw)
                for i in range(n_primary)] + [
               b.new_cluster(f"f{i}", cpu=fallback_cpu, memory="4000Gi",
                             labels={"group": "fallback"}, **kw)
               for i in range(n_fallback)]
    clusters.sort(key=lambda c: c.name)
    return mod(pkg, "scheduler").ClusterSnapshot(clusters)


def both(build, **kw):
    """Schedule ``build(pkg) -> (snapshot, problems)`` in both engines;
    assert equal outcomes and return (port engine, problems, results)."""
    outs = []
    for pkg in PKGS:
        snap, problems = build(pkg)
        eng = engine(pkg, snap, **kw)
        res = eng.schedule(problems)
        outs.append(outcome(res))
    assert outs[1] == outs[0]
    return eng, problems, res


def test_batch_matches_jax_and_per_binding_oracle():
    def build(pkg):
        rng = np.random.default_rng(7)
        snap = grouped_snapshot(pkg, 4, 4, "8", "64")
        b = mod(pkg, "utils.builders")
        pl = b.dynamic_weight_placement(
            cluster_affinities=[group_term(pkg, "primary"), group_term(pkg, "fallback")])
        probs = []
        for i in range(240):
            reps = int(rng.integers(1, 30))
            prev = {f"p{int(rng.integers(0, 4))}": max(1, reps // 2)} if i % 3 == 0 else {}
            probs.append(mod(pkg, "scheduler").BindingProblem(
                key=f"b{i}", placement=pl, replicas=reps, requests={"cpu": 1000},
                gvk="apps/v1/Deployment", prev=prev, fresh=bool(i % 5 == 0)))
        return snap, probs

    eng, probs, res = both(build)
    assert chip_smoke.ranked_referent(eng, probs, res) == 0


def test_fallback_engaged_only_when_primary_cannot_fit():
    def build(pkg):
        snap = grouped_snapshot(pkg, 2, 2, "4", "400")
        b = mod(pkg, "utils.builders")
        pl = b.dynamic_weight_placement(
            cluster_affinities=[group_term(pkg, "primary"), group_term(pkg, "fallback")])
        s = mod(pkg, "scheduler")
        return snap, [
            s.BindingProblem(key="small", placement=pl, replicas=2,
                             requests={"cpu": 1000}, gvk="apps/v1/Deployment"),
            s.BindingProblem(key="big", placement=pl, replicas=100,
                             requests={"cpu": 1000}, gvk="apps/v1/Deployment")]

    _, _, res = both(build)
    by = {r.key: r for r in res}
    assert set(by["small"].clusters) <= {"p0", "p1"}
    assert by["small"].affinity_name == "grp-primary"
    assert set(by["big"].clusters) <= {"f0", "f1"}
    assert by["big"].affinity_name == "grp-fallback"


def test_displaced_wave_is_one_batched_solve():
    def build(pkg):
        snap = grouped_snapshot(pkg, 3, 3, "64", "64")
        b = mod(pkg, "utils.builders")
        pl = b.dynamic_weight_placement(
            cluster_affinities=[group_term(pkg, "primary"), group_term(pkg, "fallback")])
        return snap, [mod(pkg, "scheduler").BindingProblem(
            key=f"d{i}", placement=pl, replicas=4, requests={"cpu": 1000},
            gvk="apps/v1/Deployment", prev={"p1": 2}, evict_clusters=("p0",))
            for i in range(500)]

    eng, _, res = both(build)
    assert eng.solve_batches == 1
    assert all(r.success and "p0" not in r.clusters for r in res)


def test_multi_term_with_spread_keeps_round_loop_beside_ranked_rows():
    """One batch holding ranked rows, multi-term rows with spread (the round
    loop) and single-term rows: the legacy split, as in JAX."""
    def build(pkg):
        api = mod(pkg, "api")
        b = mod(pkg, "utils.builders")
        clusters = [b.new_cluster(f"s{i}", cpu="64", memory="400Gi",
                                  labels={"group": "primary" if i < 4 else "fallback"},
                                  region=f"r{i % 2}") for i in range(8)]
        snap = mod(pkg, "scheduler").ClusterSnapshot(sorted(clusters, key=lambda c: c.name))
        terms = [group_term(pkg, "primary"), group_term(pkg, "fallback")]
        spread = b.dynamic_weight_placement(
            cluster_affinities=list(terms),
            spread_constraints=[api.SpreadConstraint(spread_by_field="region",
                                                     min_groups=2, max_groups=2)])
        ranked = b.dynamic_weight_placement(cluster_affinities=list(terms))
        single = b.aggregated_placement()
        s = mod(pkg, "scheduler")
        probs = [s.BindingProblem(key=f"x{i}", placement=(spread, ranked, single)[i % 3],
                                  replicas=4 + (i % 5) * 40, requests={"cpu": 1000},
                                  gvk="apps/v1/Deployment") for i in range(24)]
        return snap, probs

    _, _, res = both(build)
    assert any(r.affinity_name == "grp-fallback" for r in res)


@pytest.mark.parametrize("route", ["tiny", "general"])
def test_ranked_rows_under_quota_caps(route):
    """Ranked rows in a namespace whose static assignments cap the primary
    group: the selection ranks groups on cap-folded availability, as the
    divide sees it (``_availability``'s cap rows on the general route, the
    numpy mirror on the tiny-batch route)."""
    n_rows = 6 if route == "tiny" else 300

    def build(pkg):
        snap = grouped_snapshot(pkg, 3, 3, "64", "64", pods=100_000)
        b = mod(pkg, "utils.builders")
        pl = b.dynamic_weight_placement(
            cluster_affinities=[group_term(pkg, "primary"), group_term(pkg, "fallback")])
        s = mod(pkg, "scheduler")
        return snap, [s.BindingProblem(
            key=f"q{i}", placement=pl, replicas=5 + (i % 7) * 4, requests={"cpu": 1000},
            gvk="apps/v1/Deployment", namespace=("capped", "free")[i % 2],
            prev={"p0": 2} if i % 4 == 0 else {}) for i in range(n_rows)]

    def quota(pkg, snap):
        pol, core = mod(pkg, "api.policy"), mod(pkg, "api.core")
        frqs = [pol.FederatedResourceQuota(
            meta=core.ObjectMeta(name="q", namespace=ns),
            spec=pol.FederatedResourceQuotaSpec(
                overall={"cpu": 10**12},
                static_assignments=[pol.StaticClusterAssignment(
                    cluster_name=f"p{k}", hard={"cpu": 4000}) for k in range(3)]
                if ns == "capped" else []))
            for ns in ("capped", "free")]
        return mod(pkg, "scheduler").build_quota_snapshot(frqs, snap, 1)

    outs = []
    for pkg in PKGS:
        snap, probs = build(pkg)
        eng = engine(pkg, snap, chunk_size=1024)
        eng.set_quota(quota(pkg, snap))
        res = eng.schedule(probs)
        outs.append(outcome(res))
    assert outs[1] == outs[0]
    assert chip_smoke.ranked_referent(eng, probs, res) == 0
    capped = [r for p, r in zip(probs, res) if p.namespace == "capped"]
    free = [r for p, r in zip(probs, res) if p.namespace == "free"]
    # the caps push capped rows that a free row of the same size keeps on
    # the primary group onto the fallback
    assert any(r.affinity_name == "grp-fallback" for r in capped)
    assert all(r.affinity_name == "grp-primary" for r in free if r.success)
    # 4 cpus on each of 3 primary clusters, beside the credited previous
    # replicas
    assert all(sum(v for k, v in r.clusters.items() if k.startswith("p"))
               <= 12 + sum(p.prev.values())
               for p, r in zip(probs, res) if p.namespace == "capped")


def test_ranked_phase_rehearses_on_cpu_and_equals_jax(capsys):
    """chip_smoke's ranked phase on the CPU at a small size, and the JAX
    engine on the same workload and quota answers the same."""
    cpu = torch.device("cpu")
    out = chip_smoke.run_ranked(cpu, "cpu", bindings=900, clusters=2000)
    assert out["fallback"] > 0
    assert " 0 bad" in capsys.readouterr().out
    outs = []
    for pkg in PKGS:
        snap, problems = chip_smoke.ranked_workload(pkg, 600, 2000)
        limits = {ns: dict(chip_smoke.GENEROUS) for ns in chip_smoke.RANKED_NAMESPACES}
        eng = engine(pkg, snap, chunk_size=4096)
        eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
            chip_smoke.quota_frqs(pkg, snap, limits, caps=chip_smoke.ranked_caps(snap)),
            snap, 1))
        outs.append(outcome(eng.schedule(problems)))
    assert outs[1] == outs[0]
    assert len({o[3] for o in outs[1] if not o[2]}) >= 2  # primary and a fallback
