"""The preemption plane of the port against the JAX package, on the CPU.

- K15's plain version (``karmada_tpu_torch.ops.preempt_select`` on CPU
  tensors) against the JAX ``preempt_select`` and the sequential referent
  ``select_victims_np`` of both packages, on seeded rows: random priority
  classes, equal priorities, weight ties, all-pad rows, and values that
  wrap the int64 freed-capacity product; the hand cases of
  tests/test_preemption.py's kernel tests; the row bound;
- the port's engine against the JAX engine with the same victim source:
  ``last_preemption`` (victims, placed, still unschedulable, freed_caps)
  and the results, in the cases of tests/test_preemption.py's engine tests
  (the same-pass re-solve, priority 0 never demands, no eligible victims,
  a quota-denied row never preempts, the boosted re-solve keeps static
  caps, ranked demanders whose boosted re-solve selects a fallback
  ClusterAffinities group), on the fleet route too, with the provenance capture after the
  re-solve, and on the error paths (a source that raises, a pool over
  2^17 rows) that must leave the results intact and no outcome.

Tolerance: exact equality (integer outputs)."""

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.utils.builders  # noqa: F401
from karmada_tpu.ops.preempt import preempt_select as jax_preempt_select
from karmada_tpu.refimpl.preempt_np import select_victims_np as jax_select_np

import karmada_tpu_torch
import karmada_tpu_torch.scheduler as TS
import karmada_tpu_torch.utils.builders  # noqa: F401
from karmada_tpu_torch.ops import preempt as TP
from karmada_tpu_torch.ops.quota import MAX_ADMIT_ROWS
from karmada_tpu_torch.refimpl.preempt_np import (
    preempt_and_place_np,
    rebalance_np,
    select_victims_np,
)

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)


def mod(pkg, name):
    return __import__(f"{pkg.__name__}.{name}", fromlist=["x"])


# --------------------------------------------------------------------------
# K15's plain version against the JAX program and the referent
# --------------------------------------------------------------------------


def random_rows(rng, b, r, c, classes=5, weight_ties=False):
    prio = rng.integers(0, classes, b).astype(np.int32)
    demand = np.zeros((b, r), np.int64)
    freed = np.zeros((b, r), np.int64)
    victim_ok = np.zeros(b, bool)
    weight = np.zeros(b, np.int32)
    assigned = np.zeros((b, c), np.int32)
    requests = rng.integers(0, 8, (b, r)).astype(np.int64)
    for i in range(b):
        role = rng.integers(0, 3)
        if role == 0 and prio[i] > 0:
            demand[i] = rng.integers(0, 24, r)
        elif role == 1:
            assigned[i] = 1 if weight_ties else rng.integers(0, 4, c)
            weight[i] = assigned[i].sum()
            victim_ok[i] = weight[i] > 0
            freed[i] = int(weight[i]) * requests[i]
    return prio, demand, freed, victim_ok, weight, assigned, requests


def port(rows, b_key=None):
    v, caps = TP.preempt_select(*(torch.from_numpy(np.ascontiguousarray(a)) for a in rows),
                                b_key=b_key)
    return v.numpy(), caps.numpy()


def check_rows(rows, referent=True):
    v, caps = port(rows)
    jv, jcaps = jax_preempt_select(*rows)
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(caps, np.asarray(jcaps))
    if referent:
        prio, demand, freed, victim_ok, weight, _a, _r = rows
        want = select_victims_np(prio, demand, freed, victim_ok, weight)
        assert v.tolist() == want == jax_select_np(prio, demand, freed, victim_ok, weight)
    return v, caps


@pytest.mark.parametrize("seed", range(6))
def test_plain_equals_jax_and_referent(seed):
    rng = np.random.default_rng(seed)
    selected = 0
    for _ in range(25):
        # a few shapes, so the JAX program compiles a few times
        b = int(rng.choice((8, 24, 40, 63)))
        rows = random_rows(rng, b, int(rng.integers(1, 4)), int(rng.choice((1, 3, 7))),
                           classes=int(rng.integers(1, 6)), weight_ties=bool(seed % 2))
        v, caps = check_rows(rows)
        want = np.zeros_like(caps)
        for i in np.flatnonzero(v):
            want += rows[5][i][:, None].astype(np.int64) * rows[6][i]
        np.testing.assert_array_equal(caps, want)
        selected += int(v.sum())
    assert selected > 10


def test_padded_rows_are_inert():
    """The engine pads to a power of two with all-zero rows: they select
    nothing and free nothing, and the real rows answer as unpadded."""
    rows = random_rows(np.random.default_rng(11), 21, 3, 5)
    padded = tuple(np.pad(a, ((0, 256 - 21),) + ((0, 0),) * (a.ndim - 1)) for a in rows)
    v, caps = check_rows(padded)
    assert not v[21:].any()
    v21, caps21 = port(rows)
    assert v21.tolist() == v[:21].tolist()
    all_pad = tuple(np.zeros_like(a) for a in padded)
    v0, caps0 = check_rows(all_pad)
    assert not v0.any() and not caps0.any()


def hand_wrap_rows():
    """A prio-2^30 demander short of one victim's worth; victims of prio
    2^29 (row 1) and 1 (row 2). At a key width of 2^17 the first one's
    packed key wraps to below the second one's, so it is taken first."""
    return (np.array([1 << 30, 1 << 29, 1], np.int32), np.array([[10], [0], [0]]),
            np.array([[0], [10], [10]]), np.array([False, True, True]),
            np.array([0, 1, 1], np.int32), np.array([[0], [1], [1]], np.int32),
            np.full((3, 1), 10, np.int64))


@pytest.mark.parametrize("case", ("random", "wrapping"))
def test_key_width_replaces_padding(case):
    """The engine passes its real rows and JAX's padded row count as
    ``b_key``: the answer equals the JAX program on the padded rows, also
    where a priority wraps the packed victim key (whose order then depends
    on the padded count)."""
    if case == "random":
        rows, width = random_rows(np.random.default_rng(13), 37, 2, 6, classes=4), 256
    else:
        rows, width = hand_wrap_rows(), MAX_ADMIT_ROWS
    b = len(rows[0])
    padded = tuple(np.pad(a, ((0, width - b),) + ((0, 0),) * (a.ndim - 1)) for a in rows)
    jv, jcaps = jax_preempt_select(*padded)
    v, caps = port(rows, b_key=width)
    np.testing.assert_array_equal(v, np.asarray(jv)[:b])
    np.testing.assert_array_equal(caps, np.asarray(jcaps))
    assert v.any()
    if case == "wrapping":
        # the unpadded key does not wrap: the other victim is taken
        assert v.tolist() == [False, True, False]
        assert port(rows)[0].tolist() == [False, False, True]


ROW_ARGS = ("prio", "demand", "freed", "victim_ok", "weight", "assigned", "requests")


@pytest.mark.parametrize("case", chip_smoke.PREEMPT_EDGE_CASES)
def test_preempt_select_edge_cases_equal_jax(case):
    """``chip_smoke.preempt_edge_batch``, the batches K15 is held to on the
    card: no victims, no demanders, all keys equal, priorities at and past
    2^20 (the wrapping key) and negative, b_key above B, B = 1 and 2^17,
    weights below 0 and above MAX_WEIGHT, rows that free nothing, R = 1,
    16, 17 and 40. The plain version equals the JAX program on the rows
    padded to b_key (JAX's own padding), victims and freed capacity."""
    a = chip_smoke.preempt_edge_batch(case)
    b_key = a.pop("b_key")
    rows = tuple(a[k] for k in ROW_ARGS)
    b = len(rows[0])
    width = b_key or b
    padded = tuple(np.pad(x, ((0, width - b),) + ((0, 0),) * (x.ndim - 1)) for x in rows)
    jv, jcaps = jax_preempt_select(*padded)
    v, caps = port(rows, b_key=b_key)
    np.testing.assert_array_equal(v, np.asarray(jv)[:b])
    np.testing.assert_array_equal(caps, np.asarray(jcaps))
    if case in ("no_victims", "no_demanders", "equal_keys", "b1"):
        assert not v.any() and not caps.any()
    else:
        assert v.any()
    if case == "nothing_freed":
        assert not v[~rows[2].any(axis=1)].any()


def test_equal_priorities_never_displace():
    """Demanders and residents of one class: nothing is selected."""
    rng = np.random.default_rng(2)
    prio, demand, freed, victim_ok, weight, assigned, requests = random_rows(rng, 40, 2, 4)
    prio[:] = 7
    v, _ = check_rows((prio, demand, freed, victim_ok, weight, assigned, requests))
    assert not v.any()


def test_wrapping_product_equals_jax():
    """Requests at the 2^44 clamp times assignments near 2^31 wrap the int64
    freed-capacity sum in JAX; the port wraps the same way. Priorities above
    2^20 wrap the packed victim key: the same key, not a repaired one."""
    rng = np.random.default_rng(5)
    rows = list(random_rows(rng, 48, 2, 3))
    rows[6] = np.full((48, 2), 2**44, np.int64)
    rows[5] = np.where(rows[3][:, None], 2**31 - 1 - rng.integers(0, 9, (48, 3)), 0).astype(np.int32)
    _v, caps = check_rows(tuple(rows), referent=False)
    assert (caps < 0).any()
    rows[0] = (rows[0].astype(np.int64) * (1 << 21) + 3).astype(np.int32)
    check_rows(tuple(rows), referent=False)


def test_hand_cases():
    # equal or higher priority is immune: prio 5 and 7 victims survive
    v, _ = check_rows((np.array([5, 5, 7, 4], np.int32), np.array([[10], [0], [0], [0]]),
                       np.array([[0], [50], [50], [50]]), np.array([False, True, True, True]),
                       np.array([0, 5, 5, 5], np.int32), np.array([[0], [5], [5], [5]], np.int32),
                       np.full((4, 1), 10)))
    assert v.tolist() == [False, False, False, True]
    # the largest-weight victim alone covers the demand
    v, caps = check_rows((np.array([3, 0, 0, 0], np.int32), np.array([[6], [0], [0], [0]]),
                          np.array([[0], [3], [6], [3]]), np.array([False, True, True, True]),
                          np.array([0, 3, 6, 3], np.int32), np.array([[0], [3], [6], [3]], np.int32),
                          np.ones((4, 1), np.int64)))
    assert v.tolist() == [False, False, True, False] and int(caps[0, 0]) == 6
    # a prio-6 victim serves only the prio-10 demand, already covered
    v, _ = check_rows((np.array([10, 5, 1, 6], np.int32), np.array([[5], [5], [0], [0]]),
                       np.array([[0], [0], [5], [5]]), np.array([False, False, True, True]),
                       np.array([0, 0, 5, 5], np.int32), np.array([[0], [0], [5], [5]], np.int32),
                       np.ones((4, 1), np.int64)))
    assert v.tolist() == [False, False, True, False]


def test_row_bound_and_cpu_path():
    rows = random_rows(np.random.default_rng(1), 8, 2, 3)
    before = TP.preempt_select.launches
    port(rows)
    assert TP.preempt_select.launches == before
    big = tuple(np.zeros((MAX_ADMIT_ROWS + 1,) + a.shape[1:], a.dtype) for a in rows)
    with pytest.raises(ValueError):
        port(big)
    v, _ = port(tuple(np.zeros((MAX_ADMIT_ROWS,) + a.shape[1:], a.dtype) for a in rows))
    assert v.shape == (MAX_ADMIT_ROWS,) and not v.any()
    # the key width is bounded as the rows are, and covers them
    with pytest.raises(ValueError):
        port(rows, b_key=MAX_ADMIT_ROWS + 1)
    with pytest.raises(ValueError):
        port(rows, b_key=7)
    with pytest.raises(ValueError):
        TP.preempt_select(*(torch.from_numpy(np.ascontiguousarray(a)).to("meta") for a in rows))


def test_rebalance_referent_copy_equals_jax():
    from karmada_tpu.refimpl.preempt_np import rebalance_np as jax_rebalance

    rng = np.random.default_rng(3)
    names = [f"m{j}" for j in range(6)]
    keys = [f"k{i}" for i in range(10)]
    kw = dict(
        names=names,
        current={k: {names[int(rng.integers(0, 6))]: 3} for k in keys},
        candidates={k: rng.random(6) < 0.7 for k in keys},
        strategies={k: 2 for k in keys},
        replicas={k: 3 for k in keys},
        avail={k: rng.integers(0, 5, 6).astype(np.int32) for k in keys},
        budget=4,
    )
    assert rebalance_np(keys, **kw) == jax_rebalance(keys, **kw)


# --------------------------------------------------------------------------
# the engine against the JAX engine
# --------------------------------------------------------------------------


def saturated(pkg, c=2, cap_cpu=4):
    b = mod(pkg, "utils.builders")
    return [b.new_cluster(f"m{i}", cpu=str(cap_cpu), memory="100Gi",
                          allocated={"cpu": str(cap_cpu)}) for i in range(c)]


def demander(pkg, key, replicas=4, prio=100, ns="", placement=None):
    return mod(pkg, "scheduler").BindingProblem(
        key=key, placement=placement or mod(pkg, "utils.builders").dynamic_weight_placement(),
        replicas=replicas, requests={"cpu": 1000}, gvk="apps/v1/Deployment",
        namespace=ns, priority=prio)


def resident(pkg, key, prev, prio=0, placement=None):
    return mod(pkg, "scheduler").BindingProblem(
        key=key, placement=placement or mod(pkg, "utils.builders").dynamic_weight_placement(),
        replicas=sum(prev.values()), requests={"cpu": 1000}, gvk="apps/v1/Deployment",
        prev=dict(prev), priority=prio)


def outcome(results):
    return [(r.key, dict(r.clusters), r.error, r.affinity_name) for r in results]


def verdict(o):
    if o is None:
        return None
    return (o.victims, o.placed, o.still_unschedulable,
            None if o.freed_caps is None else o.freed_caps.tolist())


def both(clusters_fn, source_fn, problems_fn, quota_fn=None, route="tiny", explain=False):
    """Run the same wave through one engine per package with the same victim
    source; assert equal results and equal outcomes; return the port's
    (results, outcome, engine, store)."""
    outs = []
    for pkg in PKGS:
        snap = mod(pkg, "scheduler").ClusterSnapshot(clusters_fn(pkg))
        eng = (JS.TensorScheduler(snap, trace_manifest="") if pkg is karmada_tpu
               else TS.TensorScheduler(snap, device="cpu"))
        if route == "general":
            eng.fleet_threshold = 10**9
        if quota_fn is not None:
            eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
                quota_fn(pkg), snap, generation=1))
        store = None
        if explain:
            store = mod(pkg, "utils.explainstore").ExplainStore(cap=4)
            eng.set_explain(store)
        eng.set_preemption(source_fn(pkg))
        res = eng.schedule(problems_fn(pkg))
        caps = None if store is None else [
            (c.uniq_masks[c.mask_inv].tolist(), c.topk.tolist(), c.errors)
            for c in store.captures()]
        outs.append((outcome(res), verdict(eng.last_preemption), caps, res, eng, store))
    assert outs[1][:3] == outs[0][:3]
    return outs[1][3:]


def pool_of(pkg, n=4, prev=None, prio=0):
    placement = mod(pkg, "utils.builders").dynamic_weight_placement()
    return [resident(pkg, f"v{i}", prev or {"m0": 1, "m1": 1}, prio, placement)
            for i in range(n)]


def test_same_pass_resolve():
    res, eng, _ = both(saturated, lambda pkg: (lambda exclude, p=pool_of(pkg): p),
                       lambda pkg: [demander(pkg, "hi", replicas=4)])
    out = eng.last_preemption
    assert res[0].success and sum(res[0].clusters.values()) == 4
    assert len(out.victims) == 2 and out.placed == ["hi"] and out.freed_caps.sum() > 0


def test_disarmed_and_priority_zero():
    res, eng, _ = both(saturated, lambda pkg: None, lambda pkg: [demander(pkg, "hi")])
    assert res[0].error == TS.INSUFFICIENT_ERROR and eng.last_preemption is None
    calls = []
    res, eng, _ = both(saturated, lambda pkg: (lambda exclude: calls.append(1) or []),
                       lambda pkg: [demander(pkg, "lo", prio=0)])
    assert res[0].error == TS.INSUFFICIENT_ERROR and not calls


def test_no_eligible_victims_stays_unschedulable():
    res, eng, _ = both(saturated,
                       lambda pkg: (lambda ex, p=pool_of(pkg, 1, {"m0": 2, "m1": 2}, 100): p),
                       lambda pkg: [demander(pkg, "hi", prio=100)])
    assert res[0].error == TS.INSUFFICIENT_ERROR
    assert eng.last_preemption.victims == [] and eng.last_preemption.still_unschedulable == ["hi"]
    res, eng, _ = both(saturated, lambda pkg: (lambda ex: []),
                       lambda pkg: [demander(pkg, "hi")])
    assert eng.last_preemption.still_unschedulable == ["hi"]


def frq(pkg, overall, static=()):
    api = mod(pkg, "api.policy")
    return api.FederatedResourceQuota(
        meta=mod(pkg, "api.core").ObjectMeta(name="q", namespace="a"),
        spec=api.FederatedResourceQuotaSpec(
            overall=overall, static_assignments=[
                api.StaticClusterAssignment(cluster_name=c, hard=h) for c, h in static]))


def test_quota_denied_row_never_preempts():
    calls = []
    res, eng, _ = both(saturated, lambda pkg: (lambda ex: calls.append(1) or pool_of(pkg)),
                       lambda pkg: [demander(pkg, "a/hi", ns="a")],
                       quota_fn=lambda pkg: [frq(pkg, {"cpu": 0})])
    assert res[0].error == TS.QUOTA_EXCEEDED_ERROR and not calls


def test_boosted_resolve_keeps_static_caps():
    res, eng, _ = both(saturated,
                       lambda pkg: (lambda ex, p=pool_of(pkg, 2, {"m0": 2, "m1": 2}): p),
                       lambda pkg: [demander(pkg, "a/hi", replicas=2, ns="a")],
                       quota_fn=lambda pkg: [frq(pkg, {"cpu": 1 << 40}, [("m0", {"cpu": 0})])])
    assert res[0].success and "m0" not in res[0].clusters


def test_failing_source_keeps_the_results():
    def source(pkg):
        def boom(exclude):
            raise RuntimeError("victim pool unavailable")
        return boom

    res, eng, _ = both(saturated, source, lambda pkg: [demander(pkg, "hi")])
    assert res[0].error == TS.INSUFFICIENT_ERROR and eng.last_preemption is None


def test_pool_over_the_row_bound_never_preempts():
    """More rows than MAX_ADMIT_ROWS (one demander + 2^17 residents pad to
    2^18): JAX's assert inside the call fails, schedule() swallows it, and
    the demander stays unschedulable with no outcome. The port raises at
    the same bound and answers the same (a fault of the reference, kept)."""
    pools = {pkg: pool_of(pkg, MAX_ADMIT_ROWS) for pkg in PKGS}
    res, eng, _ = both(saturated, lambda pkg: (lambda ex: pools[pkg]),
                       lambda pkg: [demander(pkg, "hi", replicas=2)])
    assert res[0].error == TS.INSUFFICIENT_ERROR and eng.last_preemption is None


def tiered(pkg, c=6):
    """Six saturated 4-cpu clusters in three label groups: m0/m1 "a",
    m2/m3 "b", m4/m5 "c"."""
    b = mod(pkg, "utils.builders")
    return [b.new_cluster(f"m{i}", cpu="4", memory="100Gi", allocated={"cpu": "4"},
                          labels={"group": "abc"[i // 2]}) for i in range(c)]


def ranked_placement(pkg, groups):
    api = mod(pkg, "api")
    return mod(pkg, "utils.builders").dynamic_weight_placement(cluster_affinities=[
        api.ClusterAffinityTerm(affinity_name=f"grp-{g}",
                                label_selector=api.LabelSelector(match_labels={"group": g}))
        for g in groups])


def test_boosted_resolve_selects_ranked_groups():
    """Surge rows with two and three ClusterAffinities terms: the boosted
    re-solve's group selection (K17's plain version on the CPU) runs with
    T = 2 and 3 over capacity the victims free only on later groups, and
    the placements, affinity names and the verdict equal the JAX
    engine's."""
    def problems(pkg):
        return [demander(pkg, "two", replicas=2, placement=ranked_placement(pkg, "ab")),
                demander(pkg, "three", replicas=2, placement=ranked_placement(pkg, "acb")),
                demander(pkg, "wide", replicas=3, placement=ranked_placement(pkg, "abc"))]

    def source(pkg):
        pool = [resident(pkg, f"v{i}", {f"m{2 + i % 4}": 1}) for i in range(8)]
        return lambda exclude: [p for p in pool if p.key not in exclude]

    res, eng, _ = both(tiered, source, problems)
    out = eng.last_preemption
    assert out is not None and out.victims and out.placed
    by = {r.key: r for r in res}
    placed = [by[k] for k in out.placed]
    # no victim frees group a: every placed row sits on a fallback group
    assert placed and all(r.affinity_name != "grp-a" for r in placed)
    assert all(not any(c in r.clusters for c in ("m0", "m1")) for r in placed)


def wide(pkg, c=40):
    b = mod(pkg, "utils.builders")
    return [b.new_cluster(f"m{i}", cpu="200", memory="4000Gi", pods=10**6,
                          allocated={"cpu": "200"}) for i in range(c)]


@pytest.mark.parametrize("route", ("general", "fleet"))
def test_wave_with_residents_and_explain(route):
    """300 rows in one wave over 40 clusters (the fleet route engages at 256
    eligible rows and answers a lazy result list that the pass
    materialises), priorities 0 / 50 / 100 among demanders, residents at 0
    and 50 with weight ties, one resident carrying a preemption task; the
    provenance capture runs after the re-solve and shows the final
    placements."""
    def problems(pkg):
        b = mod(pkg, "utils.builders")
        S = mod(pkg, "scheduler")
        out = []
        for i in range(300):
            out.append(S.BindingProblem(
                key=f"w{i}", placement=b.dynamic_weight_placement(),
                replicas=2 + i % 3, requests={"cpu": 500 + 250 * (i % 2)},
                gvk="apps/v1/Deployment", priority=(0, 50, 100)[i % 3],
                prev={f"m{(i * 7) % 40}": 1} if i % 5 == 0 else {},
                preempt_clusters=(f"m{(i * 7) % 40}",) if i == 5 else ()))
        return out

    def source(pkg):
        pool = [resident(pkg, f"r{i}", {f"m{i % 40}": 1 + i % 2, f"m{(i + 3) % 40}": 1},
                         prio=(0, 50)[i % 2]) for i in range(200)]
        return lambda exclude: [p for p in pool if p.key not in exclude]

    res, eng, store = both(wide, source, problems, route=route, explain=True)
    assert (eng._fleet is not None) == (route == "fleet")
    out = eng.last_preemption
    assert out is not None and out.victims and out.placed
    placed = {r.key: r for r in res if r.key in set(out.placed)}
    cap_rows = {k: i for c in store.captures() for i, k in enumerate(c.keys)}
    assert set(placed) <= set(cap_rows)
    for key, r in placed.items():
        assert store.explain_binding(key)["assignment"] == r.clusters


def test_preemption_phase_rehearsal_on_cpu():
    """chip_smoke's preemption phase at a small size: residents placed by a
    cold pass, the fleet saturated exactly, a priority-100 surge whose
    victims and placements equal ``preempt_and_place_np``."""
    out = chip_smoke.run_preemption(torch.device("cpu"), "cpu", residents=1200,
                                    clusters=80, surge=20)
    assert out["victims"] > 0 and out["placed"] > 0
    assert out["rows"] == 1220 and out["padded"] == 2048


def test_preempt_and_place_referent_copy():
    names = ["m0", "m1"]
    common = dict(names=names, assigned={"v0": {"m0": 2}, "v1": {"m1": 2}},
                  requests={k: np.array([1000, 0], np.int64) for k in ("hi", "v0", "v1")},
                  base_caps=np.zeros((2, 2), np.int64), demanders=["hi"],
                  candidates={"hi": np.ones(2, bool)}, strategies={"hi": 2},
                  replicas={"hi": 2}, prev={})
    from karmada_tpu.refimpl.preempt_np import preempt_and_place_np as jax_place

    args = (["hi", "v0", "v1"], [100, 0, 0], np.array([[2000, 0], [0, 0], [0, 0]]),
            np.array([[0, 0], [2000, 0], [2000, 0]]), [False, True, True], [0, 2, 2])
    got = preempt_and_place_np(*args, **common)
    assert got == jax_place(*args, **common) and got[0] == ["v0"]
