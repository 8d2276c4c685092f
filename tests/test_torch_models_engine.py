"""The port's engine against the JAX engine with the estimators active:
resource models (the CustomizedClusterResourceModeling gate, on by
default) on the fleet route, the host general route and the tiny-batch
numpy path, and the node-level accurate estimator through
``extra_estimators``. Both packages build the same workloads from the same
seeds; every result must agree on key, placed clusters, error, affinity
name and feasible set. Tolerance: exact equality (integer placements).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import karmada_tpu
import karmada_tpu.api.cluster as JC
import karmada_tpu.estimator.accurate as JA
import karmada_tpu.scheduler as JS
import karmada_tpu.utils.builders as JB
from karmada_tpu.models.modeling import estimate_by_models as jax_by_models
from karmada_tpu.utils import features as JF

import karmada_tpu_torch
import karmada_tpu_torch.api.cluster as TC
import karmada_tpu_torch.estimator.accurate as TA
import karmada_tpu_torch.scheduler as TS
import karmada_tpu_torch.utils.builders as TB
from karmada_tpu_torch.models import modeling as TM
from karmada_tpu_torch.utils import features as TF

import chip_smoke

def outcome(results):
    return [(r.key, dict(r.clusters), r.error, r.affinity_name, tuple(r.feasible))
            for r in results]


def engines(sj, st, route):
    je = JS.TensorScheduler(sj)
    te = TS.TensorScheduler(st, device="cpu")
    if route == "host":
        je.fleet_threshold = te.fleet_threshold = 10**9
    return je, te


def test_config3_equals_jax_and_oracle():
    """BASELINE config 3 in full (100 x 20, three grades, Aggregated): the
    tiny-batch numpy path over the model-aware host table, as in JAX."""
    sj, pj = chip_smoke.build_workload(karmada_tpu, 3)
    st, pt = chip_smoke.build_workload(karmada_tpu_torch, 3)
    je, te = engines(sj, st, "fleet")
    got = te.schedule(pt)
    assert outcome(got) == outcome(je.schedule(pj))
    assert te._models_active() and te._fleet is None
    assert sum(r.success for r in got) == 100
    assert chip_smoke.oracle_check(te, pt, got) == 0


@pytest.mark.parametrize("route", ["fleet", "host"])
def test_config5_default_models_equals_jax(route):
    """Config 5 at 512 x 256 with the nine default grades on every cluster
    and seeded allocatable modelings: on the fleet route (K1 table form +
    K7 overlay, the avail-max bound read from that device table) and
    on the host general route (K1 merge form), with a churn pass."""
    sj, pj = chip_smoke.build_workload(karmada_tpu, 5, 512, 256, models=True)
    st, pt = chip_smoke.build_workload(karmada_tpu_torch, 5, 512, 256, models=True)
    je, te = engines(sj, st, route)
    got = te.schedule(pt)
    assert outcome(got) == outcome(je.schedule(pj))
    assert (te._fleet is not None) == (route == "fleet")
    if route == "fleet":
        assert te._fleet._avail_max == je._fleet._avail_max
    assert chip_smoke.oracle_check(te, pt, got) == 0
    # churn: every cluster's allocation drifts (the models stay)
    dj = chip_smoke.drift_snapshots(karmada_tpu, sj, 1)[0]
    dt = chip_smoke.drift_snapshots(karmada_tpu_torch, st, 1)[0]
    assert je.update_snapshot(dj) and te.update_snapshot(dt)
    assert outcome(te.schedule(pt)) == outcome(je.schedule(pj))


def no_summary_fleet(pkg_api, pkg_builders, big_counts: bool):
    """40 clusters: models on three in four; every fourth has models and no
    summary; with ``big_counts`` the grade counts make model answers far
    above the summary answers."""
    rng = np.random.default_rng(3)
    fleet = pkg_builders.synthetic_fleet(40, seed=12)
    for i, cl in enumerate(fleet):
        if i % 4 == 3:
            continue
        cl.spec.resource_models = pkg_api.default_resource_models()
        hi = 5000 if big_counts else 6
        cl.status.resource_summary.allocatable_modelings = [
            pkg_api.AllocatableModeling(grade=g, count=int(n))
            for g, n in enumerate(rng.integers(0, hi, 9))
        ]
        if i % 4 == 1:
            cl.status.resource_summary.allocatable = {}
            cl.status.resource_summary.allocated = {}
    return fleet


@pytest.mark.parametrize("route", ["fleet", "host"])
@pytest.mark.parametrize("big_counts", [False, True])
def test_models_without_summary_and_above_summary(route, big_counts):
    """Clusters with models and no summary answer -1 (the merge ignores
    them), and model answers above the summary answers widen the avail-max
    bound that picks K2's variant: both engines agree on placements and on
    the bound."""
    fj = no_summary_fleet(JC, JB, big_counts)
    ft = no_summary_fleet(TC, TB, big_counts)
    pj = chip_smoke.mixed_problems(karmada_tpu, fj, 400, 8)
    pt = chip_smoke.mixed_problems(karmada_tpu_torch, ft, 400, 8)
    sj, st = JS.ClusterSnapshot(fj), TS.ClusterSnapshot(ft)
    je, te = engines(sj, st, route)
    got = te.schedule(pt)
    assert outcome(got) == outcome(je.schedule(pj))
    assert (te._fleet is not None) == (route == "fleet")
    assert chip_smoke.oracle_check(te, pt, got) == 0
    uniq = np.unique(te._pack_chunk(pt, [te._compiled(p.placement) for p in pt], 0)[4], axis=0)
    with_m = TS.host_profile_table(st, uniq, models_active=True)
    without = TS.host_profile_table(st, uniq, models_active=False)
    assert (with_m != without).any()
    if big_counts:
        assert (with_m > without).any()
    if route == "fleet":
        # the bound over the fleet's own profiles sees the models: a mirror
        # without the model branch would give another bound
        assert te._fleet._avail_max == je._fleet._avail_max
        profs = np.stack(te._fleet._profiles)
        general = TS.host_profile_table(st, profs, models_active=False)
        assert te._fleet._avail_max != general[general != 2**31 - 1].max()


def test_gate_off_ignores_models():
    """With CustomizedClusterResourceModeling off, both engines answer from
    the summaries alone, as on a fleet without models."""
    sj, pj = chip_smoke.build_workload(karmada_tpu, 5, 300, 256, models=True)
    st, pt = chip_smoke.build_workload(karmada_tpu_torch, 5, 300, 256, models=True)
    s0, p0 = chip_smoke.build_workload(karmada_tpu_torch, 5, 300, 256)
    gate = TF.CUSTOMIZED_CLUSTER_RESOURCE_MODELING
    JF.feature_gate.set(JF.CUSTOMIZED_CLUSTER_RESOURCE_MODELING, False)
    TF.feature_gate.set(gate, False)
    try:
        je, te = engines(sj, st, "fleet")
        assert not te._models_active()
        got = te.schedule(pt)
        assert outcome(got) == outcome(je.schedule(pj))
        plain = TS.TensorScheduler(s0, device="cpu").schedule(p0)
        assert outcome(got) == outcome(plain)
    finally:
        JF.feature_gate.set(JF.CUSTOMIZED_CLUSTER_RESOURCE_MODELING, True)
        TF.feature_gate.set(gate, True)
    assert TS.TensorScheduler(st, device="cpu")._models_active()


class Counted:
    """Counts an estimator's fetches."""

    def __init__(self, est):
        self.calls = 0
        inner = est.max_available_replicas

        def counted(*a):
            self.calls += 1
            return inner(*a)

        est.max_available_replicas = counted


def test_registry_extra_estimators_equal_jax():
    """The port's registry-fed ``extra_estimators`` against the JAX engine
    with the JAX registry over the same NodeStates (chip_smoke's estimator
    workload at 6 clusters, 5 served, of 2100 nodes): a cold pass, the
    steady replay (same results, no fetch) and a pod event plus
    ``invalidate()`` (only the moved cluster re-fetches). 8 profiles x 2100
    nodes exceed the 2^14 host rule, so the node sum takes K8's path (its
    plain version here)."""
    runs, counters = {}, {}
    for key, pkg, kw in (("j", karmada_tpu, {}), ("t", karmada_tpu_torch, {"device": "cpu"})):
        acc = JA if key == "j" else TA
        sched = JS if key == "j" else TS
        snap, nodes, problems = chip_smoke.estimator_workload(pkg, 6, 2100, 300)
        reg = acc.EstimatorRegistry()
        for name in snap.names[:5]:  # the sixth is unserved
            est = acc.AccurateEstimator(name, acc.NodeCache(snap.dims, nodes[name]), **kw)
            counters[key, name] = Counted(est)
            reg.register(est)
        batch = reg.make_batch_estimator(snap.names)
        runs[key] = (reg, batch, sched.TensorScheduler(snap, extra_estimators=[batch], **kw),
                     problems, snap)
    st, pt = runs["t"][4], runs["t"][3]

    def run():
        return tuple(outcome(runs[k][2].schedule(runs[k][3])) for k in ("j", "t"))

    def calls(key):
        return [counters[key, n].calls for n in st.names[:5]]

    want, got = run()
    assert got == want
    assert calls("t") == [1] * 5 and calls("j") == [1] * 5
    assert runs["t"][2]._fleet is None and not runs["t"][1].unanswered
    assert runs["t"][0]._memo == runs["j"][0]._memo
    # the node sums bind somewhere: the general answer alone places otherwise
    general = TS.TensorScheduler(st, device="cpu")
    general.fleet_threshold = 10**9
    assert outcome(general.schedule(pt)) != got
    # steady replay: same results, no fetch
    assert run() == (want, got)
    assert calls("t") == [1] * 5
    # a pod event on one cluster, then a generation-gated invalidate
    moved = st.names[2]
    for key in ("j", "t"):
        reg = runs[key][0]
        reg.get(moved).snapshot.add_pod("n0", {"cpu": 4000, "memory": 8 << 30})
        reg.invalidate()
    want3, got3 = run()
    assert got3 == want3
    assert calls("t") == [1, 1, 2, 1, 1] and calls("j") == [1, 1, 2, 1, 1]


@pytest.mark.parametrize("extras", [0, 1, 2, 5, 9])
def test_host_availability_mirror_with_extras_equals_jax(extras):
    """``_availability_np`` with ``extras`` (the engine's host mirror, the
    row checks' referent) == the JAX engine's ``_availability`` with the
    same answers as ``extra_estimators``, under default models; the port's
    own device form (K1 merge form, its plain version here) agrees too.
    Answers hold -1 (no answer) and the sentinel; rows hold zero replicas
    and zero requests."""
    sj, _ = chip_smoke.build_workload(karmada_tpu, 5, 64, 48, models=True)
    st, _ = chip_smoke.build_workload(karmada_tpu_torch, 5, 64, 48, models=True)
    rng = np.random.default_rng(90 + extras)
    b, c, r = 40, st.num_clusters, len(st.dims)
    reqs = (rng.integers(0, 4, (b, r)) * rng.choice([250, 512 << 20, 1], r)).astype(np.int64)
    reqs[0] = 0
    reps = np.where(rng.random(b) < 0.15, 0, rng.integers(1, 300, b)).astype(np.int32)
    ex = []
    for _ in range(extras):
        e = rng.integers(-1, 200, (b, c)).astype(np.int32)
        e[rng.random((b, c)) < 0.1] = 2**31 - 1
        ex.append(e)
    je = JS.TensorScheduler(sj, extra_estimators=[lambda q, p, e=e: e for e in ex])
    te = TS.TensorScheduler(st, extra_estimators=[lambda q, p, e=e: e for e in ex],
                            device="cpu")
    assert te._models_active()
    want = np.asarray(je._availability(reqs, reps))
    got = te._availability_np(reqs, reps, extras=ex)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(te._availability(reqs, reps).numpy(), want)


def test_chip_smoke_estimator_phases_rehearse_on_cpu(capsys):
    """chip_smoke's slice-3 phases run end to end on the CPU at a small
    size (the plain versions stand in for the kernels, so no counter
    moves): config 3, the config-5 storm under default models with K7's
    checks on its table, the models general pass and the estimator phase,
    each held to the numpy divider."""
    import torch

    cpu = torch.device("cpu")
    assert not any(chip_smoke.run_config(3, cpu, "cpu", passes=1)["launches"].values())
    storm = chip_smoke.run_fleet_storm(cpu, "cpu", bindings=1200, clusters=150,
                                       steady=1, churn=2, models=True)
    assert set(storm["stats"]) == {"model_overlay"}
    chip_smoke.run_general_models(cpu, "cpu", bindings=1500, clusters=150)
    est = chip_smoke.run_estimator(cpu, "cpu", clusters=4, nodes=2100, bindings=600)
    assert set(est["walls"]) == {"cold", "steady", "hard refresh", "pod events"}
    # each phase raises on any row that differs from its referent
    assert capsys.readouterr().out.count("ok / 0 bad") >= 6


class Failing:
    """Makes an estimator's fetch raise until ``heal()``."""

    def __init__(self, est):
        self.broken = True
        inner = est.max_available_replicas

        def fetch(*a):
            if self.broken:
                raise RuntimeError("estimator fetch failed")
            return inner(*a)

        est.max_available_replicas = fetch

    def heal(self):
        self.broken = False


def test_estimator_fetch_error_answers_no_answer_in_both_engines():
    """An in-process estimator whose fetch raises answers -1 (no answer)
    for that pass in both registries, unmemoized: the engines place the
    batch alike, without that cluster's node sums. Healed, the next pass
    fetches it again, memoizes it and places alike again."""
    runs = {}
    for key, pkg, kw in (("j", karmada_tpu, {}), ("t", karmada_tpu_torch, {"device": "cpu"})):
        acc = JA if key == "j" else TA
        sched = JS if key == "j" else TS
        snap, nodes, problems = chip_smoke.estimator_workload(pkg, 6, 2100, 300)
        reg = acc.EstimatorRegistry()
        failing = None
        for name in snap.names:
            est = acc.AccurateEstimator(name, acc.NodeCache(snap.dims, nodes[name]), **kw)
            if name == snap.names[3]:
                failing = Failing(est)
            reg.register(est)
        batch = reg.make_batch_estimator(snap.names)
        runs[key] = (reg, batch, sched.TensorScheduler(snap, extra_estimators=[batch], **kw),
                     problems, snap, failing)
    bad = runs["t"][4].names[3]

    def run():
        return tuple(outcome(runs[k][2].schedule(runs[k][3])) for k in ("j", "t"))

    want, got = run()
    assert got == want
    assert runs["t"][1].unanswered == {bad}
    assert not any(name == bad for name, _ in runs["t"][0]._memo)
    assert runs["t"][0]._memo == runs["j"][0]._memo
    for key in ("j", "t"):
        runs[key][5].heal()
    want2, got2 = run()
    assert got2 == want2 and got2 != got  # the healed node sums bind
    assert not runs["t"][1].unanswered
    assert any(name == bad for name, _ in runs["t"][0]._memo)
    assert runs["t"][0]._memo == runs["j"][0]._memo


@pytest.mark.parametrize("k", range(len(chip_smoke.MODEL_EDGE_CASES)),
                         ids=["{}x{}x{}x{}-pods{}-{}".format(*case)
                              for case in chip_smoke.MODEL_EDGE_CASES])
def test_model_overlay_edge_batch_equals_jax(k):
    """K7's plain version on every ``chip_smoke.MODEL_EDGE_CASES`` batch
    (unsorted grades; G 1, 9, 16; R 1, 4, 17; pods dim -1, 0, last; C 1 to
    16,385; U 1 to 1024; requests of 0, 1 and 2^63 - 1 in every dim; int64
    sums that wrap; clusters with models and no summary) against
    ``estimate_by_models`` composed as the JAX engine's ``_profile_table``
    composes it (core.py:2263-2293): the pods column zeroed, the model
    answer capped by allowed pods, taken where the cluster has models and
    it applies, -1 without a summary. Exact."""
    pods = chip_smoke.MODEL_EDGE_CASES[k][4]
    b = chip_smoke.model_edge_case(k)
    req = b["requests"].copy()
    if pods >= 0:
        req[:, pods] = 0
    model, app = jax_by_models(*map(jnp.asarray, (b["min_bounds"], b["counts"],
                                                  b["covered"], req)))
    if pods >= 0:
        allowed = jnp.minimum(jnp.maximum(jnp.asarray(b["available_cap"][:, pods]), 0),
                              2**31 - 1).astype(jnp.int32)
        model = jnp.minimum(model, allowed[None, :])
    want = jnp.where(jnp.asarray(b["has_models"])[None, :] & app, model, jnp.asarray(b["table"]))
    want = np.asarray(jnp.where(jnp.asarray(b["has_summary"])[None, :], want, -1))
    t = torch.from_numpy(b["table"].copy())
    args = (b["min_bounds"], b["counts"], b["covered"], b["requests"], b["has_models"],
            b["has_summary"], b["available_cap"])
    TM.model_overlay(t, *map(torch.from_numpy, args), pods)
    np.testing.assert_array_equal(t.numpy(), want)
