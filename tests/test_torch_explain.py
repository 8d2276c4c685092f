"""The provenance plane of the port against the JAX package, on the CPU.

- K14's plain version (``karmada_tpu_torch.ops.explain_pass`` on CPU
  tensors) against the JAX ``explain_pass`` and both packages' numpy
  referents, bit for bit, on seeded grids: heavy key ties, C in {1, 3, 8,
  300}, padded tails, negative availability and caps;
- the port's ExplainStore, capture decode and renderers against the JAX
  copy on the same captures;
- the port's engine against the JAX engine with the same store on the same
  problems: every capture's masks, top-k, group rank, errors, reasons,
  assignment and wave, on the tiny-batch, general and fleet routes, in the
  cases of tests/test_explain.py's engine tests (quota denial, static cap,
  NoExecute taint and eviction, failover displacement, cap-zeroed primary
  group, batch-identity replay, a disabled ring), and the
  ``KARMADA_TPU_EXPLAIN`` arming of both engines when they are built.

Tolerance: exact equality (integer and bit outputs)."""

import pathlib
import re

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.utils.builders  # noqa: F401
import karmada_tpu.utils.explainstore as JE
from karmada_tpu.ops.explain import explain_pass as jax_explain_pass
from karmada_tpu.refimpl.explain_np import explain_batch_np as jax_explain_np
from karmada_tpu.utils.tracing import tracer as jax_tracer

import karmada_tpu_torch
import karmada_tpu_torch.scheduler as TS
import karmada_tpu_torch.utils.builders  # noqa: F401
import karmada_tpu_torch.utils.explainstore as TE
from karmada_tpu_torch.ops import explain as TX
from karmada_tpu_torch.refimpl.explain_np import explain_batch_np
from karmada_tpu_torch.utils.tracing import tracer as port_tracer

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)
ARGS = ("aff_ok", "taint_ok", "api_ok", "spread_ok", "avail", "caps", "admitted",
        "dynamic", "replicas", "assignment", "prev", "preempted")


def mod(pkg, name):
    return __import__(f"{pkg.__name__}.{name}", fromlist=["x"])


# --------------------------------------------------------------------------
# K14's plain version against the JAX program
# --------------------------------------------------------------------------


def grid(rng, b, c, ties=False, negative=False):
    """Seeded K14 inputs. ``ties``: narrow availability and few assigned
    cells, so most keys tie; ``negative``: availability and caps reach
    below -1."""
    lo = -5 if negative else -1
    hi = 3 if ties else 60
    return dict(
        aff_ok=rng.random((b, c)) < 0.8,
        taint_ok=rng.random((b, c)) < 0.9,
        api_ok=rng.random((b, c)) < 0.95,
        spread_ok=rng.random((b, c)) < 0.85,
        avail=rng.integers(lo, hi, (b, c)).astype(np.int32),
        caps=np.where(rng.random((b, c)) < 0.2, rng.integers(lo, 4, (b, c)),
                      2**31 - 1).astype(np.int32),
        admitted=rng.random(b) < 0.8,
        dynamic=rng.random(b) < 0.7,
        replicas=rng.integers(0, 12, b).astype(np.int32),
        assignment=np.where(rng.random((b, c)) < (0.05 if ties else 0.3),
                            rng.integers(0, 4, (b, c)), 0).astype(np.int32),
        prev=rng.integers(0, 3, (b, c)).astype(np.int32),
        preempted=rng.random((b, c)) < 0.1,
    )


def port(inputs, k):
    mask, topk = TX.explain_pass(*(torch.from_numpy(inputs[a]) for a in ARGS), k=k)
    return mask.numpy(), topk.numpy()


@pytest.mark.parametrize("c", (1, 3, 8, 300))
@pytest.mark.parametrize("kind", ("random", "ties", "negative"))
def test_plain_equals_jax(c, kind):
    rng = np.random.default_rng(c * 7 + len(kind))
    inputs = grid(rng, 37, c, ties=kind == "ties", negative=kind == "negative")
    k = TX.topk_width(c)
    mask, topk = port(inputs, k)
    jm, jt = jax_explain_pass(*(inputs[a] for a in ARGS), k=k)
    np.testing.assert_array_equal(mask, np.asarray(jm))
    np.testing.assert_array_equal(topk, np.asarray(jt))
    nm, nt = explain_batch_np(*(inputs[a] for a in ARGS), k=k)
    np.testing.assert_array_equal(mask, nm)
    np.testing.assert_array_equal(topk, nt)
    jnm, jnt = jax_explain_np(*(inputs[a] for a in ARGS), k=k)
    np.testing.assert_array_equal(nm, jnm)
    np.testing.assert_array_equal(nt, jnt)
    assert mask.dtype == np.uint8 and topk.dtype == np.int32
    assert topk.shape == (37, k, TX.TOPK_COLS)


@pytest.mark.parametrize("case", range(len(chip_smoke.EXPLAIN_EDGE_CASES)))
def test_plain_equals_jax_on_edge_batches(case):
    """K14's plain version (what the kernel is held to on the card) against
    the JAX ``explain_pass`` and the numpy referent on every
    ``chip_smoke.explain_edge_batch`` case: C about the 16-cell step and a
    warp's 512 cells, k = 1..8, every key tied, ties on availability alone,
    MAX_INT32 and INT32_MIN operands (keys that wrap int64), fewer than k
    non-zero keys, padding rows."""
    b, c, k = chip_smoke.EXPLAIN_EDGE_CASES[case]
    inputs = chip_smoke.explain_edge_batch(np.random.default_rng(chip_smoke.SEED + 900 + case),
                                           b, c)
    assert list(inputs) == list(ARGS)
    mask, topk = port(inputs, k)
    jm, jt = jax_explain_pass(*(inputs[a] for a in ARGS), k=k)
    np.testing.assert_array_equal(mask, np.asarray(jm))
    np.testing.assert_array_equal(topk, np.asarray(jt))
    # the numpy referent ranks by (assigned, availability, index) and does
    # not model the key's int64 wrap (rows of kind 3, INT32_MIN assigned):
    # its top-k is held on the other rows
    nm, nt = explain_batch_np(*(inputs[a] for a in ARGS), k=k)
    np.testing.assert_array_equal(mask, nm)
    plain = np.arange(b) % 7 != 3
    np.testing.assert_array_equal(topk[plain], nt[plain])


def test_held_to_plain_keeps_the_wrapper_count():
    """chip_smoke's stand-in for K14 during an armed pass keeps each call and,
    after the block, holds it to the plain version; the launches the wrapper
    counts through its module name land on the wrapper itself; on leaving,
    the wrapper is back."""
    original = TX.explain_pass
    before = original.launches
    inputs = grid(np.random.default_rng(11), 9, 30)
    with chip_smoke.held_to_plain("held") as held:
        assert TX.explain_pass is held
        TX.explain_pass.launches += 1  # what native.launch does after a launch
        TX.explain_pass(*(torch.from_numpy(inputs[a]) for a in ARGS), k=8)
    assert TX.explain_pass is original
    assert original.launches == before + 1
    original.launches = before
    assert held.chunks == 0 and len(held.kept) == 1
    held.check()
    assert held.chunks == 1 and not held.kept


def test_every_key_tied_keeps_index_order():
    """Every unassigned cluster of equal availability ties: the top-k is the
    k lowest indices, as lax.top_k answers."""
    b, c = 6, 40
    inputs = grid(np.random.default_rng(3), b, c)
    inputs["avail"][:] = 7
    inputs["assignment"][:] = 0
    mask, topk = port(inputs, 8)
    assert (topk[:, :, 0] == np.arange(8)).all()
    jm, jt = jax_explain_pass(*(inputs[a] for a in ARGS), k=8)
    np.testing.assert_array_equal(topk, np.asarray(jt))


def test_padded_tail_matches_jax_padding():
    """The JAX engine pads a chunk to a power of two with admitted pad rows
    and slices them off; the port launches on the real rows. Both answer
    the same rows."""
    b, c, b_pad = 13, 50, 16
    inputs = grid(np.random.default_rng(5), b, c)
    padded = {a: np.pad(v, ((0, b_pad - b),) + ((0, 0),) * (v.ndim - 1),
                        constant_values=(a == "admitted"))
              for a, v in inputs.items()}
    mask, topk = port(inputs, 8)
    jm, jt = jax_explain_pass(*(padded[a] for a in ARGS), k=8)
    np.testing.assert_array_equal(mask, np.asarray(jm)[:b])
    np.testing.assert_array_equal(topk, np.asarray(jt)[:b])


def test_wrapper_takes_plain_version_on_cpu():
    inputs = grid(np.random.default_rng(9), 5, 12)
    before = TX.explain_pass.launches
    got = port(inputs, 8)
    want = TX.explain_pass_ref(*(torch.from_numpy(inputs[a]) for a in ARGS), k=8)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert TX.explain_pass.launches == before
    with pytest.raises(ValueError):
        TX.explain_pass(*(torch.from_numpy(inputs[a]).to("meta") for a in ARGS), k=8)
    with pytest.raises(ValueError):
        port(inputs, 9)


def test_bit_positions_follow_the_taxonomy_and_the_kernel_source():
    from karmada_tpu.ops import explain as JX
    from karmada_tpu_torch.utils.reasons import STAGE_REASONS

    names = ("AFFINITY", "TAINT", "API", "AVAILABILITY", "QUOTA_CAP", "QUOTA_ADMIT",
             "SPREAD", "PREEMPTED")
    cu = (pathlib.Path(karmada_tpu_torch.__file__).parent / "csrc" / "explain_pass.cu").read_text()
    for n in names:
        bit = getattr(TX, f"BIT_{n}")
        assert bit == getattr(JX, f"BIT_{n}")
        assert int(re.search(rf"BIT_{n} = (\d+);", cu).group(1)) == bit
    assert TX.N_STAGES == len(STAGE_REASONS) == 8
    assert [TX.topk_width(c) for c in (0, 1, 5, 8, 5000)] == [1, 1, 5, 8, 8]


# --------------------------------------------------------------------------
# the store and its decode
# --------------------------------------------------------------------------


def capture_pair(seed, wave, b=9, c=12):
    rng = np.random.default_rng(seed)
    inputs = grid(rng, b, c)
    mask, topk = port(inputs, 8)
    names = tuple(f"m{j}" for j in range(c))
    keys = [f"ns/b{seed}-{i}" for i in range(b)]
    errors = ["" if i % 3 else "clusters available replicas are not enough" for i in range(b)]
    errors[1] = "no clusters fit the placement"
    common = dict(wave=wave, names=names, keys=keys, masks=mask, topk=topk,
                  group_rank=rng.integers(0, 3, b).astype(np.int32), errors=errors,
                  assignment=inputs["assignment"])
    return JE.ExplainCapture(**common), TE.ExplainCapture(**common)


def strip_at(doc):
    """A decoded document without its capture timestamps."""
    if isinstance(doc, dict):
        return {k: strip_at(v) for k, v in doc.items() if k != "at"}
    if isinstance(doc, list):
        return [strip_at(v) for v in doc]
    return doc


def test_store_decode_and_renderers_equal_jax():
    js, ts = JE.ExplainStore(cap=2), TE.ExplainStore(cap=2)
    for seed, wave in ((1, 10), (2, 10), (3, 11), (4, 12)):
        jc, tc = capture_pair(seed, wave)
        js.add(jc)
        ts.add(tc)
        for row in range(jc.bindings):
            assert strip_at(tc.decode(row)) == strip_at(jc.decode(row))
    assert (ts.added, ts.evicted) == (js.added, js.evicted) == (4, 2)
    assert [c.wave for c in ts.captures()] == [c.wave for c in js.captures()] == [11, 12]
    for wave in (None, 11, 12):
        assert ts.wave_summary(wave) == js.wave_summary(wave)
        assert strip_at(ts.worst(wave)) == strip_at(js.worst(wave))
        assert strip_at(ts.debug_doc(wave=wave)) == strip_at(js.debug_doc(wave=wave))
        ctx_t, ctx_j = ts.worst_context(wave), js.worst_context(wave)
        assert TE.render_worst_table(ctx_t) == JE.render_worst_table(ctx_j)
    for key in ("ns/b3-4", "b4-2", "nope"):
        doc_t, doc_j = ts.explain_binding(key), js.explain_binding(key)
        assert strip_at(doc_t) == strip_at(doc_j)
        assert TE.render_explanation(doc_t) == JE.render_explanation(doc_j)
    assert ts.captures()[0].nbytes() == js.captures()[0].nbytes()
    ts.clear()
    assert ts.captures() == [] and ts.added == 0


def test_store_cap_from_env(monkeypatch):
    monkeypatch.setenv("KARMADA_TPU_EXPLAIN_CAP", "0")
    assert not TE.ExplainStore().enabled
    monkeypatch.setenv("KARMADA_TPU_EXPLAIN_CAP", "junk")
    assert TE.ExplainStore().cap == JE.ExplainStore().cap == 8
    for raw, armed in (("1", True), ("yes", True), ("0", False), ("", False)):
        monkeypatch.setenv("KARMADA_TPU_EXPLAIN", raw)
        assert TE.explain_armed() is JE.explain_armed() is armed


# --------------------------------------------------------------------------
# the engine against the JAX engine
# --------------------------------------------------------------------------

CPU_REQ = {"cpu": 1000}


def pl(pkg, groups=None, spread=False):
    b = mod(pkg, "utils.builders")
    api = mod(pkg, "api.policy")
    kw = {}
    if groups:
        kw["cluster_affinities"] = [
            api.ClusterAffinityTerm(affinity_name=f"grp-{g}",
                                    label_selector=api.LabelSelector(match_labels={"group": g}))
            for g in groups]
    if spread:
        kw["spread_constraints"] = [api.SpreadConstraint(
            spread_by_field="cluster", min_groups=2, max_groups=3)]
    return b.dynamic_weight_placement(**kw)


def problem(pkg, key, ns="", replicas=2, placement=None, prev=None, evict=(), gvk=None,
            preempt=()):
    return mod(pkg, "scheduler").BindingProblem(
        key=key, placement=placement or pl(pkg), replicas=replicas,
        requests=dict(CPU_REQ), gvk="apps/v1/Deployment" if gvk is None else gvk,
        prev=dict(prev or {}), evict_clusters=tuple(evict), namespace=ns,
        preempt_clusters=tuple(preempt))


def frq(pkg, ns, overall, static=()):
    api = mod(pkg, "api.policy")
    core = mod(pkg, "api.core")
    return api.FederatedResourceQuota(
        meta=core.ObjectMeta(name="q", namespace=ns),
        spec=api.FederatedResourceQuotaSpec(
            overall=dict(overall),
            static_assignments=[api.StaticClusterAssignment(cluster_name=c, hard=h)
                                for c, h in static]))


def capture_fields(cap):
    return (cap.names, cap.keys, cap.uniq_masks[cap.mask_inv].tolist(), cap.topk.tolist(),
            cap.group_rank.tolist(), cap.errors, cap.reasons, cap.asg_rows.tolist(),
            cap.asg_cols.tolist(), cap.asg_vals.tolist())


def outcome(results):
    return [(r.key, dict(r.clusters), r.error, r.affinity_name) for r in results]


class Pair:
    """One engine per package over ``clusters_fn(pkg)``, each with its own
    ExplainStore; ``schedule(fn)`` runs ``fn(pkg)``'s problems through both
    and asserts equal results and equal captures."""

    def __init__(self, clusters_fn, route="tiny", quota_fn=None, chunk_size=4096):
        self.engines, self.stores = [], []
        for pkg in PKGS:
            snap = mod(pkg, "scheduler").ClusterSnapshot(clusters_fn(pkg))
            eng = (JS.TensorScheduler(snap, chunk_size=chunk_size, trace_manifest="")
                   if pkg is karmada_tpu
                   else TS.TensorScheduler(snap, chunk_size=chunk_size, device="cpu"))
            if route == "general":
                eng.fleet_threshold = 10**9
            store = mod(pkg, "utils.explainstore").ExplainStore(cap=8)
            eng.set_explain(store)
            if quota_fn is not None:
                eng.set_quota(mod(pkg, "scheduler").build_quota_snapshot(
                    quota_fn(pkg), snap, generation=1))
            self.engines.append(eng)
            self.stores.append(store)

    def schedule(self, problems_fn):
        jax_tracer.begin_wave("test")
        port_tracer.begin_wave("test")
        outs, caps = [], []
        for pkg, eng, store, tr in zip(PKGS, self.engines, self.stores,
                                       (jax_tracer, port_tracer)):
            n0 = len(store.captures())
            res = eng.schedule(problems_fn(pkg))
            new = store.captures()[n0:]
            assert new and all(c.wave == tr.current_wave for c in new)
            outs.append(outcome(res))
            caps.append([capture_fields(c) for c in new])
        assert outs[1] == outs[0]
        assert caps[1] == caps[0]
        return self.stores[1], self.engines[1]


def four(pkg, **kw):
    b = mod(pkg, "utils.builders")
    return [b.new_cluster(f"m{i}", cpu="1000", memory="2000Gi", **kw) for i in range(4)]


def test_admission_denial_carries_exactly_its_bit():
    pair = Pair(four, quota_fn=lambda pkg: [frq(pkg, "a", {"cpu": 0})])
    store, _ = pair.schedule(lambda pkg: [problem(pkg, "a/b0", ns="a")])
    doc = store.explain_binding("a/b0")
    assert doc["reason"] == "QuotaExceeded" and set(doc["stages"]) == {"QuotaExceeded"}
    assert doc["stages"]["QuotaExceeded"]["count"] == 4 and doc["clusters_feasible"] == 0


def test_static_cap_carries_cap_bit():
    pair = Pair(lambda pkg: four(pkg)[:3], quota_fn=lambda pkg: [
        frq(pkg, "a", {"cpu": 100000}, static=[("m0", {"cpu": 0})])])
    store, _ = pair.schedule(lambda pkg: [problem(pkg, "a/b0", ns="a", replicas=4)])
    doc = store.explain_binding("a/b0")
    assert set(doc["stages"]) == {"QuotaCapExceeded"}
    assert doc["stages"]["QuotaCapExceeded"]["clusters"] == ["m0"]


def test_noexecute_taint_and_eviction_carry_taint_bit():
    def clusters(pkg):
        b = mod(pkg, "utils.builders")
        cl = mod(pkg, "api.cluster")
        return [b.new_cluster("m0", cpu="1000", memory="2000Gi",
                              taints=[cl.Taint(key="down", effect=cl.NO_EXECUTE)]),
                b.new_cluster("m1", cpu="1000", memory="2000Gi"),
                b.new_cluster("m2", cpu="1000", memory="2000Gi")]

    store, _ = Pair(clusters).schedule(lambda pkg: [
        problem(pkg, "d/tainted"), problem(pkg, "d/evicted", evict=["m1"])])
    assert store.explain_binding("d/tainted")["stages"]["TaintUntolerated"]["clusters"] == ["m0"]
    evicted = store.explain_binding("d/evicted")
    assert set(evicted["stages"]) == {"TaintUntolerated"}
    assert evicted["stages"]["TaintUntolerated"]["clusters"] == ["m0", "m1"]


def grouped(pkg):
    b = mod(pkg, "utils.builders")
    return [b.new_cluster(f"p{i}", cpu="1000", memory="2000Gi", labels={"group": "primary"})
            for i in range(2)] + [
        b.new_cluster(f"f{i}", cpu="1000", memory="2000Gi", labels={"group": "fallback"})
        for i in range(2)]


def test_failover_displacement_explains_group_rank():
    store, _ = Pair(grouped).schedule(lambda pkg: [problem(
        pkg, "d/displaced", replicas=4, placement=pl(pkg, ("primary", "fallback")),
        prev={"p0": 2, "p1": 2}, evict=["p0", "p1"])])
    doc = store.explain_binding("d/displaced")
    assert doc["group_rank"] == 1
    assert set(doc["stages"]["AffinityMismatch"]["clusters"]) == {"p0", "p1"}
    assert set(doc["stages"]["TaintUntolerated"]["clusters"]) == {"p0", "p1"}


def test_cap_zeroed_primary_group_rank_matches_solve():
    pair = Pair(grouped, quota_fn=lambda pkg: [frq(
        pkg, "a", {"cpu": 100000}, static=[("p0", {"cpu": 0}), ("p1", {"cpu": 0})])])
    store, _ = pair.schedule(lambda pkg: [problem(
        pkg, "a/capped", ns="a", replicas=4, placement=pl(pkg, ("primary", "fallback")))])
    doc = store.explain_binding("a/capped")
    assert doc["group_rank"] == 1 and set(doc["assignment"]) <= {"f0", "f1"}


def test_capture_survives_batch_identity_replay():
    pair = Pair(lambda pkg: four(pkg)[:3])
    probs = {pkg: [problem(pkg, f"d/b{i}") for i in range(4)] for pkg in PKGS}
    store, _ = pair.schedule(lambda pkg: probs[pkg])
    n1 = len(store.captures())
    pair.schedule(lambda pkg: probs[pkg])  # identity replay
    assert len(store.captures()) == 2 * n1


def test_disabled_ring_skips_the_launch(monkeypatch):
    """KARMADA_TPU_EXPLAIN_CAP=0: an armed engine whose store keeps nothing
    composes nothing and launches nothing."""
    monkeypatch.setenv("KARMADA_TPU_EXPLAIN_CAP", "0")
    snap = TS.ClusterSnapshot(four(karmada_tpu_torch))
    eng = TS.TensorScheduler(snap, device="cpu")
    dead = TE.ExplainStore()
    eng.set_explain(dead)
    calls = []
    monkeypatch.setattr(eng, "_explain_chunk", lambda *a: calls.append(a))
    assert eng.schedule([problem(karmada_tpu_torch, "d/x")])[0].success
    assert dead.captures() == [] and not calls
    eng.set_explain(None)
    eng.schedule([problem(karmada_tpu_torch, "d/x")])
    assert not calls


def test_env_arms_both_engines_when_built(monkeypatch):
    """KARMADA_TPU_EXPLAIN=1 arms each engine with its package's
    process-wide store when the engine is built (the JAX engine's
    core.py:348-354); both capture the same pass."""
    monkeypatch.setenv("KARMADA_TPU_EXPLAIN", "1")
    JE.reset_store()
    TE.reset_store()
    try:
        engines = []
        for pkg in PKGS:
            snap = mod(pkg, "scheduler").ClusterSnapshot(four(pkg))
            eng = (JS.TensorScheduler(snap, trace_manifest="") if pkg is karmada_tpu
                   else TS.TensorScheduler(snap, device="cpu"))
            assert eng.explain is mod(pkg, "utils.explainstore").store()
            assert eng.preempt_source is None and eng.last_preemption is None
            engines.append(eng)
        caps = []
        for pkg, eng in zip(PKGS, engines):
            res = eng.schedule([problem(pkg, f"d/b{i}", replicas=i) for i in range(5)])
            assert all(r.success for r in res)
            caps.append([capture_fields(c) for c in eng.explain.captures()])
        assert len(caps[1]) == 1 and caps[1] == caps[0]
        monkeypatch.delenv("KARMADA_TPU_EXPLAIN")
        assert TS.TensorScheduler(TS.ClusterSnapshot(four(karmada_tpu_torch)),
                                  device="cpu").explain is None
    finally:
        JE.reset_store()
        TE.reset_store()


def test_env_armed_store_evicts_by_wave(monkeypatch):
    """Armed by KARMADA_TPU_EXPLAIN with a ring of 2 waves, a port engine
    whose passes find no wave open makes each pass a wave of its own, so
    the ring evicts; a wave the caller opened is kept open and stamps the
    pass."""
    monkeypatch.setenv("KARMADA_TPU_EXPLAIN", "1")
    monkeypatch.setenv("KARMADA_TPU_EXPLAIN_CAP", "2")
    TE.reset_store()
    port_tracer.end_wave()
    try:
        eng = TS.TensorScheduler(TS.ClusterSnapshot(four(karmada_tpu_torch)), device="cpu")
        waves = []
        for i in range(5):
            eng.schedule([problem(karmada_tpu_torch, f"d/b{j}", replicas=i + j)
                          for j in range(3)])
            assert port_tracer.open_wave() is None
            waves.append(eng.explain.captures()[-1].wave)
        assert len(set(waves)) == 5
        assert eng.explain.added == 5 and eng.explain.evicted == 3
        assert [c.wave for c in eng.explain.captures()] == waves[-2:]
        w = port_tracer.begin_wave("caller")
        eng.schedule([problem(karmada_tpu_torch, "d/b0")])
        assert port_tracer.open_wave() == w and eng.explain.captures()[-1].wave == w
    finally:
        port_tracer.end_wave()
        TE.reset_store()


def mixed_fleet(pkg, c=300):
    b = mod(pkg, "utils.builders")
    cl = mod(pkg, "api.cluster")
    out = []
    for i in range(c):
        kw = {}
        if i % 37 == 0:
            kw["taints"] = [cl.Taint(key="t", effect=cl.NO_EXECUTE)]
        if i % 53 == 0:
            kw["complete_enablements"] = False
        if i % 61 == 0:
            kw["api_enablements"] = ()
        out.append(b.new_cluster(f"m{i}", cpu=str(40 + (i * 7) % 90), memory="2000Gi",
                                 pods=100_000, labels={"group": f"g{i % 3}"}, **kw))
    return out


def mixed_problems(pkg, n=600, c=300, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    plain, groups = pl(pkg), pl(pkg, ("g0", "g1", "g2"))
    spread = pl(pkg, spread=True)
    dup = mod(pkg, "utils.builders").duplicated_placement()
    for i in range(n):
        kind = i % 7
        prev = {f"m{int(j)}": int(rng.integers(1, 3)) for j in rng.choice(c, 2, replace=False)} \
            if kind in (1, 2) else {}
        evict = [next(iter(prev))] if kind == 2 else []
        placement = {4: groups, 5: dup, 6: spread}.get(kind, plain)
        out.append(problem(pkg, f"ns/w{i}", ns="a" if i % 2 else "b",
                           replicas=int(rng.integers(0, 30)), placement=placement,
                           prev=prev, evict=evict, preempt=evict[:1] if i % 4 == 2 else (),
                           gvk="weird/v9/Thing" if i % 97 == 0 else None))
    return out


@pytest.mark.parametrize("route", ("general", "fleet"))
def test_mixed_wave_captures_equal_jax(route):
    """600 rows over 300 clusters: taints, incomplete enablements, an
    unknown GVK, evictions and preemption tasks, previous sites, ordered
    groups, spread-constrained and Duplicated rows, one namespace under a tight quota with a
    static cap, on the general route and on the fleet route (whose results
    are the lazy fleet list). Chunks of 256 rows: three captures."""
    def quota(pkg):
        return [frq(pkg, "a", {"cpu": 2_000_000}, static=[("m1", {"cpu": 0}), ("m2", {"cpu": 3000})]),
                frq(pkg, "b", {"cpu": 10**9})]

    pair = Pair(mixed_fleet, route=route, quota_fn=quota, chunk_size=256)
    store, eng = pair.schedule(mixed_problems)
    assert (eng._fleet is not None) == (route == "fleet")
    summary = store.wave_summary()
    assert summary["bindings"] == 600 and summary["captures"] == 3
    for code in ("QuotaExceeded", "TaintUntolerated", "QuotaCapExceeded",
                 "PreemptedByHigherPriority", "ApiNotEnabled", "AffinityMismatch"):
        assert summary["stage_excluded_cells"].get(code, 0) > 0, code


def test_stage_masks_compose_to_pack_chunk_feasibility():
    """AND-folding the capture's filter-stage bits reproduces the port's
    ``_pack_chunk`` feasibility (the composition is duplicated, as in
    JAX)."""
    def clusters(pkg):
        b = mod(pkg, "utils.builders")
        cl = mod(pkg, "api.cluster")
        return [b.new_cluster("m0", cpu="1000", memory="2000Gi"),
                b.new_cluster("m1", cpu="1000", memory="2000Gi",
                              taints=[cl.Taint(key="t", effect=cl.NO_EXECUTE)]),
                b.new_cluster("m2", cpu="1000", memory="2000Gi", api_enablements=()),
                b.new_cluster("m3", cpu="1000", memory="2000Gi", complete_enablements=False)]

    def probs(pkg):
        return [problem(pkg, "d/plain"), problem(pkg, "d/lenient", prev={"m1": 1, "m2": 1, "m3": 1}),
                problem(pkg, "d/evicted", evict=["m0"]),
                problem(pkg, "d/unknown-gvk", gvk="weird/v9/Thing")]

    store, eng = Pair(clusters).schedule(probs)
    cap = store.captures()[-1]
    p = probs(karmada_tpu_torch)
    feasible, *_ = eng._pack_chunk(p, [eng._compiled(x.placement) for x in p], 0)
    bits = np.uint8(0)
    for code in ("AffinityMismatch", "TaintUntolerated", "ApiNotEnabled",
                 "SpreadConstraintUnsatisfied"):
        bits |= np.uint8(1 << TX.STAGE_REASONS.index(code))
    assert np.array_equal((cap.uniq_masks[cap.mask_inv] & bits) == 0, feasible)


def test_capture_failure_keeps_the_wave(monkeypatch):
    snap = TS.ClusterSnapshot(four(karmada_tpu_torch))
    eng = TS.TensorScheduler(snap, device="cpu")
    store = TE.ExplainStore(cap=4)
    eng.set_explain(store)

    def boom(*a):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(eng, "_explain_chunk", boom)
    res = eng.schedule([problem(karmada_tpu_torch, "d/x")])
    assert res[0].success and store.captures() == []


def test_explain_fleet_phase_rehearsal_on_cpu():
    """chip_smoke's explain fleet phase at a small size: the storm engine's
    steady pass armed places as the disarmed one, with one capture per
    chunk, the first chunk equal to K14's plain version and a sample of
    every capture equal to the numpy referent (the quota cell's armed surge
    replay rehearses in tests/test_torch_quota_engine.py)."""
    out = chip_smoke.run_explain_fleet(torch.device("cpu"), "cpu", bindings=600,
                                       clusters=150, chunk=256)
    assert out["captures"] == out["chunks"] == 3 and out["sampled"] == 3 * 64
    assert out["summary"]["bindings"] == 600


@pytest.mark.parametrize("shape", ((1, 1), (7, 3), (300, 40), (0, 5), (4, 0)))
def test_intern_rows_equals_np_unique(shape):
    """The store's row interning answers np.unique(axis=0) exactly: the same
    unique rows in the same order (bytes at and above 128 included) and the
    same inverse."""
    rng = np.random.default_rng(sum(shape))
    b, c = shape
    base = rng.integers(0, 256, (max(1, b // 5), c)).astype(np.uint8)
    masks = base[rng.integers(0, len(base), b)] if b else np.zeros((0, c), np.uint8)
    uniq, inv = TE.intern_rows(masks)
    want_u, want_inv = np.unique(masks, axis=0, return_inverse=True)
    np.testing.assert_array_equal(uniq, want_u)
    np.testing.assert_array_equal(inv, want_inv.reshape(-1))
    assert uniq.dtype == np.uint8 and inv.dtype == np.int32
    if b and c:
        jc = JE.ExplainCapture(wave=0, names=tuple(range(c)), keys=list(range(b)), masks=masks,
                               topk=np.zeros((b, 1, 5), np.int32),
                               group_rank=np.zeros(b, np.int32), errors=[""] * b,
                               assignment=np.zeros((b, c), np.int32))
        np.testing.assert_array_equal(jc.uniq_masks, uniq)
        np.testing.assert_array_equal(jc.mask_inv, inv)


def test_tracer_wave_lifecycle_equals_jax():
    """The port's wave/span core against the JAX tracer through the same
    sequence: wave ids, open-wave reads, nested spans and their parents,
    recorded spans, the current context, and the ring's counted
    evictions."""
    from karmada_tpu.utils.tracing import WaveTracer as JaxTracer
    from karmada_tpu_torch.utils.tracing import WaveTracer as PortTracer

    def drive(tr):
        out = [tr.open_wave(), tr.current_context().wave]
        w1 = tr.begin_wave("a")
        out += [w1, tr.ensure_wave("b"), tr.open_wave()]
        with tr.span("scheduler.pass", rows=3) as outer:
            with tr.span("scheduler.pack") as inner:
                inner.attrs["kind"] = "host"
            tr.record("scheduler.explain", 0.001, rows=3)
            ctx = tr.current_context()
            out.append((ctx.wave, ctx.span_id == outer.span_id, ctx.proc))
        with tr.span("scheduler.host") as sp:
            sp.attrs["_discard"] = True
        out += [tr.end_wave(), tr.open_wave(), tr.ensure_wave("c"), tr.end_wave()]
        for i in range(20):
            tr.record("scheduler.preempt", 0.0, i=i)
        spans = tr.dump(w1)
        ids = {s["span_id"]: s["name"] for s in spans}
        out.append([(s["name"], ids.get(s["parent_id"]), s["attrs"]) for s in spans])
        out += [tr.dropped_total, sorted({s["wave"] for s in tr.dump()})]
        return out

    jax_side = drive(JaxTracer(capacity=16))
    port_side = drive(PortTracer(capacity=16))
    assert port_side == jax_side
    assert port_side[2:5] == [1, 1, 1]
