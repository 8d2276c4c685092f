"""The port's estimators against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays (or as API objects built from the same numbers). Tolerance:
exact equality — every output is an integer replica count or a flag, and
the int64 wrap-around of the JAX programs is part of what is compared.

Covered: the resource-model estimate (``estimate_by_models``, its numpy
mirror, K7's plain and overlay forms through their plain versions), the
node-level node sum (K8's plain version and the numpy mirror), K1's merge
form, ``NodeSnapshot``/``NodeCache`` packing and event streams, the
``AccurateEstimator`` prefilter and ``ResourceQuotaPlugin``, and the
registry's memo. On the CPU every wrapper runs its plain version; the
kernels are held to those on the card by ``chip_smoke.py``.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import karmada_tpu.api.cluster as JC
import karmada_tpu.api.work as JW
import karmada_tpu.estimator.accurate as JA
import karmada_tpu.ops as JO
import karmada_tpu.scheduler as JS
from karmada_tpu.models.modeling import estimate_by_models as jax_by_models
from karmada_tpu.models.modeling import estimate_by_models_np as jax_by_models_np
from karmada_tpu.utils import features as JF

import chip_smoke
import karmada_tpu_torch.api.cluster as TC
import karmada_tpu_torch.api.work as TW
import karmada_tpu_torch.estimator.accurate as TA
import karmada_tpu_torch.scheduler as TS
from karmada_tpu_torch import ops as TO
from karmada_tpu_torch.models import modeling as TM
from karmada_tpu_torch.utils import features as TF

HI = 2**31 - 1
DIMS = ["cpu", "memory", "pods", "ephemeral-storage"]


def model_inputs(rng, u, c, g, r):
    """Model-estimate inputs over every branch: padding grades (-1 bounds,
    count 0), uncovered dims, all-zero and pods-only requests, requests no
    grade covers, bounds near 2^62 and 2^63 with requests of 1 (per-node
    answers at and past the 2^62 sentinel) and counts near 2^31 (int64
    products and sums that wrap)."""
    mb = np.sort(rng.integers(0, 64_000, (c, g, r)), axis=1).astype(np.int64)
    mb[rng.random((c, g, r)) < 0.1] = -1  # undefined grade/resource
    pad = rng.random(c) < 0.3
    mb[pad, -1] = -1  # padding grade
    big = rng.random((c, g, r)) < 0.08
    mb[big] = rng.integers(2**61, 2**63 - 1, int(big.sum()), dtype=np.int64)
    counts = rng.integers(0, 50, (c, g)).astype(np.int32)
    counts[pad, -1] = 0
    wide = rng.random((c, g)) < 0.1
    counts[wide] = rng.integers(2**30, HI, int(wide.sum()))
    covered = rng.random((c, r)) < 0.85
    # clusters whose grade sums wrap for a request of 1: per-node answers
    # just under the sentinel times counts near 2^31
    mb[:4, :, 0] = rng.integers(2**61, 2**62 - 1, (4, g), dtype=np.int64)
    counts[:4] = rng.integers(2**30, HI, (4, g))
    req = rng.integers(0, 70_000, (u, r)).astype(np.int64)
    req[rng.random((u, r)) < 0.35] = 0
    req[0] = 0  # requests nothing
    req[1] = [1] + [0] * (r - 1)  # per-node answers near the sentinel
    req[2] = 10**9  # no grade covers it
    return mb, counts, covered, req


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_by_models_equals_jax(seed):
    rng = np.random.default_rng(seed)
    mb, counts, covered, req = model_inputs(rng, 24, 30, 5, 4)
    want_t, want_a = map(np.asarray, jax_by_models(*map(jnp.asarray, (mb, counts, covered, req))))
    got_t, got_a = TM.estimate_by_models(*map(torch.from_numpy, (mb, counts, covered, req)))
    assert got_t.dtype == torch.int32 and got_a.dtype == torch.bool
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    # the fuzz reaches every branch: no answer, wrapped, clamped, inapplicable
    assert (want_t == 0).any() and (want_t < 0).any() and (want_t == HI).any()
    assert (~want_a).any() and want_a.any()
    # K7 on CPU tensors is its plain version: over a table of summarised,
    # modelled clusters with no pods column, the model answer lands where
    # it applies and the table's answer stands elsewhere
    u, c = want_t.shape
    table = torch.full((u, c), -7, dtype=torch.int32)
    ones = torch.ones(c, dtype=torch.bool)
    TM.model_overlay(table, *map(torch.from_numpy, (mb, counts, covered, req)),
                     ones, ones, torch.zeros((c, req.shape[1]), dtype=torch.int64), -1)
    np.testing.assert_array_equal(table.numpy(), np.where(want_a, want_t, -7))
    assert TM.model_overlay.launches == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_estimate_by_models_np_equals_jax(seed):
    rng = np.random.default_rng(seed)
    mb, counts, covered, req = model_inputs(rng, 16, 20, 6, 3)
    want = jax_by_models_np(mb, counts, covered, req)
    got = TM.estimate_by_models_np(mb, counts, covered, req)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.asarray(jax_by_models(*map(jnp.asarray, (mb, counts, covered, req)))[0]))


def model_fleet(pkg_api, pkg_builders, c, seed):
    """A fleet where some clusters have models, some have models and no
    summary, some only a summary; grades from the default set with
    seeded counts, and a few clusters whose pods cap binds."""
    rng = np.random.default_rng(seed)
    fleet = pkg_builders.synthetic_fleet(c, seed=seed)
    for i, cl in enumerate(fleet):
        kind = i % 4
        if kind != 3:
            cl.spec.resource_models = pkg_api.default_resource_models()
            cl.status.resource_summary.allocatable_modelings = [
                pkg_api.AllocatableModeling(grade=g, count=int(n))
                for g, n in enumerate(rng.integers(0, 400, 9))
            ]
        if kind == 1:  # models and no summary
            cl.status.resource_summary.allocatable = {}
        if kind == 2 and i % 8 == 2:  # tight pods cap
            cl.status.resource_summary.allocated["pods"] = (
                cl.status.resource_summary.allocatable["pods"] - 3
            )
    return fleet


def test_profile_table_with_models_equals_jax():
    """K1's table form followed by K7's overlay form (their plain versions
    on the CPU) == the JAX engine's ``_profile_table`` with models: the
    overlay leaves -1 on clusters with models but no summary, the pods
    column does not defeat applicability and allowed pods cap the model
    answer."""
    import karmada_tpu.utils.builders as JB
    import karmada_tpu_torch.utils.builders as TB

    sj = JS.ClusterSnapshot(model_fleet(JC, JB, 40, 8))
    st = TS.ClusterSnapshot(model_fleet(TC, TB, 40, 8))
    rng = np.random.default_rng(9)
    profiles = rng.integers(0, 9000, (12, len(st.dims))).astype(np.int64)
    profiles[:, 1] *= 1 << 20
    profiles[:, st.dim_index("pods")] = 1
    profiles[:, st.dim_index("ephemeral-storage")] = 0
    profiles[0] = 0
    profiles[1, 0] = 10**8  # no grade covers it
    profiles[2, 3] = 5  # ephemeral-storage: not covered by the models
    want = np.asarray(JS.TensorScheduler(sj)._profile_table(profiles))
    got = TS.TensorScheduler(st, device="cpu")._profile_table(profiles)
    np.testing.assert_array_equal(got.numpy(), want)
    no_summary = ~st.has_summary & st.model_pack.has_models
    assert no_summary.any() and (want[:, no_summary] == -1).all()
    general = np.asarray(TO.profile_table_ref(
        torch.from_numpy(st.available_cap), torch.from_numpy(profiles),
        torch.from_numpy(st.has_summary)))
    assert (want > general).any() and (want < general).any()
    # the numpy mirror agrees wherever a cluster answers (it writes the
    # sentinel, not -1, for no-summary clusters)
    host = TS.host_profile_table(st, profiles, models_active=True)
    np.testing.assert_array_equal(np.where(want == -1, HI, want), host)


def test_model_overlay_ref_equals_jax_composition():
    """The overlay's plain version against the JAX composition on seeded
    model inputs, has_models and has_summary independent of each other."""
    rng = np.random.default_rng(21)
    c, g, r, u = 36, 5, 4, 10
    mb, counts, covered, req = model_inputs(rng, u, c, g, r)
    has_models = rng.random(c) < 0.7
    has_summary = rng.random(c) < 0.8
    cap = rng.integers(-50, 2**40, (c, r)).astype(np.int64)
    table = np.where(has_summary[None, :], rng.integers(0, 500, (u, c)), -1).astype(np.int32)
    pods = 2
    req_m = req.copy()
    req_m[:, pods] = 0
    model, app = jax_by_models(*map(jnp.asarray, (mb, counts, covered, req_m)))
    allowed = jnp.minimum(jnp.maximum(jnp.asarray(cap[:, pods]), 0), HI).astype(jnp.int32)
    model = jnp.minimum(model, allowed[None, :])
    want = jnp.where(jnp.asarray(has_models)[None, :] & app, model, jnp.asarray(table))
    want = np.asarray(jnp.where(jnp.asarray(has_summary)[None, :], want, -1))
    t = torch.from_numpy(table.copy())
    out = TM.model_overlay(t, *map(torch.from_numpy, (mb, counts, covered, req, has_models,
                                                      has_summary, cap)), pods)
    assert out is t  # in place
    np.testing.assert_array_equal(t.numpy(), want)


def node_inputs(rng, b, n, r):
    avail = rng.integers(-2000, 200_000, (n, r)).astype(np.int64)
    big = rng.random((n, r)) < 0.05
    avail[big] = rng.integers(2**61, 2**63 - 1, int(big.sum()), dtype=np.int64)
    req = rng.integers(0, 5000, (b, r)).astype(np.int64)
    req[rng.random((b, r)) < 0.3] = 0
    req[0] = 0  # requests nothing: 0 per node
    req[1] = [1] + [0] * (r - 1)  # per-node answers near 2^62: the sum wraps
    ok = rng.random((b, n)) < 0.8
    return avail, ok, req


@pytest.mark.parametrize("seed,b,n", [(0, 7, 300), (1, 33, 60), (2, 5, 1)])
def test_node_sum_equals_jax(seed, b, n):
    rng = np.random.default_rng(seed)
    avail, ok, req = node_inputs(rng, b, n, 4)
    want = np.asarray(JA._node_sum_estimate(*map(jnp.asarray, (avail, ok, req))))
    got = TA.node_sum_estimate_ref(*map(torch.from_numpy, (avail, ok, req)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TA._node_sum_estimate_np(avail, ok, req), want)
    np.testing.assert_array_equal(
        TA.node_sum_estimate(*map(torch.from_numpy, (avail, ok, req))).numpy(), want)
    assert TA.node_sum_estimate.launches == 0
    if n > 1:
        assert (want == 0).any() and (want != 0).any()
    if n == 300:
        assert (want < 0).any() or (want == HI).any()  # the wrap is exercised


@pytest.mark.parametrize("case", range(len(chip_smoke.NODE_EDGE_CASES)))
def test_node_sum_equals_jax_on_edge_batches(case):
    """K8's plain version (what the kernel is held to on the card) and the
    numpy mirror against the JAX ``_node_sum_estimate`` on every
    ``chip_smoke.node_edge_batch`` case: divisors 1, 2, 3, 7, 2^k and 2^k +- 1
    (k = 31, 32, 62), large primes and 2^63 - 1; dividends 0, q d - 1, q d,
    q d + 1, 2^62 - 1, 2^63 - 1 and negatives; rows that request nothing,
    whose nodes all fail the prefilter, whose int64 sum wraps, whose ratios
    tie across dims; N about a warp and a cluster step, B from 1 to 4096, R
    from 1 to 41."""
    b, n, r = chip_smoke.NODE_EDGE_CASES[case]
    a = chip_smoke.node_edge_batch(np.random.default_rng(chip_smoke.SEED + 800 + case), b, n, r)
    avail, ok, req = a["node_avail"], a["node_ok"], a["requests"]
    want = np.asarray(JA._node_sum_estimate(*map(jnp.asarray, (avail, ok, req))))
    got = TA.node_sum_estimate_ref(*map(torch.from_numpy, (avail, ok, req)))
    assert got.dtype == torch.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TA._node_sum_estimate_np(avail, ok, req), want)


@pytest.mark.parametrize("extras", [0, 1, 2, 3, 5, 9])
def test_merge_table_ref_equals_jax(extras):
    """K1's merge form (plain version, and its wrapper on CPU tensors) ==
    JAX merge_estimates over (table[prof_inv], *extras), indices clipped as
    a jnp gather clips them."""
    rng = np.random.default_rng(30 + extras)
    u, b, c = 6, 50, 23
    table = rng.integers(-1, 400, (u, c)).astype(np.int32)
    table[rng.random((u, c)) < 0.1] = HI
    prof_inv = rng.integers(-2, u + 2, b).astype(np.int32)
    ex = []
    for _ in range(extras):
        e = rng.integers(-1, 300, (b, c)).astype(np.int32)
        e[rng.random((b, c)) < 0.1] = HI
        ex.append(e)
    reps = np.where(rng.random(b) < 0.15, 0, rng.integers(1, 90, b)).astype(np.int32)
    gathered = jnp.asarray(table)[jnp.asarray(prof_inv)]
    want = np.asarray(JO.merge_estimates(jnp.asarray(reps), (gathered, *map(jnp.asarray, ex))))
    targs = (torch.from_numpy(table), torch.from_numpy(prof_inv),
             tuple(map(torch.from_numpy, ex)), torch.from_numpy(reps))
    np.testing.assert_array_equal(TO.estimate_merge_table_ref(*targs).numpy(), want)
    np.testing.assert_array_equal(TO.estimate_merge_table(*targs).numpy(), want)
    assert TO.estimate_merge_table.launches == 0


@pytest.mark.parametrize("case", range(len(chip_smoke.ESTIMATE_EDGE_CASES)))
def test_estimate_forms_equal_jax_on_edge_batches(case):
    """K1's three plain versions (what its kernels are held to on the card)
    against the JAX programs on every ``chip_smoke.estimate_edge_batch``
    case: ``estimate_merge_ref`` against ``general_estimate`` -> the
    no-summary mask -> the row gather -> ``merge_estimates`` (and, its
    indices wrapped and clamped first, against ``general_estimate_interned``
    in the same composition); ``profile_table_ref`` against
    ``_profile_table``'s general branch (``general_estimate`` and the mask);
    ``estimate_merge_table_ref`` against ``merge_estimates`` over the
    gathered table and the E extras. Divisors 1, 2, 3, 7, 2^k and 2^k +- 1,
    2^40 and 2^63 - 1; capacities INT64_MIN, -1, 0, UNLIMITED - 1,
    UNLIMITED, INT64_MAX and multiples of the divisors with their
    neighbours; C from 1 to 16,385; U = 1, 64 and 65; negative and
    out-of-range profile indices; every row at zero replicas; E = 0, 1, 4,
    5, 32 and 33."""
    b, c, u, r, e, kind = chip_smoke.ESTIMATE_EDGE_CASES[case]
    a = chip_smoke.estimate_edge_batch(np.random.default_rng(chip_smoke.SEED + 1700 + case),
                                       b, c, u, r, e, kind)
    cap, prof, idx, summ, reps = (a[k] for k in ("available_cap", "profiles", "prof_idx",
                                                 "has_summary", "replicas"))
    extras = a["extras"]
    table = JO.general_estimate(jnp.asarray(cap), jnp.asarray(prof))
    masked = jnp.where(jnp.asarray(summ)[None, :], table, jnp.int32(-1))
    gathered = masked[jnp.asarray(idx)]
    want_merge = np.asarray(JO.merge_estimates(jnp.asarray(reps), (gathered,)))
    want_extras = np.asarray(JO.merge_estimates(
        jnp.asarray(reps), (gathered, *map(jnp.asarray, extras))))
    # the interned estimate on the same rows, indices wrapped and clamped
    inside = np.clip(np.where(idx < 0, idx + u, idx), 0, u - 1).astype(np.int32)
    interned = JO.general_estimate_interned(jnp.asarray(cap), jnp.asarray(prof),
                                            jnp.asarray(inside))
    interned = jnp.where(jnp.asarray(summ)[None, :], interned, jnp.int32(-1))
    np.testing.assert_array_equal(
        np.asarray(JO.merge_estimates(jnp.asarray(reps), (interned,))), want_merge)

    t = {k: torch.from_numpy(a[k]) for k in ("available_cap", "profiles", "prof_idx",
                                              "has_summary", "replicas")}
    got = TO.estimate_merge_ref(t["available_cap"], t["profiles"], t["prof_idx"],
                                t["has_summary"], t["replicas"])
    assert got.dtype == torch.int32 and got.shape == (b, c)
    np.testing.assert_array_equal(got.numpy(), want_merge)
    tab = TO.profile_table_ref(t["available_cap"], t["profiles"], t["has_summary"])
    assert tab.dtype == torch.int32 and tab.shape == (u, c)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(masked))
    merged = TO.estimate_merge_table_ref(tab, t["prof_idx"],
                                         tuple(map(torch.from_numpy, extras)), t["replicas"])
    np.testing.assert_array_equal(merged.numpy(), want_extras)
    assert len(extras) == e
    if kind == "zero_reps":
        assert (want_extras == 0).all()
    else:
        assert (idx < 0).any() and ((idx < -u) | (idx >= u)).any()


def test_merge_group_matches_the_kernel_source():
    """The merge form's wrapper allocates its scratch buffer past
    ``MERGE_GROUP`` extras: the kernel's group size (``MAX_EXTRAS`` in
    ``csrc/estimate_merge.cu``) must be the same, the group's pointers must
    travel in the kernel's by-value argument struct (one array of
    ``MAX_EXTRAS`` pointers, filled by the entry point from its host array),
    and a group must fit the kernel parameters' 4 KB with room to spare."""
    import os
    import re

    from karmada_tpu_torch import native

    with open(os.path.join(native.CSRC, "estimate_merge.cu")) as f:
        src = f.read()
    assert re.findall(r"constexpr int MAX_EXTRAS = (\d+);", src) == [str(TO.MERGE_GROUP)]
    assert re.findall(r"const int32_t\* p\[(\w+)\];", src) == ["MAX_EXTRAS"]
    assert "a.ex.p[k] = k < a.e_n ? extras[first + k] : nullptr;" in src
    assert TO.MERGE_GROUP * 8 <= 4096 - 512
    assert TO.MERGE_GROUP >= 32


def test_new_wrappers_raise_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain-version fallback."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        TA.node_sum_estimate(torch.empty((3, 4), dtype=torch.int64, **meta),
                             torch.empty((2, 3), dtype=torch.bool, **meta),
                             torch.empty((2, 4), dtype=torch.int64, **meta))
    with pytest.raises(ValueError):
        TM.model_overlay(torch.empty((2, 3), dtype=torch.int32, **meta),
                         torch.empty((3, 2, 4), dtype=torch.int64, **meta),
                         torch.empty((3, 2), dtype=torch.int32, **meta),
                         torch.empty((3, 4), dtype=torch.bool, **meta),
                         torch.empty((2, 4), dtype=torch.int64),
                         torch.empty((3,), dtype=torch.bool, **meta),
                         torch.empty((3,), dtype=torch.bool, **meta),
                         torch.empty((3, 4), dtype=torch.int64, **meta), -1)
    with pytest.raises(ValueError):
        TO.estimate_merge_table(torch.empty((2, 3), dtype=torch.int32, **meta),
                                torch.empty((4,), dtype=torch.int32, **meta), (),
                                torch.empty((4,), dtype=torch.int32, **meta))


# --------------------------------------------------------------------------
# node state, the accurate estimator and the registry
# --------------------------------------------------------------------------


def make_nodes(pkg_acc, pkg_cluster, n, seed, *, taints=False):
    """Seeded NodeStates of one package: 8-64 cores, 32-256 GiB, 110 pods,
    0-90% requested, some labelled and (with ``taints``) tainted."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cores = int(rng.integers(8, 65))
        mem = int(rng.integers(32, 257)) << 30
        f = float(rng.uniform(0.0, 0.9))
        node_taints = []
        if taints and rng.random() < 0.3:
            node_taints = [pkg_cluster.Taint(key="gpu", value="yes",
                                             effect=str(rng.choice(["NoSchedule", "PreferNoSchedule"])))]
        out.append(pkg_acc.NodeState(
            name=f"n{i}",
            allocatable={"cpu": cores * 1000, "memory": mem, "pods": 110},
            requested={"cpu": int(cores * 1000 * f), "memory": int(mem * f)},
            labels={"zone": f"z{i % 3}"},
            taints=node_taints,
            num_pods=int(110 * f),
        ))
    return out


def test_node_packing_equals_jax():
    """A NodeSnapshot or NodeCache built from the same NodeState list packs
    to the JAX objects' ``available`` arrays."""
    jn = make_nodes(JA, JC, 50, 3)
    tn = make_nodes(TA, TC, 50, 3)
    np.testing.assert_array_equal(TA.NodeSnapshot(tn, DIMS).available,
                                  JA.NodeSnapshot(jn, DIMS).available)
    jc, tc = JA.NodeCache(DIMS, jn), TA.NodeCache(DIMS, tn)
    np.testing.assert_array_equal(tc.available, jc.available)
    assert tc.generation == jc.generation == 50


def test_node_cache_event_stream_matches_full_repack():
    """NodeCache (incremental AddPod/RemovePod/Upsert/Remove) answers as a
    fresh NodeSnapshot repack of the surviving nodes after every event
    batch, and as the JAX NodeCache fed the same events."""
    rng = np.random.default_rng(4)
    tn, jn = make_nodes(TA, TC, 12, 5), make_nodes(JA, JC, 12, 5)
    cache, jcache = TA.NodeCache(DIMS, tn), JA.NodeCache(DIMS, jn)
    est = TA.AccurateEstimator("m1", cache, device="cpu")
    jest = JA.AccurateEstimator("m1", jcache)
    live = [f"n{i}" for i in range(12)]
    next_id = 12
    reqs = np.stack([np.array([int(rng.integers(100, 3000)), int(rng.integers(1, 8)) << 30,
                               1, 0], np.int64) for _ in range(6)])
    pod = {"cpu": 250, "memory": 512 << 20}
    for step in range(120):
        ev = rng.random()
        if ev < 0.45 and live:
            name = str(rng.choice(live))
            cache.add_pod(name, pod)
            jcache.add_pod(name, pod)
        elif ev < 0.65 and live:
            name = str(rng.choice(live))
            cache.remove_pod(name, pod)
            jcache.remove_pod(name, pod)
        elif ev < 0.8:
            for c_, pkg, cl in ((cache, TA, TC), (jcache, JA, JC)):
                node = make_nodes(pkg, cl, 1, 1000 + next_id)[0]
                node.name = f"n{next_id}"
                c_.upsert_node(node)
            live.append(f"n{next_id}")
            next_id += 1
        elif ev < 0.92 and len(live) > 2:
            gone = live.pop(int(rng.integers(len(live))))
            cache.remove_node(gone)
            jcache.remove_node(gone)
        elif live:
            name = str(rng.choice(live))
            cpu = int(rng.integers(4_000, 64_000))
            for c_ in (cache, jcache):
                node = c_.nodes[c_._rows[name]]
                node.allocatable["cpu"] = cpu
                c_.upsert_node(node)
        if step % 10 != 9:
            continue
        ref = TA.AccurateEstimator(
            "m1", TA.NodeSnapshot([copy.deepcopy(x) for x in cache.live_nodes()], DIMS),
            device="cpu")
        got = est.max_available_replicas(None, reqs)
        np.testing.assert_array_equal(got, ref.max_available_replicas(None, reqs))
        np.testing.assert_array_equal(got, jest.max_available_replicas(None, reqs))
        np.testing.assert_array_equal(cache.available, jcache.available)


def test_prefilter_and_quota_plugin_equal_jax():
    """The node-selector and taint prefilter, and ResourceQuotaPlugin under
    its feature gate (off by default: no cap), answer as the JAX
    estimator's. 3 x 1400 nodes puts the batch above the host rule, so the
    node sum takes K8's path (its plain version here)."""
    jn, tn = make_nodes(JA, JC, 1400, 6, taints=True), make_nodes(TA, TC, 1400, 6, taints=True)
    quotas = {"team-a": {"cpu": 40_000, "memory": 64 << 30}}
    jest = JA.AccurateEstimator("m", JA.NodeSnapshot(jn, DIMS), JA.ResourceQuotaPlugin(quotas))
    test = TA.AccurateEstimator("m", TA.NodeSnapshot(tn, DIMS), TA.ResourceQuotaPlugin(quotas),
                                device="cpu")
    rows = np.array([[500, 1 << 30, 1, 0], [2000, 4 << 30, 1, 0], [0, 0, 0, 0]], np.int64)
    claims = [
        None,
        dict(node_selector={"zone": "z1"}),
        dict(tolerations=[{"key": "gpu", "operator": "Exists"}]),
        dict(node_selector={"zone": "z2"}, tolerations=[{"key": "other", "operator": "Exists"}]),
    ]
    for gate in (False, True):
        JF.feature_gate.set(JF.RESOURCE_QUOTA_ESTIMATE, gate)
        TF.feature_gate.set(TF.RESOURCE_QUOTA_ESTIMATE, gate)
        try:
            for claim in claims:
                for ns in ("team-a", "team-b"):
                    jr = JW.ReplicaRequirements(
                        resource_request={"cpu": 500}, namespace=ns,
                        node_claim=None if claim is None else JW.NodeClaim(**claim))
                    tr = TW.ReplicaRequirements(
                        resource_request={"cpu": 500}, namespace=ns,
                        node_claim=None if claim is None else TW.NodeClaim(**claim))
                    np.testing.assert_array_equal(test._node_prefilter(tr), jest._node_prefilter(jr))
                    np.testing.assert_array_equal(test.max_available_replicas(tr, rows),
                                                  jest.max_available_replicas(jr, rows))
                    np.testing.assert_array_equal(test.max_available_replicas(tr),
                                                  jest.max_available_replicas(jr))
        finally:
            JF.feature_gate.set(JF.RESOURCE_QUOTA_ESTIMATE, False)
            TF.feature_gate.set(TF.RESOURCE_QUOTA_ESTIMATE, False)
    assert not test._node_prefilter(TW.ReplicaRequirements(
        node_claim=TW.NodeClaim(node_selector={"zone": "z1"}))).all()
    capped = TW.ReplicaRequirements(resource_request={"cpu": 500}, namespace="team-a")
    TF.feature_gate.set(TF.RESOURCE_QUOTA_ESTIMATE, True)
    try:
        assert int(test.max_available_replicas(capped)[0]) == 80  # 40 cores / 500m
    finally:
        TF.feature_gate.set(TF.RESOURCE_QUOTA_ESTIMATE, False)


def test_registry_memo_and_generation_gate():
    """The registry memoizes per (cluster, profile bytes) with the JAX
    registry's keys, answers a repeated batch from the memo, re-fetches
    only a cluster whose generation moved after ``invalidate()``, and
    answers -1 for clusters it does not serve."""
    names = ["a", "b", "c"]
    regs, fns, ests = {}, {}, {}
    for pkg, cl, key in ((TA, TC, "t"), (JA, JC, "j")):
        reg = regs[key] = pkg.EstimatorRegistry()
        for i, name in enumerate(names[:2]):
            kw = {"device": "cpu"} if pkg is TA else {}
            est = pkg.AccurateEstimator(name, pkg.NodeCache(DIMS, make_nodes(pkg, cl, 30, i)), **kw)
            est.calls = 0
            inner = est.max_available_replicas

            def counted(*a, _est=est, _inner=inner):
                _est.calls += 1
                return _inner(*a)

            est.max_available_replicas = counted
            reg.register(est)
            ests[key, name] = est
        fns[key] = reg.make_batch_estimator(names)
    rng = np.random.default_rng(7)
    reqs = np.stack([[250 * k, (512 << 20) * k, 1, 0] for k in rng.integers(1, 5, 20)]).astype(np.int64)
    reps = rng.integers(0, 5, 20).astype(np.int32)
    want = fns["j"](jnp.asarray(reqs), jnp.asarray(reps))
    got = fns["t"](torch.from_numpy(reqs), torch.from_numpy(reps))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 2] == -1).all() and (got[reps == 0] == -1).all()
    assert regs["t"]._memo == regs["j"]._memo  # same keys, same answers
    assert [ests["t", n].calls for n in names[:2]] == [1, 1]
    fns["t"](torch.from_numpy(reqs), torch.from_numpy(reps))  # memo hit
    assert [ests["t", n].calls for n in names[:2]] == [1, 1]
    tok = fns["t"].refresh_token()
    assert tok is not None and fns["t"].refresh_token() == tok
    assert not fns["t"].unanswered
    # a pod event on "b", then a generation-gated invalidate
    for key in ("t", "j"):
        ests[key, "b"].snapshot.add_pod("n0", {"cpu": 1000, "memory": 1 << 30})
        regs[key].invalidate()
    got = fns["t"](torch.from_numpy(reqs), torch.from_numpy(reps))
    np.testing.assert_array_equal(got, np.asarray(fns["j"](jnp.asarray(reqs), jnp.asarray(reps))))
    assert [ests["t", n].calls for n in names[:2]] == [1, 2]
    assert fns["t"].refresh_token() != tok


def test_invalidate_reconfirms_every_cluster():
    """``invalidate()`` trusts no earlier confirmation: a pod event after
    a pass moves the refresh token before any fetch, so the scheduler's
    replay cannot serve the old answers, and a cluster whose generation
    did not move keeps its memo."""
    names = ["a", "b"]
    reg = TA.EstimatorRegistry()
    ests = {n: TA.AccurateEstimator(n, TA.NodeCache(DIMS, make_nodes(TA, TC, 30, i)),
                                    device="cpu")
            for i, n in enumerate(names)}
    for est in ests.values():
        reg.register(est)
    fn = reg.make_batch_estimator(names)
    reqs = torch.tensor([[500, 1 << 30, 1, 0]], dtype=torch.int64)
    fn(reqs, torch.tensor([3], dtype=torch.int32))
    tok = fn.refresh_token()
    assert tok is not None and set(reg._confirmed) == set(names)
    reg.invalidate()
    assert not reg._confirmed and fn.refresh_token() == tok  # nothing moved
    ests["b"].snapshot.add_pod("n0", {"cpu": 1000, "memory": 1 << 30})
    reg.invalidate()
    assert fn.refresh_token() != tok
    assert {k[0] for k in reg._memo} == {"a"}
