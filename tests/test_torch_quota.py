"""The port's quota plane against the JAX package's, on the CPU: K12's plain
version (``quota_admit_ref``) against ``karmada_tpu.ops.quota.quota_admit``,
K13's plain versions (``cluster_caps_ref``, the fold ``quota_caps_fold_ref``)
and the numpy mirror against ``quota_cluster_caps``, ``cluster_caps_np``
and the JAX engine's ``_profile_table_quota`` rule, the wrappers on CPU
tensors, and ``build_quota_snapshot`` field by field. Inputs come from
numpy seeds. Tolerance: exact equality (0) everywhere: every output is an
integer or a flag.

The kernels themselves run on the card only (``python3 chip_smoke.py``
holds each to its plain version there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import karmada_tpu
import karmada_tpu.ops.quota as JQ
import karmada_tpu.refimpl.quota_np as JR
import karmada_tpu.scheduler.quota as JSQ
import karmada_tpu.utils.builders  # noqa: F401  (chip_smoke builds by name)

import karmada_tpu_torch
import karmada_tpu_torch.ops.quota as TQ
import karmada_tpu_torch.refimpl.quota_np as TR
import karmada_tpu_torch.scheduler.quota as TSQ
from karmada_tpu_torch.utils import reasons as TREASONS

import chip_smoke

UNL = TQ.UNLIMITED


def jax_admit(ns, demand, remaining):
    a, w = JQ.quota_admit(jnp.asarray(ns), jnp.asarray(demand), jnp.asarray(remaining))
    return np.asarray(a), np.asarray(w)


def port_admit(fn, ns, demand, remaining):
    a, w = fn(*map(torch.from_numpy, (np.asarray(ns, np.int32), np.asarray(demand, np.int64),
                                      np.asarray(remaining, np.int64))))
    assert a.dtype == torch.bool and w.dtype == torch.int64
    return a.numpy(), w.numpy()


def assert_admit_equal(ns, demand, remaining):
    want = jax_admit(ns, demand, remaining)
    for fn in (TQ.quota_admit_ref, TQ.quota_admit):
        got = port_admit(fn, ns, demand, remaining)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    return want


# --------------------------------------------------------------------------
# K12: admission
# --------------------------------------------------------------------------

ADMIT_CASES = {
    # first-come wins: a denied row's demand holds its place in line
    "fifo_head_of_line": ([0, 0, 0], [[6], [6], [3]], [[10]]),
    "unquotad_rows_always_admit": ([-1, 0, -1], [[100], [100], [100]], [[0]]),
    "unlimited_dim_never_constrains": ([0, 0], [[5, 10**9], [5, 10**9]], [[10, UNL]]),
    "multi_dim_all_must_fit": ([0, 0], [[5, 5], [5, 5]], [[100, 7]]),
    "interleaved_namespaces_keep_arrival_order": (
        [0, 1, 0, 1, 0], [[4], [9], [4], [9], [4]], [[9], [18]]),
    # ids at or above N: JAX's gather clamps onto the UNLIMITED pad row and
    # its scatter-add drops them
    "ids_at_or_above_n": ([2, 0, 5, 1, 2, -3], [[7], [3], [9], [4], [1], [2]], [[3], [2]]),
    "zero_rows": ([], np.zeros((0, 2), np.int64), [[1, 1]]),
    "no_namespace": ([-1, -1], [[1], [2]], np.zeros((0, 1), np.int64)),
}


@pytest.mark.parametrize("case", sorted(ADMIT_CASES))
def test_quota_admit_cases_equal_jax(case):
    ns, demand, remaining = ADMIT_CASES[case]
    ns = np.asarray(ns, np.int32)
    remaining = np.asarray(remaining, np.int64)
    demand = np.asarray(demand, np.int64).reshape(len(ns), remaining.shape[1])
    admitted, used = assert_admit_equal(ns, demand, remaining)
    if case == "fifo_head_of_line":
        assert admitted.tolist() == [True, False, False] and used.tolist() == [[6]]
    if case == "ids_at_or_above_n":
        assert admitted[[0, 2, 4]].all()  # unlimited: admitted, never charged


@pytest.mark.parametrize("seed", range(6))
def test_quota_admit_fuzz_equals_jax_and_oracle(seed):
    """Random waves: ids over -2..N+1, zero and clamp-sized demand,
    unlimited and tight dims; the port equals JAX, and for in-range ids the
    sequential oracle (the port's copy of refimpl/quota_np.py)."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        b = int(rng.integers(1, 400))
        n = int(rng.integers(1, 9))
        r = int(rng.integers(1, 5))
        ns = rng.integers(-2, n + 2, b).astype(np.int32)
        demand = rng.integers(0, 40, (b, r)).astype(np.int64)
        demand[rng.random((b, r)) < 0.05] = JQ.DEMAND_CLAMP
        remaining = rng.integers(0, 400, (n, r)).astype(np.int64)
        remaining[rng.random((n, r)) < 0.25] = UNL
        admitted, used = assert_admit_equal(ns, demand, remaining)
        ins = np.where(ns >= n, -1, ns)
        flags, u_np = TR.admit_wave_np(ins.tolist(), demand, remaining)
        np.testing.assert_array_equal(admitted, flags)
        np.testing.assert_array_equal(used, u_np)
        assert TR.admit_wave_np(ins.tolist(), demand, remaining)[0] == \
            JR.admit_wave_np(ins.tolist(), demand, remaining)[0]


@pytest.mark.parametrize("r", [17, 40])
def test_quota_admit_past_16_dims_equals_jax_and_oracle(r):
    """More dims than one tile of K12's shared memory (16): admission is
    the AND over every dim, so a row denied on dim 16 alone, or on dim 39
    alone, is denied; the plain version equals JAX and the sequential
    oracle. Each namespace binds on one dim of the last tile, or of the
    first."""
    rng = np.random.default_rng(r)
    b, n = 600, 5
    ns = rng.integers(-1, n + 1, b).astype(np.int32)
    demand = rng.integers(0, 30, (b, r)).astype(np.int64)
    demand[rng.random((b, r)) < 0.05] = 0
    remaining = np.full((n, r), 10**9, np.int64)
    remaining[rng.random((n, r)) < 0.3] = UNL
    for k in range(n):
        dim = r - 1 - k if k % 2 == 0 else k
        remaining[k, dim] = int(demand[ns == k, dim].sum()) // 2
    admitted, used = assert_admit_equal(ns, demand, remaining)
    ins = np.where(ns >= n, -1, ns)
    flags, u_np = TR.admit_wave_np(ins.tolist(), demand, remaining)
    np.testing.assert_array_equal(admitted, flags)
    np.testing.assert_array_equal(used, u_np)
    inq = (ns >= 0) & (ns < n)
    assert admitted[inq].any() and not admitted[inq].all()


@pytest.mark.parametrize("case", chip_smoke.ADMIT_EDGE_CASES)
def test_quota_admit_edge_cases_equal_jax(case):
    """``chip_smoke.admit_edge_batch``, the batches K12 is held to on the
    card: B = 1, a ragged wave, N = 0 and 1, every row unquota'd or at an id
    at or above N, namespaces in runs across and along the sort tiles,
    2^17 clamp-sized rows summing to 2^61, remaining 0 and UNLIMITED, a
    denied row holding its place in line, R = 1, 16, 17 and 40. The plain
    version equals JAX, and for in-range ids the sequential oracle."""
    a = chip_smoke.admit_edge_batch(case)
    ns, demand, remaining = a["ns_ids"], a["demand"], a["remaining"]
    admitted, used = assert_admit_equal(ns, demand, remaining)
    n = remaining.shape[0]
    inq = (ns >= 0) & (ns < n)
    if case != "clamp":  # the oracle's Python loop at 2^17 rows is slow, not wrong
        flags, u_np = TR.admit_wave_np(np.where(inq, ns, -1).tolist(), demand, remaining)
        np.testing.assert_array_equal(admitted, flags)
        np.testing.assert_array_equal(used, u_np)
    assert admitted[~inq].all()
    if case in ("n0", "unquotad", "past_n", "unlimited"):
        assert admitted.all()
    if case in ("n0", "unquotad", "past_n"):
        assert not used.any()
    if case == "clamp":
        assert admitted[:-1].all() and not admitted[-1]
        assert used.tolist() == [[(TQ.MAX_ADMIT_ROWS - 1) * TQ.DEMAND_CLAMP] * 2]
    if case == "head_of_line":
        even = np.arange(len(ns)) % 2 == 0
        assert admitted[even][:100].all() and not admitted[even][100:].any()
        assert admitted[~even][:-1].all() and not admitted[-1]
    if case == "remaining0":
        half = len(ns) // 2
        assert admitted[:half].all() and not admitted[half:][inq[half:]].any()
    if case in ("ragged", "runs", "tile_runs", "r1", "r16", "r17", "r40"):
        assert admitted[inq].any() and not admitted[inq].all()


def test_demand_clamp_headroom():
    """A wave of clamp-sized demands at the row bound cannot overflow."""
    b = TQ.MAX_ADMIT_ROWS
    ns = np.zeros(b, np.int32)
    demand = np.full((b, 1), TQ.DEMAND_CLAMP, np.int64)
    admitted, used = assert_admit_equal(ns, demand, np.array([[UNL]], np.int64))
    assert admitted.all() and int(used[0, 0]) == b * TQ.DEMAND_CLAMP


def test_quota_admit_rejects_over_bound_waves():
    """JAX asserts the row bound at trace time; the port raises."""
    b = TQ.MAX_ADMIT_ROWS + 1
    args = (torch.zeros(b, dtype=torch.int32), torch.zeros((b, 1), dtype=torch.int64),
            torch.zeros((1, 1), dtype=torch.int64))
    with pytest.raises(AssertionError):
        JQ.quota_admit(*(jnp.asarray(a.numpy()) for a in args))
    for fn in (TQ.quota_admit_ref, TQ.quota_admit):
        with pytest.raises(ValueError):
            fn(*args)


# --------------------------------------------------------------------------
# K13: caps, per-row form, numpy mirror and fold
# --------------------------------------------------------------------------


def caps_inputs(rng, n, c, r, b, negative=True):
    caps = rng.integers(-300 if negative else 0, 1000, (n, c, r)).astype(np.int64)
    caps[rng.random((n, c, r)) < 0.3] = UNL
    caps[rng.random((n, c, r)) < 0.05] = UNL - 1
    rows = rng.integers(-1, n, b).astype(np.int32)
    req = rng.integers(0, 30, (b, r)).astype(np.int64)
    req[rng.random((b, r)) < 0.3] = 0
    req[0] = 10**15  # huge: only an UNLIMITED cap answers MAX_INT32
    return caps, rows, req


@pytest.mark.parametrize("seed", range(5))
def test_cluster_caps_equal_jax(seed):
    """Negative caps (JAX floors, C++ truncates), UNLIMITED and just below
    it, zero requests, huge requests: the plain version, the wrapper on CPU
    tensors and the numpy mirror equal the jitted JAX kernel, and the
    sequential oracle row by row."""
    rng = np.random.default_rng(seed)
    negative = False
    for _ in range(6):
        n, c, r = (int(rng.integers(1, 6)), int(rng.integers(1, 40)),
                   int(rng.integers(1, 5)))
        caps, rows, req = caps_inputs(rng, n, c, r, int(rng.integers(1, 60)))
        want = np.asarray(JQ.quota_cluster_caps(*map(jnp.asarray, (caps, rows, req))))
        t = tuple(map(torch.from_numpy, (caps, rows, req)))
        np.testing.assert_array_equal(TQ.cluster_caps_ref(*t).numpy(), want)
        np.testing.assert_array_equal(TQ.quota_cluster_caps(*t).numpy(), want)
        np.testing.assert_array_equal(TQ.cluster_caps_np(caps, rows, req), want)
        np.testing.assert_array_equal(JQ.cluster_caps_np(caps, rows, req), want)
        assert TQ.quota_cluster_caps(*t).dtype == torch.int32
        negative |= bool((want < 0).any())
        nonneg = np.maximum(caps, 0)
        got = TQ.cluster_caps_np(nonneg, rows, req)
        for i in range(len(rows)):
            np.testing.assert_array_equal(
                got[i], TR.cluster_caps_seq(nonneg, int(rows[i]), req[i]))
    assert negative  # negative caps reach the answers


def test_cluster_caps_rows_at_or_above_n_read_the_last_row():
    """A jnp gather clamps; the port's plain version and mirror do too."""
    rng = np.random.default_rng(9)
    caps, _, req = caps_inputs(rng, 3, 7, 2, 5)
    rows = np.array([3, 7, 2, -1, 0], np.int32)
    want = np.asarray(JQ.quota_cluster_caps(*map(jnp.asarray, (caps, rows, req))))
    t = tuple(map(torch.from_numpy, (caps, rows, req)))
    np.testing.assert_array_equal(TQ.cluster_caps_ref(*t).numpy(), want)
    np.testing.assert_array_equal(TQ.cluster_caps_np(caps, rows, req), want)


@pytest.mark.parametrize("case", range(len(chip_smoke.CAPS_EDGE_CASES)))
def test_cluster_caps_equal_jax_on_edge_batches(case):
    """K13's plain version (what its per-row kernel is held to on the card)
    and the numpy mirror against the JAX ``quota_cluster_caps`` on every
    ``chip_smoke.caps_edge_batch`` case: divisors 1, 2, 3, 7, 2^k and 2^k +- 1
    (k = 31, 32, 62), 2^40 and 2^63 - 1; caps INT64_MIN, -1, 0, UNLIMITED - 1,
    UNLIMITED, INT64_MAX, multiples of the divisors and their neighbours, and
    quotients below -2^31 (the int32 wrap); C from 1 to 16,385 about the 4-
    and 512-cell steps; ids -1, past N and one namespace for every row; R =
    1, 4, 17 and 41."""
    b, c, n, r, kind = chip_smoke.CAPS_EDGE_CASES[case]
    a = chip_smoke.caps_edge_batch(np.random.default_rng(chip_smoke.SEED + 1600 + case),
                                   b, c, n, r, kind)
    caps, rows, req = a["caps"], a["ns_rows"], a["requests"]
    want = np.asarray(JQ.quota_cluster_caps(*map(jnp.asarray, (caps, rows, req))))
    t = tuple(map(torch.from_numpy, (caps, rows, req)))
    got = TQ.cluster_caps_ref(*t)
    assert got.dtype == torch.int32 and got.shape == (b, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TQ.cluster_caps_np(caps, rows, req), want)
    if kind == "one":
        assert (rows == rows[0]).all() and rows[0] >= 0
    else:  # uncapped rows and ids past N are posed
        assert (rows < 0).any() and (rows >= n).any()


@pytest.mark.parametrize("case", ["uncapped", "unlimited_huge_request", "min_over_dims"])
def test_cluster_caps_cases(case):
    if case == "uncapped":
        caps, rows, req = np.full((1, 3, 2), 10), [-1], [[5, 5]]
        want = [[TQ.MAX_INT32] * 3]
    elif case == "unlimited_huge_request":
        caps, rows, req = np.full((1, 1, 1), UNL), [0], [[2**40]]
        want = [[TQ.MAX_INT32]]
    else:
        caps, rows, req = [[[12, 9]]], [0, 0], [[4, 3], [4, 0]]
        want = [[3], [3]]
    t = (torch.tensor(caps, dtype=torch.int64), torch.tensor(rows, dtype=torch.int32),
         torch.tensor(req, dtype=torch.int64))
    assert TQ.cluster_caps_ref(*t).tolist() == want
    assert np.asarray(JQ.quota_cluster_caps(
        *(jnp.asarray(x.numpy()) for x in t))).tolist() == want


@pytest.mark.parametrize("seed", range(4))
def test_caps_fold_equals_the_jax_rule(seed):
    """K13's fold over a profile table with -1 (no summary) cells, uncapped
    profiles and negative caps equals the JAX engine's
    ``_profile_table_quota`` expression over ``quota_cluster_caps``."""
    rng = np.random.default_rng(seed)
    n, c, r, u = 4, 30, 3, 16
    caps, _, profiles = caps_inputs(rng, n, c, r, u)
    prof_ns = rng.integers(-1, n, u).astype(np.int32)
    table = rng.integers(-1, 500, (u, c)).astype(np.int32)
    table[rng.random((u, c)) < 0.2] = -1
    table[rng.random((u, c)) < 0.05] = TQ.MAX_INT32
    caps_out = JQ.quota_cluster_caps(*map(jnp.asarray, (caps, prof_ns, profiles)))
    mi = jnp.int32(2**31 - 1)
    jt = jnp.asarray(table)
    want = np.asarray(jnp.where(caps_out < mi,
                                jnp.minimum(jnp.where(jt < 0, mi, jt), caps_out), jt))
    for fn in (TQ.quota_caps_fold_ref, TQ.quota_caps_fold):
        t = torch.from_numpy(table.copy())
        out = fn(t, *map(torch.from_numpy, (caps, prof_ns, profiles)))
        assert out is t  # in place
        np.testing.assert_array_equal(t.numpy(), want)
    # a capped no-summary cell takes the cap
    assert ((table == -1) & (want >= 0)).any()


def test_wrappers_take_the_plain_version_on_cpu_and_refuse_other_devices():
    for fn in (TQ.quota_admit, TQ.quota_cluster_caps, TQ.quota_caps_fold):
        fn.launches = 0
    rng = np.random.default_rng(3)
    caps, rows, req = caps_inputs(rng, 2, 5, 2, 4)
    t = tuple(map(torch.from_numpy, (caps, rows, req)))
    TQ.quota_cluster_caps(*t)
    TQ.quota_caps_fold(torch.zeros((4, 5), dtype=torch.int32), *t)
    TQ.quota_admit(torch.zeros(4, dtype=torch.int32), torch.zeros((4, 2), dtype=torch.int64),
                   torch.zeros((1, 2), dtype=torch.int64))
    assert TQ.quota_admit.launches == TQ.quota_cluster_caps.launches == \
        TQ.quota_caps_fold.launches == 0
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        TQ.quota_admit(torch.empty(4, dtype=torch.int32, **meta),
                       torch.empty((4, 2), dtype=torch.int64, **meta),
                       torch.empty((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        TQ.quota_cluster_caps(torch.empty((2, 5, 2), dtype=torch.int64, **meta),
                              torch.empty(4, dtype=torch.int32, **meta),
                              torch.empty((4, 2), dtype=torch.int64, **meta))


def test_constants_equal_jax():
    assert (TQ.UNLIMITED, TQ.DEMAND_CLAMP, TQ.MAX_ADMIT_ROWS, TQ.MAX_INT32) == (
        JQ.UNLIMITED, JQ.DEMAND_CLAMP, JQ.MAX_ADMIT_ROWS, JQ.MAX_INT32)
    assert TSQ.QUOTA_EXCEEDED_ERROR == JSQ.QUOTA_EXCEEDED_ERROR
    assert TSQ.QUOTA_EXCEEDED_REASON == JSQ.QUOTA_EXCEEDED_REASON == "QuotaExceeded"
    from karmada_tpu.utils import reasons as JREASONS

    assert TREASONS.STAGE_REASONS == JREASONS.STAGE_REASONS
    for err in ("", "namespace quota exceeded", "no affinity group fits", "other"):
        assert TREASONS.classify_error(err) == JREASONS.classify_error(err)


# --------------------------------------------------------------------------
# the quota snapshot
# --------------------------------------------------------------------------


class Store:
    """The duck-typed store ``usage_from_bindings`` lists from: bound
    ResourceBindings of the JAX package's API (the port keeps no store)."""

    def __init__(self, rows):
        from karmada_tpu.api import work

        self.items = []
        for ns, reps, req in rows:
            rb = work.ResourceBinding()
            rb.meta.namespace = ns
            rb.spec.clusters = [work.TargetCluster(name="member-0", replicas=reps)]
            rb.spec.replica_requirements = work.ReplicaRequirements(resource_request=req)
            self.items.append(rb)

    def list(self, kind):
        return self.items if kind == "ResourceBinding" else []


@pytest.mark.parametrize("variant", ["generous", "reconciled", "live_usage", "caps"])
def test_build_quota_snapshot_equals_jax(variant):
    """Both packages pack the same FRQs against the same snapshot: every
    field, ``cap_token`` included, is equal."""
    store = Store([("nsq01", 3, {"cpu": 500}), ("nsq02", 2, {"cpu": 100, "pods": 2})])
    snaps = []
    for pkg, mod in ((karmada_tpu, JSQ), (karmada_tpu_torch, TSQ)):
        snap, _ = chip_smoke.quota_workload(pkg, 64, 40)
        limits = {ns: dict(chip_smoke.GENEROUS) for ns in chip_smoke.QUOTA_NAMESPACES[:6]}
        limits["nsq01"] = {"cpu": 7000, "pods": 50, "not-a-dim": 3}
        used = None
        caps = {}
        if variant in ("reconciled", "caps"):
            used = {ns: {"cpu": 1000 * k} for k, ns in enumerate(sorted(limits))}
        if variant == "caps":
            caps = {"nsq00": {snap.names[0]: {"cpu": 2000}, snap.names[3]: {"cpu": -5}},
                    "nsq03": {snap.names[1]: {"cpu": 9000, "memory": 1 << 30},
                              "unknown-cluster": {"cpu": 1}}}
        frqs = chip_smoke.quota_frqs(pkg, snap, limits, used, caps)
        if variant == "caps":  # two FRQs in one namespace compose by min
            frqs += chip_smoke.quota_frqs(pkg, snap, {"nsq00": {"cpu": 5000}}, None,
                                          {"nsq00": {snap.names[0]: {"cpu": 1000}}})
        # unreconciled FRQs read their namespace's live usage from the store
        snaps.append(mod.build_quota_snapshot(
            frqs, snap, 7, store=store if variant == "live_usage" else None))
    j, t = snaps
    assert (t.dims, t.ns_index, t.cap_index, t.generation, t.cap_token) == (
        j.dims, j.ns_index, j.cap_index, j.generation, j.cap_token)
    np.testing.assert_array_equal(t.remaining, j.remaining)
    np.testing.assert_array_equal(t.cluster_caps, j.cluster_caps)
    assert t.remaining.dtype == t.cluster_caps.dtype == np.int64
    assert t.active and t.has_caps == (variant == "caps")
    if variant == "live_usage":
        assert t.remaining[t.ns_index["nsq01"], 0] == 7000 - 3 * 500
    assert TSQ.build_quota_snapshot([], snap, 1) is None


def test_usage_from_bindings_equals_jax():
    store = Store([("a", 3, {"cpu": 500}), ("a", 2, {"cpu": 100, "pods": 2}),
                   ("b", 0, {"cpu": 9}), ("c", 4, {})])
    assert TSQ.usage_from_bindings(store, ["a", "b", "c"]) == \
        JSQ.usage_from_bindings(store, ["a", "b", "c"])


def test_demand_row_scale_cannot_wrap():
    """An absurd-but-legal request times a huge replica delta clamps; the
    scale runs in Python ints, so it never wraps to zero or below."""
    for mod in (TSQ, JSQ):
        q = mod.QuotaSnapshot(
            dims=["cpu", "memory", "pods"], ns_index={"a": 0},
            remaining=np.zeros((1, 3), np.int64), cap_index={},
            cluster_caps=np.zeros((0, 1, 3), np.int64), generation=1, cap_token=0,
        )
        row = q.demand_row({"memory": 2**43}, 2**21)  # int64 would wrap to 0
        assert row.tolist() == [0, JQ.DEMAND_CLAMP, 2**21]
        row2 = q.demand_row({"memory": 2**43}, 2**21 - 1)  # would wrap below 0
        assert (row2 >= 0).all() and row2[1] == JQ.DEMAND_CLAMP
        assert q.demand_row({"cpu": 5}, -3).tolist() == [0, 0, 0]
    assert TSQ.per_replica_vector({"cpu": 7}, ["cpu", "pods"]).tolist() == \
        JSQ.per_replica_vector({"cpu": 7}, ["cpu", "pods"]).tolist() == [7, 1]
