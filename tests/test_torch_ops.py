"""The port's tensor ops against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays. Tolerance: exact equality — every output is an integer
placement, availability or flag, so a difference of one is a fault.

On the CPU the port's wrappers (``estimate_merge``, ``divide_replicas``) run
their plain torch versions; the hand-written kernels are held to those plain
versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import karmada_tpu.ops as J
from karmada_tpu.scheduler.core import kernel_variant as jax_kernel_variant

from karmada_tpu_torch import ops as T
from karmada_tpu_torch.refimpl import assign_batch_np
from karmada_tpu_torch.scheduler.core import kernel_variant

import chip_smoke

HI = 2**31 - 1


def divide_batch(rng, b, c, *, wmax, pmax, nmax, big_rows=0.0):
    """Random divide inputs over every strategy and cohort: weights below
    ``wmax``, previous counts below ``pmax``, replicas below ``nmax``; with
    ``big_rows`` a share of rows carries near-int32 values."""
    strategy = rng.integers(0, 4, b).astype(np.int32)
    replicas = rng.integers(0, nmax, b).astype(np.int32)
    cand = rng.random((b, c)) < rng.uniform(0.1, 1.0, (b, 1))
    static_w = rng.integers(0, wmax, (b, c)).astype(np.int32)
    static_w[rng.random(b) < 0.15] = 0  # all-zero static weights
    avail = rng.integers(0, wmax, (b, c)).astype(np.int32)
    prev = np.where(
        rng.random((b, c)) < 0.3, rng.integers(0, pmax, (b, c)), 0
    ).astype(np.int32)
    fresh = rng.random(b) < 0.25
    for i in np.flatnonzero(rng.random(b) < 0.15):  # steady rows
        prev[i] = 0
        sites = np.flatnonzero(cand[i])[:2]
        if sites.size:
            prev[i, sites[0]] = replicas[i]
    big = rng.random(b) < big_rows
    nb = int(big.sum())
    if nb:
        avail[big] = rng.integers(HI - 100, HI, (nb, c))
        static_w[big] = rng.integers(HI - 100, HI, (nb, c))
        prev[big] = np.where(rng.random((nb, c)) < 0.5, HI - 3, 0)
        replicas[big] = rng.integers(HI - 50, HI, nb)
    return strategy, replicas, cand, static_w, avail, prev, fresh


def jax_divide(args, **kw):
    res = J.divide_replicas(*map(jnp.asarray, args), **kw)
    return np.asarray(res.assignment), np.asarray(res.unschedulable)


def torch_divide(args, **kw):
    res = T.divide_replicas(*map(torch.from_numpy, args), **kw)
    assert res.assignment.dtype == torch.int32
    assert res.unschedulable.dtype == torch.bool
    return res.assignment.numpy(), res.unschedulable.numpy()


def variant_of(args):
    strategy, replicas, cand, static_w, avail, prev, fresh = args
    bounds = (
        int(avail.max(initial=0)), int(static_w.max(initial=0)),
        int(prev.max(initial=0)), int(replicas.max(initial=0)), cand.shape[1],
    )
    got = kernel_variant(*bounds)
    assert got == jax_kernel_variant(*bounds)
    return got


# (b, c, wmax, pmax, nmax, big_rows) -> the variant kernel_variant picks
VARIANTS = {
    "fast_idx_f32": (64, 40, 30, 15, 40, 0.0),
    "fast_idx_int": (64, 16, 1 << 16, 15, 300, 0.0),
    "fast_noidx": (48, 300, 1 << 19, 1 << 8, 200, 0.0),
    "narrow_no_fast": (8, 1500, 600, 40, 3000, 0.0),
    "wide": (64, 40, 30, 15, 40, 0.1),
}


def check_variant(name, args, wide, fast):
    if name == "wide":
        assert wide and fast is None
    elif name == "narrow_no_fast":
        assert not wide and fast is None
    else:
        assert not wide and fast is not None
        assert fast[4] == (name != "fast_noidx")
        assert fast[3] == (name == "fast_idx_f32")


@pytest.mark.parametrize("has_aggregated", [True, False])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_divide_ref_equals_jax_every_variant(name, has_aggregated):
    b, c, wmax, pmax, nmax, big = VARIANTS[name]
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    args = divide_batch(rng, b, c, wmax=wmax, pmax=pmax, nmax=nmax, big_rows=big)
    if not has_aggregated:  # the static flag is only sound without AGG rows
        args[0][args[0] == J.AGGREGATED] = J.DYNAMIC_WEIGHT
    wide, fast = variant_of(args)
    check_variant(name, args, wide, fast)
    want = jax_divide(args, has_aggregated=has_aggregated, wide=wide, fast=fast)
    got = torch_divide(args, has_aggregated=has_aggregated, wide=wide, fast=fast)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    if name != "wide":  # the numpy divider's packed key needs bounded values
        np_out, np_unsched = assign_batch_np(*args)
        np.testing.assert_array_equal(got[1], np_unsched)
        np.testing.assert_array_equal(got[0], np_out)


@pytest.mark.parametrize("seed", range(3))
def test_divide_ref_equals_jax_wrapping_int32(seed):
    """Negative and near-int32 inputs, where the JAX kernel's int32
    arithmetic wraps: the plain version wraps the same way."""
    rng = np.random.default_rng(100 + seed)
    b, c = 48, int(rng.integers(1, 24))

    def pick(shape):
        sel = rng.random(shape)
        return np.where(
            sel < 0.6, rng.integers(0, 30, shape),
            np.where(sel < 0.9, rng.integers(HI - 50, HI, shape),
                     rng.integers(-HI - 1, 0, shape)),
        ).astype(np.int32)

    args = (
        rng.integers(0, 4, b).astype(np.int32),
        np.where(rng.random(b) < 0.7, rng.integers(0, 40, b),
                 rng.integers(HI - 100, HI, b)).astype(np.int32),
        rng.random((b, c)) < 0.7, pick((b, c)), pick((b, c)), pick((b, c)),
        rng.random(b) < 0.3,
    )
    want = jax_divide(args)
    got = torch_divide(args)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


EDGE_KINDS = {
    "all_equal_weights": 0,
    "tied_weight_and_last": 1,
    "int32_min_weights_and_lasts": 2,
    "remain_is_positive_weights_less_one": 3,
    "aggregated_cut_inside_equal_group": 4,
    "aggregated_fresh_wraps_negative": 5,
    "scale_down_tied": 6,
    "random_small": 7,
}


def _edge_equal(rng, b, c, kinds=tuple(range(8))):
    a = chip_smoke.divide_edge_batch(rng, b, c, kinds)
    args = tuple(a[k] for k in chip_smoke.K2_ARGS)
    for has_aggregated in (True, False):
        want = jax_divide(args, has_aggregated=has_aggregated)
        got = torch_divide(args, has_aggregated=has_aggregated)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    return args, got


@pytest.mark.parametrize("kind", sorted(EDGE_KINDS))
def test_divide_ref_equals_jax_selection_edges(kind):
    """The inputs K2's radix selections must get exactly right (chip_smoke's
    ``divide_edge_batch``, one kind of row at a time): ties in weight and
    last at many indices, INT32_MIN weights and lasts, a remainder one less
    than the positive weights, Aggregated cuts inside a group of equal
    weights, fresh Aggregated rows whose avail + prev wraps negative."""
    rng = np.random.default_rng(EDGE_KINDS[kind])
    args, got = _edge_equal(rng, 24, 300, (EDGE_KINDS[kind],))
    if kind == "remain_is_positive_weights_less_one":
        # n - 1 replicas over n unit weights: every candidate but the last
        # takes one
        cand = args[2]
        assert (got[0].sum(axis=1) == np.maximum(cand.sum(axis=1) - 1, 1)).all()
    if kind == "aggregated_fresh_wraps_negative":
        avail, prev = args[4].astype(np.int64), args[5].astype(np.int64)
        assert ((avail + prev)[args[2]] > HI).any()


@pytest.mark.parametrize("c", [1, 2, 16_385, 20_000])
def test_divide_ref_equals_jax_widths(c):
    """Every edge kind at 1 and 2 clusters and past the 16384 clusters the
    card's old sort held (a few rows each)."""
    _edge_equal(np.random.default_rng(c), 16, c)


@pytest.mark.parametrize("wide", [True, False])
def test_take_by_weight_batch_equals_jax(wide):
    rng = np.random.default_rng(7)
    b, c = 64, 33
    num = rng.integers(0, 60, b).astype(np.int32)
    w = rng.integers(0, 9, (b, c)).astype(np.int32)
    w[rng.random(b) < 0.1] = 0
    last = rng.integers(0, 5, (b, c)).astype(np.int32)
    init = rng.integers(0, 3, (b, c)).astype(np.int32)
    want = np.asarray(J.take_by_weight_batch(*map(jnp.asarray, (num, w, last, init)), wide=wide))
    got = T.take_by_weight_batch(*map(torch.from_numpy, (num, w, last, init)), wide=wide)
    np.testing.assert_array_equal(got.numpy(), want)
    one = T.take_by_weight(*(torch.as_tensor(a[3]) for a in (num, w, last, init)), wide=wide)
    np.testing.assert_array_equal(one.numpy(), want[3])


def estimate_inputs(rng, b=48, c=40, r=4, u=7):
    """Capacity with negative entries and ratios past int32, profiles that
    request nothing (MAX_INT32 sentinel), no-summary clusters, zero-replica
    rows."""
    cap = rng.integers(-1000, 1 << 40, (c, r), dtype=np.int64)
    cap[rng.random((c, r)) < 0.1] = -3
    profiles = rng.integers(0, 1 << 10, (u, r), dtype=np.int64)
    profiles[rng.random((u, r)) < 0.3] = 0
    profiles[0] = 0
    profiles[1] = 0
    profiles[1, 0] = 1
    prof_idx = rng.integers(0, u, b).astype(np.int32)
    has_summary = rng.random(c) < 0.8
    replicas = np.where(rng.random(b) < 0.2, 0, rng.integers(1, 50, b)).astype(np.int32)
    return cap, profiles, prof_idx, has_summary, replicas


def test_general_estimate_family_equals_jax():
    rng = np.random.default_rng(11)
    cap, profiles, prof_idx, has_summary, replicas = estimate_inputs(rng)
    requests = profiles[prof_idx]
    tc, tp, ti, tr = map(torch.from_numpy, (cap, profiles, prof_idx, requests))

    want = np.asarray(J.general_estimate(jnp.asarray(cap), jnp.asarray(requests)))
    got = T.general_estimate(tc, tr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == HI).any() and (want == 0).any()

    want_i = np.asarray(J.general_estimate_interned(*map(jnp.asarray, (cap, profiles, prof_idx))))
    np.testing.assert_array_equal(T.general_estimate_interned(tc, tp, ti).numpy(), want_i)

    masked = np.where(has_summary[None, :], want, -1).astype(np.int32)
    other = rng.integers(-1, 30, masked.shape).astype(np.int32)
    want_m = np.asarray(J.merge_estimates(jnp.asarray(replicas), (jnp.asarray(masked), jnp.asarray(other))))
    got_m = T.merge_estimates(torch.from_numpy(replicas), (torch.from_numpy(masked), torch.from_numpy(other)))
    np.testing.assert_array_equal(got_m.numpy(), want_m)


def test_estimate_merge_ref_equals_jax_composition():
    """K1's plain version == the JAX engine's estimate -> no-summary mask ->
    gather -> merge (scheduler/core.py _profile_table + _availability)."""
    rng = np.random.default_rng(12)
    cap, profiles, prof_idx, has_summary, replicas = estimate_inputs(rng)
    table = J.general_estimate(jnp.asarray(cap), jnp.asarray(profiles))
    table = jnp.where(jnp.asarray(has_summary)[None, :], table, jnp.int32(-1))
    want = np.asarray(J.merge_estimates(jnp.asarray(replicas), (table[jnp.asarray(prof_idx)],)))
    args = tuple(map(torch.from_numpy, (cap, profiles, prof_idx, has_summary, replicas)))
    got = T.estimate_merge(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.estimate_merge_ref(*args).numpy(), want)
    assert (want == 0).any()


def test_schedule_step_equals_jax():
    from karmada_tpu.parallel.solver import schedule_step as jax_step
    from karmada_tpu.parallel.solver import schedule_step_interned as jax_step_i

    from karmada_tpu_torch.parallel import schedule_step, schedule_step_interned

    rng = np.random.default_rng(13)
    b, c = 32, 40
    cap, profiles, prof_idx, has_summary, replicas = estimate_inputs(rng, b=b, c=c)
    strategy, _, cand, static_w, _, prev, fresh = divide_batch(
        rng, b, c, wmax=30, pmax=15, nmax=40
    )
    requests = profiles[prof_idx]
    want = jax_step(cap, has_summary, requests, strategy, replicas, cand,
                    static_w, prev, fresh)
    got = schedule_step(cap, has_summary, requests, strategy, replicas, cand,
                        static_w, prev, fresh, device="cpu")
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(want.assignment))
    np.testing.assert_array_equal(got.unschedulable.numpy(), np.asarray(want.unschedulable))
    want_i = jax_step_i(cap, has_summary, profiles, prof_idx, strategy, replicas,
                        cand, static_w, prev, fresh)
    got_i = schedule_step_interned(cap, has_summary, profiles, prof_idx, strategy,
                                   replicas, cand, static_w, prev, fresh, device="cpu")
    np.testing.assert_array_equal(got_i.assignment.numpy(), np.asarray(want_i.assignment))


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain-version fallback: the wrappers raise."""
    meta = torch.empty((2, 3), dtype=torch.int32, device="meta")
    vec = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        T.divide_replicas(vec, vec, meta.bool(), meta, meta, meta, vec.bool())
    with pytest.raises(ValueError):
        T.estimate_merge(
            torch.empty((3, 4), dtype=torch.int64, device="meta"),
            torch.empty((1, 4), dtype=torch.int64, device="meta"),
            vec, torch.empty((3,), dtype=torch.bool, device="meta"), vec,
        )
    assert T.divide_replicas.launches == 0 and T.estimate_merge.launches == 0
