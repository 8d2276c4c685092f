"""The port's host wire runtime (karmada_tpu_torch/native/fold.py, built
from csrc/fold.c) against its numpy forms and the JAX package's
karmada_tpu.native, on seeded wires. Tolerance: exact (bytes and int32)."""

import numpy as np
import pytest

import karmada_tpu.native as jnative

from karmada_tpu_torch.native import fold


def _entries(rng, n):
    """(site<<8 | count) words, site < 2^13 and count 1..255."""
    return ((rng.integers(0, 1 << 13, n) << 8) | rng.integers(1, 256, n)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_decoders_match_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, 3 * 997 + 2, dtype=np.uint8)
    for got, np_form, jax_form in (
        (fold.decode3(raw), fold.decode3_np(raw), jnative.decode3(raw)),
        (fold.decode2(raw), fold.decode2_np(raw), jnative.decode2(raw)),
    ):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np_form)
        np.testing.assert_array_equal(got, jax_form)
    # a 21-bit stream as the device packs it, with its 3 pad bytes
    n = 1001
    vals = rng.integers(0, 1 << 21, n)
    bits = np.zeros(21 * n + 24, np.uint8)
    for k in range(21):
        bits[np.arange(n) * 21 + k] = (vals >> k) & 1
    packed = np.packbits(bits, bitorder="little")[: (21 * n + 7) // 8 + 3]
    got = fold.decode21(packed, n)
    np.testing.assert_array_equal(got, vals.astype(np.int32))
    np.testing.assert_array_equal(got, fold.decode21_np(packed, n))
    np.testing.assert_array_equal(got, jnative.decode21(packed, n))
    assert fold.le32(np.array([1, 2, 3, 4], np.uint8)) == jnative.le32(
        np.array([1, 2, 3, 4], np.uint8)) == 0x04030201


def test_decode21_refuses_a_short_buffer():
    with pytest.raises(ValueError):
        fold.decode21(np.zeros(8, np.uint8), 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_entries_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    cap, k_res = 64, 16
    base = rng.integers(0, 1 << 20, (cap, k_res)).astype(np.int32)
    rows = rng.choice(cap, 20, replace=False)
    counts = rng.integers(0, k_res + 1, 20)
    counts[3] = k_res + 7  # an overlong run is clamped at k_res
    stream = _entries(rng, int(counts.sum()))
    mirrors = [base.copy() for _ in range(3)]
    fold.fold_entries(mirrors[0], rows, counts, stream)
    fold.fold_entries_np(mirrors[1], rows, counts, stream)
    jnative.fold_entries(mirrors[2], rows, counts, stream)
    np.testing.assert_array_equal(mirrors[0], mirrors[1])
    np.testing.assert_array_equal(mirrors[0], mirrors[2])
    np.testing.assert_array_equal(mirrors[0][rows[3]], stream[
        int(counts[:3].sum()): int(counts[:3].sum()) + k_res])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_deltas_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    cap, k_res, c = 48, 12, 40
    mirror = np.zeros((cap, k_res), np.int32)
    for r in range(cap):  # sorted runs of distinct sites, some full
        n = int(rng.integers(0, k_res + 1))
        sites = np.sort(rng.choice(c, n, replace=False))
        mirror[r, :n] = (sites << 8) | rng.integers(1, 200, n)
    rows = rng.choice(cap, 24, replace=False)
    dcounts, stream = [], []
    for _ in rows:
        nd = int(rng.integers(0, 10))
        sites = np.sort(rng.choice(c, nd, replace=False))
        newc = rng.integers(0, 120, nd)  # 0 removes the site
        stream.extend(((sites << 9) | (newc + 1)).tolist())
        dcounts.append(nd)
    dcounts = np.asarray(dcounts, np.int64)
    stream = np.asarray(stream, np.int32)
    outs = [mirror.copy() for _ in range(3)]
    fold.apply_deltas(outs[0], rows, dcounts, stream)
    fold.apply_deltas_np(outs[1], rows, dcounts, stream)
    jnative.apply_deltas(outs[2], rows, dcounts, stream)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], mirror)


def test_fold_refuses_a_short_stream_and_a_bad_mirror():
    m = np.zeros((4, 4), np.int32)
    with pytest.raises(ValueError):
        fold.fold_entries(m, np.array([0]), np.array([3]), np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        fold.apply_deltas(m.astype(np.int64), np.array([0]), np.array([0]),
                          np.zeros(0, np.int32))
