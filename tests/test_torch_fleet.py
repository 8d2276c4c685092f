"""The port's fleet device programs (karmada_tpu_torch/scheduler/
fleet_kernels.py) against the JAX package's (karmada_tpu/scheduler/fleet.py)
on the same seeded inputs, on the CPU: the wrappers take their plain
versions here, the same code the card's kernels are held to by
chip_smoke.py. Tolerance: exact — every wire byte for byte, the residents
and the row buffer element for element. Shapes are small: cap 1024, C 50
and 300, chunk 256."""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import karmada_tpu.scheduler.core as jcore
import karmada_tpu.scheduler.fleet as jf
from karmada_tpu.ops.estimate import merge_estimates as j_merge_estimates

import chip_smoke

from karmada_tpu_torch import native
from karmada_tpu_torch.scheduler import fleet_kernels as fk
from karmada_tpu_torch.scheduler.fleet import _cap_round, _pow2

CAP, CHUNK, K_PREV = 1024, 256, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this module
    from contending with the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
MI = 2**31 - 1


def tables_state(seed: int, c: int, cap: int = CAP, u: int = 12, g: int = 3,
                 p: int = 6) -> tuple[tuple, tuple]:
    """Slot tables and per-row state as the fleet table holds them: packed
    affinity/taint/GVK planes, static weights, a profile table with -1
    (no summary) and sentinel cells, and rows with up to 8 distinct
    previous sites padded with (0, 0) pairs."""
    rng = np.random.default_rng(seed)
    pack = lambda m: np.packbits(m, axis=1, bitorder="little")  # noqa: E731
    cp_bits = np.concatenate([pack(rng.random((u, c)) < 0.8),
                              pack(rng.random((u, c)) < 0.85)], axis=1)
    cp_static = rng.integers(0, 5, (u, c)).astype(np.int32)
    cp_static[0] = 0  # all-zero static weights: every candidate weighs 1
    gvk_bits = pack(rng.random((g, c)) < 0.9)
    prof = rng.integers(-1, 60, (p, c)).astype(np.int32)
    prof[0] = MI  # a profile requesting nothing
    prof[1, rng.random(c) < 0.3] = -1
    incomplete = rng.random(c) < 0.3
    replicas = rng.integers(0, 129, cap).astype(np.int32)
    replicas[rng.random(cap) < 0.05] = 0
    sites = np.zeros((cap, K_PREV), np.int32)
    counts = np.zeros((cap, K_PREV), np.int32)
    for r in range(cap):
        k = int(rng.integers(0, 9))
        sites[r, :k] = rng.choice(c, k, replace=False)
        counts[r, :k] = rng.integers(1, 30, k)
    state = (
        rng.integers(0, u, cap).astype(np.int32),
        rng.integers(0, g, cap).astype(np.int32),
        rng.integers(0, p, cap).astype(np.int32),
        replicas,
        rng.integers(0, 4, cap).astype(np.int32),
        rng.random(cap) < 0.2,
        sites,
        counts,
    )
    return (cp_bits, cp_static, gvk_bits, prof, incomplete), state


def rows_for(kind: str, n: int, n_pad: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    out = np.full(n_pad, -1, np.int32)
    out[:n] = np.arange(n) if kind == "all" else rng.permutation(CAP)[:n]
    return out


def T(a):  # numpy -> torch (CPU)
    return torch.from_numpy(np.ascontiguousarray(a))


def J(a):  # numpy -> jax
    return jnp.asarray(np.ascontiguousarray(a))


def variant(tables, state, c):
    reps = state[3]
    prof = tables[3]
    return jcore.kernel_variant(
        max(int(prof[prof != MI].max()), int(reps.max())), int(tables[1].max()),
        int(state[7].max()), int(reps.max()), c,
    )


# --------------------------------------------------------------------------
# K3: masks and bits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("c", [50, 300])
def test_unpack_bits_and_row_masks_equal_jax(c):
    tables, state = tables_state(1, c)
    cp_bits, cp_static, gvk_bits, _, inc = tables
    np.testing.assert_array_equal(
        fk.unpack_bits_ref(T(cp_bits), c).numpy(),
        np.asarray(jf._unpack_bits(J(cp_bits), c)))
    rows = rows_for("part", 200, CHUNK, 1)
    valid = rows >= 0
    r = np.maximum(rows, 0)
    cpc, gvc = state[0][r], state[1][r]
    psc = state[6][r]
    pcc = np.where(valid[:, None], state[7][r], 0)
    want = jf._row_masks(J(cp_bits), J(cp_static), J(gvk_bits), J(inc), J(cpc),
                         J(gvc), J(psc), J(pcc), J(valid), CHUNK, c)
    got = fk.row_masks_ref(T(cp_bits), T(cp_static), T(gvk_bits), T(inc), T(cpc),
                           T(gvc), T(psc), T(pcc), T(valid), CHUNK, c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("c", [50, 300])
@pytest.mark.parametrize("kind", ["all", "part"])
def test_fleet_bits_equal_jax(c, kind):
    tables, state = tables_state(2, c)
    rows = rows_for(kind, 700, 768, 2)
    want = np.asarray(jf._fleet_bits(*map(J, tables), J(rows), *map(J, state),
                                     chunk=CHUNK, n_chunks=3))
    got = fk.fleet_bits(*map(T, tables), T(rows), *map(T, state), chunk=CHUNK,
                        n_chunks=3)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# --------------------------------------------------------------------------
# K3 and K4 on the edge batches (chip_smoke.fleet_edge_tables): duplicate,
# wrapping and negative previous counts, padding rows, k_prev 1 / 32 / 128,
# C ending part-way through words, vectors and tiles
# --------------------------------------------------------------------------


def edge_tables(c: int, k_prev: int) -> dict:
    return chip_smoke.fleet_edge_tables(np.random.default_rng(1000 * c + k_prev), c,
                                        k_prev)


@jax.jit
def _jax_chunk_masks(cp_bits, cp_static, gvk_bits, prof_table, inc, rows, cp_idx,
                     gvk_idx, prof_idx, replicas, strategy, fresh, prev_sites,
                     prev_counts):
    """``_fleet_pass``'s per-chunk gather, ``_row_masks`` and the one-
    estimator ``merge_estimates`` (fleet.py:538-569) for one chunk."""
    valid = rows >= 0
    r = jnp.maximum(rows, 0)
    reps = jnp.where(valid, replicas[r], 0)
    pcc = jnp.where(valid[:, None], prev_counts[r], 0)
    prev, static_w, feasible = jf._row_masks(
        cp_bits, cp_static, gvk_bits, inc, cp_idx[r], gvk_idx[r], prev_sites[r], pcc,
        valid, rows.shape[0], cp_static.shape[1])
    avail = j_merge_estimates(reps, (prof_table[prof_idx[r]],))
    return feasible, static_w, prev, avail, reps, strategy[r], fresh[r] & valid


@pytest.mark.parametrize("k_prev", chip_smoke.FLEET_EDGE_K_PREV)
@pytest.mark.parametrize("c", chip_smoke.FLEET_EDGE_C)
def test_fleet_masks_and_bits_edge_tables_equal_jax(c, k_prev):
    t = edge_tables(c, k_prev)
    tables, state, rows = t["tables"], t["state"], t["rows"]
    for i in range(rows.size // CHUNK):
        rc = rows[i * CHUNK:(i + 1) * CHUNK]
        got = fk.fleet_masks(*map(T, tables), T(rc), *map(T, state))
        want = _jax_chunk_masks(*map(J, tables), J(rc), *map(J, state))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_b = np.asarray(jf._fleet_bits(*map(J, tables), J(rows), *map(J, state),
                                       chunk=CHUNK, n_chunks=rows.size // CHUNK))
    got_b = fk.fleet_bits(*map(T, tables), T(rows), *map(T, state), chunk=CHUNK,
                          n_chunks=rows.size // CHUNK)
    np.testing.assert_array_equal(got_b.numpy().view(np.uint32), want_b)
    # the edges are there: a wrapped or negative prev, a duplicate sum
    prev = fk.fleet_masks(*map(T, tables), T(rows[:CHUNK]), *map(T, state)).prev
    assert (prev < 0).any() and (prev > 29).any() or k_prev == 1 or c == 1


@pytest.mark.parametrize("c,k_prev,kind", [
    (1, 1, "part"), (31, 128, "all"), (33, 32, "part"), (257, 32, "all"),
    (1000, 128, "part"), (5000, 32, "all"), (5000, 1, "part"),
])
def test_fleet_pass_edge_tables_equal_jax(c, k_prev, kind):
    """``_fleet_pass`` byte for byte on an edge batch, three passes over the
    same rows: from zero residents, steady (no row changes), and against
    ``chip_smoke.perturb_residents`` (a row past the 64 delta slots, a
    meta-only change)."""
    t = edge_tables(c, k_prev)
    tables, state, rows = t["tables"], t["state"], t["rows"]
    if kind == "all":
        rows = np.where(rows >= 0, np.arange(rows.size, dtype=np.int32), -1)
    cap = state[0].size
    n_chunks = rows.size // CHUNK
    kw = dict(chunk=CHUNK, n_chunks=n_chunks, wide=True, fast=None,
              has_aggregated=True, all_rows=kind == "all", m_cap=rows.size,
              d_cap=8192)
    rd, rm = np.zeros((cap, c), np.uint8), np.zeros(cap, np.int32)
    for step in ("cold", "steady", "churn"):
        if step == "churn":
            rd, rm = chip_smoke.perturb_residents(np.random.default_rng(c), rd, rm, rows)
        w_flat, w_rowbuf, w_rd, w_rm = jf._fleet_pass(
            *map(J, tables), J(rows), *map(J, state), J(rd.copy()), J(rm.copy()), **kw)
        t_rd, t_rm = T(rd.copy()), T(rm.copy())
        g_flat, g_rowbuf, _, _ = fk.fleet_pass(
            *map(T, tables), T(rows), *map(T, state), t_rd, t_rm, **kw)
        np.testing.assert_array_equal(g_flat.numpy(), np.asarray(w_flat))
        np.testing.assert_array_equal(g_rowbuf.numpy(), np.asarray(w_rowbuf))
        np.testing.assert_array_equal(t_rd.numpy(), np.asarray(w_rd))
        np.testing.assert_array_equal(t_rm.numpy(), np.asarray(w_rm))
        total = int(g_flat.numpy()[:4].view("<i4")[0])
        assert (total == 0) == (step == "steady"), (step, total)
        rd, rm = t_rd.numpy(), t_rm.numpy()


def test_masks_input_check_takes_any_k_prev():
    """The card path's shape check (``_check_masks_inputs``) takes any
    k_prev > 0 (no MAX_PREV), and still refuses k_prev = 0 and counts
    shaped unlike the sites."""
    for k_prev in (1, 128, 300):
        t = edge_tables(33, 1)
        state = list(map(T, t["state"]))
        state[6] = torch.zeros((state[6].shape[0], k_prev), dtype=torch.int32)
        state[7] = torch.zeros_like(state[6])
        fk._check_masks_inputs("fleet_masks", tuple(map(T, t["tables"])),
                               T(t["rows"]), tuple(state))
    for bad in ((0, 0), (4, 5)):
        state[6] = torch.zeros((state[6].shape[0], bad[0]), dtype=torch.int32)
        state[7] = torch.zeros((state[6].shape[0], bad[1]), dtype=torch.int32)
        with pytest.raises(ValueError):
            fk._check_masks_inputs("fleet_masks", tuple(map(T, t["tables"])),
                                   T(t["rows"]), tuple(state))


# --------------------------------------------------------------------------
# K6: meta gather and row scatter
# --------------------------------------------------------------------------


def test_gather_meta_equals_jax():
    rng = np.random.default_rng(3)
    res_meta = rng.integers(0, 1 << 10, CAP).astype(np.int32)
    rows = np.full(4096, -1, np.int32)
    rows[:300] = rng.choice(CAP, 300, replace=False)
    got = fk.gather_meta(T(res_meta), T(rows))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jf._gather_meta(J(res_meta), J(rows))))


def test_scatter_rows_equals_jax():
    _, state = tables_state(4, 50)
    rng = np.random.default_rng(4)
    rows = rng.choice(CAP, 40, replace=False).astype(np.int64)
    rows_p = np.concatenate([rows, np.full(24, rows[0])])  # pow2 padding
    _, donor = tables_state(5, 50)
    vals = tuple(a[rows_p] for a in donor)
    want = jf._scatter_rows(tuple(map(J, state)), J(rows_p), tuple(map(J, vals)))
    got = tuple(T(a.copy()) for a in state)
    out = fk.scatter_rows(got, T(rows_p), tuple(map(T, vals)))
    assert out is got  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", chip_smoke.SCATTER_EDGE_CASES)
def test_scatter_edge_batch_equals_jax(case):
    """K6's plain version (both entry points) on every
    ``chip_smoke.SCATTER_EDGE_CASES`` batch against the JAX programs, exact.
    The dirty-row form against ``_scatter_rows`` on its rows in [0, cap)
    alone (JAX wraps a negative index where the port drops it); the commit
    form against the two branches of ``_fleet_solve``'s commit
    (fleet.py:355-371: ``dynamic_update_slice`` of every row, or a scatter at
    ``where(valid, r, cap)`` with ``mode="drop"``), its commit index being
    r where JAX's ``changed`` holds; the gather against ``_gather_meta``."""
    b = chip_smoke.scatter_edge_batch(case)
    got = tuple(T(a.copy()) for a in b["state"])
    out = fk.scatter_rows(got, T(b["rows"]), tuple(map(T, b["vals"])))
    assert out is got  # in place
    if case in chip_smoke.COMMIT_EDGE_CASES:
        prev, ent = J(b["resident"]), J(b["entries"])
        r, valid = J(b["resident_rows"]), J(b["valid"])
        if b["all_rows"]:
            z32 = jnp.int32(0)
            pe = jax.lax.dynamic_slice_in_dim(prev, z32, ent.shape[0], 0)
            changed = (ent != pe).any(axis=1) & valid
            want = (jax.lax.dynamic_update_slice_in_dim(prev, ent, z32, 0),)
        else:
            changed = (ent != prev[r]).any(axis=1) & valid
            want = (prev.at[jnp.where(valid, r, prev.shape[0])].set(ent, mode="drop"),)
        np.testing.assert_array_equal(
            b["rows"], np.where(np.asarray(changed), b["resident_rows"], -1))
    else:
        rows = b["rows"]
        ok = (rows >= 0) & (rows < b["state"][0].shape[0])
        want = jf._scatter_rows(tuple(map(J, b["state"])), J(rows[ok]),
                                tuple(J(v[ok]) for v in b["vals"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        fk.gather_meta(T(b["meta"]), T(b["gather_rows"])).numpy(),
        np.asarray(jf._gather_meta(J(b["meta"]), J(b["gather_rows"]))))


# --------------------------------------------------------------------------
# K5 serialisers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("e_cap", [1, 7, 1024, 1031])
def test_pack21_and_entry_wire_equal_jax(e_cap):
    rng = np.random.default_rng(e_cap)
    stream = ((rng.integers(0, 1 << 13, e_cap) << 8)
              | rng.integers(1, 129, e_cap)).astype(np.int32)
    stream[rng.random(e_cap) < 0.2] = 0
    np.testing.assert_array_equal(fk.pack21_ref(T(stream), e_cap).numpy(),
                                  np.asarray(jf._pack21(J(stream), e_cap)))
    for pack21 in (True, False):
        np.testing.assert_array_equal(
            fk.entry_bytes_ref(T(stream), e_cap, pack21).numpy(),
            np.asarray(jf._entry_wire(J(stream), e_cap, pack21)))


@partial(jax.jit, static_argnames=("m_cap", "d_cap"))
def _jax_pass_wire(changed, meta, dcounts, rows, deltas_all, *, m_cap, d_cap):
    """``_fleet_pass``'s wire (fleet.py:652-707) line by line, on the
    scan's flattened outputs."""
    r = jnp.maximum(rows, 0)
    wire_meta = meta | (jnp.minimum(dcounts, 63) << 10)
    cnt = jnp.cumsum(changed.astype(jnp.int32)) - changed
    total = cnt[-1] + changed[-1].astype(jnp.int32)
    write = jnp.where(changed & (cnt < m_cap), cnt, m_cap)
    mstream = jnp.zeros((m_cap + 1,), jnp.int32).at[write].set(wire_meta)[:m_cap]
    rowbuf = jnp.full((m_cap + 1,), -1, jnp.int32).at[write].set(r)[:m_cap]
    w32 = changed.reshape(-1, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :]
    words = (w32 << shifts).sum(axis=-1, dtype=jnp.uint32)
    mask_u8 = jnp.stack([(words >> s) & 0xFF for s in (0, 8, 16, 24)],
                        axis=-1).astype(jnp.uint8).reshape(-1)
    total_u8 = jnp.stack([(total >> s) & 0xFF for s in (0, 8, 16, 24)]).astype(jnp.uint8)
    meta_u8 = jnp.stack([mstream & 0xFF, (mstream >> 8) & 0xFF],
                        axis=-1).astype(jnp.uint8).reshape(-1)
    parts = [total_u8, mask_u8, meta_u8]
    if d_cap:
        contrib = changed & (dcounts <= 62)
        rowv = jnp.where(contrib[:, None], deltas_all, 0).reshape(-1)
        validv = rowv != 0
        doffs = jnp.cumsum(validv.astype(jnp.int32)) - validv
        dtotal = doffs[-1] + validv[-1].astype(jnp.int32)
        dwrite = jnp.where(validv & (doffs < d_cap), doffs, d_cap)
        dstream = jnp.zeros((d_cap + 1,), jnp.int32).at[dwrite].set(rowv)[:d_cap]
        dtotal_u8 = jnp.stack([(dtotal >> s) & 0xFF for s in (0, 8, 16, 24)]).astype(jnp.uint8)
        d_u8 = jnp.stack([dstream & 0xFF, (dstream >> 8) & 0xFF, (dstream >> 16) & 0xFF],
                         axis=-1).astype(jnp.uint8).reshape(-1)
        parts += [dtotal_u8, d_u8]
    return jnp.concatenate(parts), rowbuf


@partial(jax.jit, static_argnames=("e_cap", "byte_wire", "pack21"))
def _jax_entry_wire(entries, meta, *, e_cap, byte_wire, pack21):
    """``_fleet_entries``' compaction and wire (fleet.py:755-769) line by
    line; with ``meta``, ``_fleet_solve``'s (fleet.py:380-420), every
    row changed (the port's K16 zeroes the unchanged rows' entries)."""
    valid_e = (entries > 0).reshape(-1)
    offs = jnp.cumsum(valid_e.astype(jnp.int32)) - valid_e
    total = offs[-1] + valid_e[-1].astype(jnp.int32)
    write = jnp.where(valid_e & (offs < e_cap), offs, e_cap)
    stream = jnp.zeros((e_cap + 1,), jnp.int32).at[write].set(entries.reshape(-1))[:e_cap]
    if byte_wire:
        total_u8 = jnp.stack([(total >> s) & 0xFF for s in (0, 8, 16, 24)]).astype(jnp.uint8)
        e_u8 = jf._entry_wire(stream, e_cap, pack21)
        if meta is None:
            return jnp.concatenate([total_u8, e_u8])
        meta_u8 = jnp.stack([meta & 0xFF, (meta >> 8) & 0xFF],
                            axis=-1).astype(jnp.uint8).reshape(-1)
        return jnp.concatenate([total_u8, meta_u8, e_u8])
    if meta is None:
        return jnp.concatenate([total[None], stream])
    return jnp.concatenate([total[None], meta, stream])


@pytest.mark.parametrize("case", chip_smoke.WIRE_EDGE_CASES)
def test_wire_edge_batch_equals_jax(case):
    """K5's plain versions against the JAX wires byte for byte on every
    ``chip_smoke.wire_edge_batch`` case (the cases the card's kernels are
    held to): caps at, below and above the totals, caps of 1, n under one
    tile, ragged and over 2000 tiles, dcount 62 / 63, all-zero delta
    rows, the 21-bit form at every 21 e_cap mod 8, the 3-byte and int32
    forms, the metas in place."""
    b = chip_smoke.wire_edge_batch(np.random.default_rng(
        chip_smoke.WIRE_EDGE_CASES.index(case)), case)
    if b["kind"] == "pass":
        args = [b[k] for k in ("changed", "meta", "dcount", "rows", "deltas")]
        kw = dict(m_cap=b["m_cap"], d_cap=b["d_cap"])
        g_flat, g_rowbuf = fk.fleet_wire(*map(T, args), **kw)
        # the JAX wire packs whole chunks of 256 rows: below that, or past
        # a multiple, it runs on the rows padded with unchanged ones, as
        # the engine pads them, and its mask loses the padding's bytes
        n = args[0].size
        pad = -n % 256
        w_flat, w_rowbuf = _jax_pass_wire(
            *(J(np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])) for a in args),
            **kw)
        w_flat = np.asarray(w_flat)
        w_flat = np.concatenate([w_flat[:4 + n // 8], w_flat[4 + (n + pad) // 8:]])
        np.testing.assert_array_equal(g_flat.numpy(), w_flat)
        np.testing.assert_array_equal(g_rowbuf.numpy(), np.asarray(w_rowbuf))
        return
    kw = dict(e_cap=b["e_cap"], byte_wire=b["byte_wire"], pack21=b["pack21"])
    meta = b["meta"]
    got = fk.entry_wire(T(b["entries"]), meta=None if meta is None else T(meta), **kw)
    want = _jax_entry_wire(J(b["entries"]), None if meta is None else J(meta), **kw)
    assert got.dtype == (torch.uint8 if b["byte_wire"] else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# phase A and phase B
# --------------------------------------------------------------------------


def residents(tables, state, rows, c, *, n_chunks, wide, fast, has_agg, seed,
              overflow_row):
    """Residents one JAX pass wrote, then perturbed: random cells of some
    rows, a meta word, and one row rewritten in > 62 cells."""
    rd, rm = jnp.zeros((CAP, c), jnp.uint8), jnp.zeros((CAP,), jnp.int32)
    _, _, rd, rm = jf._fleet_pass(
        *map(J, tables), J(rows), *map(J, state), rd, rm, chunk=CHUNK,
        n_chunks=n_chunks, wide=wide, fast=fast, has_aggregated=has_agg,
        all_rows=False, m_cap=CHUNK * n_chunks, d_cap=0)
    rd, rm = np.array(rd), np.array(rm)
    rng = np.random.default_rng(seed)
    live = rows[rows >= 0]
    for r in rng.choice(live, 40, replace=False):
        cells = rng.choice(c, 3, replace=False)
        rd[r, cells] = rng.integers(0, 9, 3)
    rm[live[5]] ^= 1 << 8  # meta-only change
    if overflow_row:
        rd[live[7], : min(c, 100)] = 77  # > 62 changed cells when C = 300
    return rd, rm


def spy_glue(monkeypatch, diff_name: str, wire_name: str) -> dict:
    """Record what the pass glue hands K4 / K16 (``out=``) and K5."""
    seen = {"outs": [], "wire": None}
    diff, wire = getattr(fk, diff_name), getattr(fk, wire_name)

    def diff_spy(*a, out=None, **kw):
        seen["outs"].append(out)
        return diff(*a, out=out, **kw)

    def wire_spy(*a, **kw):
        seen["wire"] = (a, kw)
        return wire(*a, **kw)

    monkeypatch.setattr(fk, diff_name, diff_spy)
    monkeypatch.setattr(fk, wire_name, wire_spy)
    return seen


def assert_views_of(outs, buffers, chunk: int) -> None:
    """Chunk i's outputs are rows [i * chunk, (i + 1) * chunk) of the
    pass-wide buffers the wire reads: no concatenation between them."""
    assert outs and all(o is not None for o in outs)
    for i, out in enumerate(outs):
        for o, buf in zip(out, buffers):
            assert o.data_ptr() == buf[i * chunk:(i + 1) * chunk].data_ptr()
            assert o.shape == buf[i * chunk:(i + 1) * chunk].shape


def test_diff_wrappers_write_out_views():
    """``fleet_diff`` and ``entry_diff`` with ``out=`` views at a nonzero
    chunk offset of pass-wide buffers give what they return without it,
    and leave the buffers' other rows alone."""
    c, chunk = 300, CHUNK
    tables, state = tables_state(12, c)
    rows = rows_for("part", 2 * chunk, 2 * chunk, 12)[chunk:]
    wide, fast = variant(tables, state, c)
    m = fk.fleet_masks(*map(T, tables), T(rows), *map(T, state))
    a, u = fk.divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w, m.avail,
                              m.prev, m.fresh, True, wide, fast)
    args = (a, u, m.feasible, m.strategy, T(rows))
    res = (torch.zeros((CAP, c), dtype=torch.uint8), torch.zeros(CAP, dtype=torch.int32))
    kw = dict(all_rows=False, offset=0, d_slots=64)
    want = fk.fleet_diff(*args, *(x.clone() for x in res), **kw)
    bufs = fk.ChunkDiff(torch.full((3 * chunk,), True), torch.full((3 * chunk,), -5),
                        torch.full((3 * chunk,), -5),
                        torch.full((3 * chunk, 64), -5, dtype=torch.int32))
    sl = slice(chunk, 2 * chunk)
    got = fk.fleet_diff(*args, *(x.clone() for x in res), **kw,
                        out=fk.ChunkDiff(*(b[sl] for b in bufs)))
    for g, w, b in zip(got, want, bufs):
        assert g.data_ptr() == b[sl].data_ptr()
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        assert (b[:chunk] == b[0]).all() and (b[2 * chunk:] == b[0]).all()
    k_out, k_res = 64, 72
    resident = torch.from_numpy(np.random.default_rng(12).integers(
        0, 5, (CAP, k_res)).astype(np.int32))
    kw = dict(k_out=k_out, all_rows=False, offset=0)
    want = fk.entry_diff(*args, resident, **kw)
    bufs = fk.EntryDiff(torch.full((3 * chunk,), -5, dtype=torch.int32),
                        torch.full((3 * chunk, k_res), -5, dtype=torch.int32),
                        torch.full((3 * chunk,), -5, dtype=torch.int64))
    got = fk.entry_diff(*args, resident, **kw, out=fk.EntryDiff(*(b[sl] for b in bufs)))
    for g, w, b in zip(got, want, bufs):
        assert g.data_ptr() == b[sl].data_ptr()
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        assert (b[:chunk] == -5).all() and (b[2 * chunk:] == -5).all()


@pytest.mark.parametrize("c,kind,n,m_cap,d_cap", [
    (300, "all", 900, 1024, 0),
    (300, "all", 900, 1024, 8192),
    (300, "part", 500, 16, 8192),
    (300, "part", 500, 1024, 32),
    (50, "all", 900, 1024, 8192),
    (50, "all", 900, 16, 0),
    (50, "part", 500, 1024, 0),
    (50, "part", 500, 1024, 32),
])
def test_fleet_pass_wire_equals_jax(c, kind, n, m_cap, d_cap, monkeypatch):
    """``_fleet_pass`` byte for byte: the flat wire, the row buffer and both
    residents, on all-rows and partial batches, without and with the delta
    section, with an m_cap overflow (16) and a delta-stream overflow (32),
    and a row with more than 62 changed cells when C = 300. Each chunk's
    K4 writes its rows of the pass-wide buffers K5 reads (no
    concatenation)."""
    seen = spy_glue(monkeypatch, "fleet_diff", "fleet_wire")
    tables, state = tables_state(6, c)
    n_pad = -(-n // CHUNK) * CHUNK
    n_chunks = n_pad // CHUNK
    rows = rows_for(kind, n, n_pad, 6)
    wide, fast = variant(tables, state, c)
    has_agg = bool((state[4] == 3).any())
    rd, rm = residents(tables, state, rows, c, n_chunks=n_chunks, wide=wide,
                       fast=fast, has_agg=has_agg, seed=7, overflow_row=True)
    # the next pass sees new replicas on some rows
    state = list(state)
    state[3] = state[3].copy()
    state[3][rows[:50].clip(0)] = (state[3][rows[:50].clip(0)] + 5) % 129
    kw = dict(chunk=CHUNK, n_chunks=n_chunks, wide=wide, fast=fast,
              has_aggregated=has_agg, all_rows=kind == "all", m_cap=m_cap,
              d_cap=d_cap)
    w_flat, w_rowbuf, w_rd, w_rm = jf._fleet_pass(
        *map(J, tables), J(rows), *map(J, state), J(rd.copy()), J(rm.copy()), **kw)
    t_rd, t_rm = T(rd.copy()), T(rm.copy())
    g_flat, g_rowbuf, g_rd, g_rm = fk.fleet_pass(
        *map(T, tables), T(rows), *map(T, state), t_rd, t_rm, **kw)
    assert g_rd is t_rd and g_rm is t_rm  # updated in place
    assert g_flat.dtype == torch.uint8
    np.testing.assert_array_equal(g_flat.numpy(), np.asarray(w_flat))
    np.testing.assert_array_equal(g_rowbuf.numpy(), np.asarray(w_rowbuf))
    np.testing.assert_array_equal(g_rd.numpy(), np.asarray(w_rd))
    np.testing.assert_array_equal(g_rm.numpy(), np.asarray(w_rm))
    wire_in = seen["wire"][0]
    assert_views_of(seen["outs"], (wire_in[0], wire_in[1], wire_in[2], wire_in[4]), CHUNK)
    flat = g_flat.numpy()
    total = int(flat[:4].view("<i4")[0])
    assert total > (m_cap if m_cap == 16 else 40)
    if d_cap and c == 300:
        metas = flat[4 + n_pad // 8 :][: 2 * min(total, m_cap)]
        assert (metas[1::2] >> 2).max() == 63  # the > 62 overflow sentinel


def edge_dense(c: int) -> tuple[np.ndarray, np.ndarray]:
    """The dense resident a JAX pass over the edge batch of ``c`` (k_prev
    32) wrote, churned by ``chip_smoke.perturb_residents`` and
    ``chip_smoke.entry_edge_dense`` (a row of counts 1-255 in every cell,
    one of 255 in every other cell), and the batch's rows: table rows at
    odd and even indices in permuted order, with padding."""
    t = edge_tables(c, 32)
    tables, state, rows = t["tables"], t["state"], t["rows"]
    cap = state[0].size
    _, _, rd, rm = jf._fleet_pass(
        *map(J, tables), J(rows), *map(J, state), J(np.zeros((cap, c), np.uint8)),
        J(np.zeros(cap, np.int32)), chunk=CHUNK, n_chunks=rows.size // CHUNK, wide=True,
        fast=None, has_aggregated=True, all_rows=False, m_cap=rows.size, d_cap=0)
    rng = np.random.default_rng(c)
    rd, _ = chip_smoke.perturb_residents(rng, np.array(rd), np.array(rm), rows)
    return chip_smoke.entry_edge_dense(rng, rd, rows), rows


ENTRIES_CASES = [
    pytest.param(c, byte_wire, pack21, None, id=f"{c}-{byte_wire}-{pack21}")
    for c, byte_wire, pack21 in ((300, True, True), (300, True, False), (300, False, True),
                                 (300, False, False), (50, True, True), (50, False, False))
] + [
    # the card's edge batches: C from 1 to 5000, k_out 1 (every row with two
    # nonzero cells truncates) and the fleet's widest, capped at C
    pytest.param(c, True, k_out > 1, k_out, id=f"edge-{c}-k{k_out}")
    for c in chip_smoke.FLEET_EDGE_C
    for k_out in sorted({min(k, c) for k in chip_smoke.ENTRY_EDGE_K_OUT})
]


@pytest.mark.parametrize("c,byte_wire,pack21,k_out", ENTRIES_CASES)
def test_fleet_entries_equal_jax(c, byte_wire, pack21, k_out):
    if k_out is None:  # seeded tables, 333 of 900 rows changed
        tables, state = tables_state(8, c)
        rows = rows_for("all", 900, 1024, 8)
        wide, fast = variant(tables, state, c)
        rd, _ = residents(tables, state, rows, c, n_chunks=4, wide=wide, fast=fast,
                          has_agg=True, seed=9, overflow_row=False)
        rng = np.random.default_rng(9)
        ch = rng.choice(900, 333, replace=False).astype(np.int32)
        k_out = min(c, _pow2(int(state[3].max())))
    else:
        rd, ch = edge_dense(c)
    rows_b = np.full(2048, -1, np.int32)
    rows_b[: len(ch)] = ch
    live = ch[ch >= 0]
    e_want = int((rd[live] > 0).sum(axis=1).clip(max=k_out).sum())
    e_cap = _cap_round(e_want)
    kw = dict(chunk=CHUNK, n_chunks=8, k_out=k_out, e_cap=e_cap,
              byte_wire=byte_wire, pack21=pack21)
    want = np.asarray(jf._fleet_entries(J(rd), J(rows_b), **kw))
    got = fk.fleet_entries(T(rd), T(rows_b), **kw)
    assert got.dtype == (torch.uint8 if byte_wire else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    total = int(got[:4].numpy().view("<i4")[0]) if byte_wire else int(got[0])
    assert total == e_want > 0
    # the entry rows alone: each row's nonzero cells in site order, first
    # k_out; padding rows give zeros
    ents = fk.fleet_entry_rows(T(rd), T(rows_b), k_out).numpy()
    for j, r in enumerate(rows_b):
        want_row = np.zeros(k_out, np.int32)
        if r >= 0:
            nz = np.flatnonzero(rd[r])[:k_out]
            want_row[: len(nz)] = (nz << 8) | rd[r, nz]
        np.testing.assert_array_equal(ents[j], want_row)
    # an e_cap below the total
    kw["e_cap"] = 64
    np.testing.assert_array_equal(
        fk.fleet_entries(T(rd), T(rows_b), **kw).numpy(),
        np.asarray(jf._fleet_entries(J(rd), J(rows_b), **kw)))


def test_compact_ref_counts_past_the_cap():
    vals = torch.arange(10, dtype=torch.int32)
    flags = vals % 3 == 0  # 0, 3, 6, 9
    out, total = fk.compact_ref(vals, flags, 2, fill=-1)
    assert out.tolist() == [0, 3] and int(total) == 4
    out, total = fk.compact_ref(vals, flags, 6, fill=-1)
    assert out.tolist() == [0, 3, 6, 9, -1, -1] and int(total) == 4


def test_wrappers_refuse_mixed_devices_and_bad_dtypes():
    """On the CPU the plain versions run; anything that is not all-CPU must
    be one CUDA device, and there is none here, so a wrapper raises
    instead of falling back."""
    a = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fk.gather_meta(torch.zeros(4, dtype=torch.int32, device="meta"), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        fk.fleet_entry_rows(a, torch.zeros(2, dtype=torch.int32, device="meta"), 4)


def test_wire_tiles_match_the_kernel_source():
    """The wrappers size K5's look-back scratch by ``WIRE_ROW_TILE`` and
    ``WIRE_ENTRY_TILE`` (a status word a tile): they must be the tiles of
    ``csrc/fleet_wire.cu``."""
    import os
    import re

    with open(os.path.join(native.CSRC, "fleet_wire.cu")) as f:
        src = f.read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert src.count("constexpr int ROW_TILE = THREADS;") == 1
    assert const["THREADS"] == fk.WIRE_ROW_TILE
    assert const["THREADS"] * const["VEC"] * const["LOADS"] == fk.WIRE_ENTRY_TILE


def _c_signature(src: str, fn_name: str) -> str:
    """The argument kinds of ``extern "C" int fn_name(...)`` in a kernel
    source, in ``native.SIGNATURES`` letters, without the trailing stream."""
    import re

    m = re.search(r'extern "C" int ' + fn_name + r"\((.*?)\)\s*\{", src, re.S)
    assert m, fn_name
    params = [p.strip() for p in m.group(1).split(",")]
    assert params[-1].startswith("cudaStream_t"), fn_name
    kinds = []
    for p in params[:-1]:
        if "*" in p:
            kinds.append("p")
        elif p.startswith("long long") or p.startswith("int64_t"):
            kinds.append("q")
        else:
            assert p.split()[0] == "int", (fn_name, p)
            kinds.append("i")
    return "".join(kinds)


@pytest.mark.parametrize("lib_name", sorted(native.SIGNATURES))
def test_native_signatures_match_the_c_entry_points(lib_name):
    """ctypes passes arguments as ``native.SIGNATURES`` declares them, set
    once at load: each declaration must match its C entry point, and every
    launch entry point of the source must be declared."""
    import os
    import re

    with open(os.path.join(native.CSRC, f"{lib_name}.cu")) as f:
        src = f.read()
    declared = native.SIGNATURES[lib_name]
    assert set(declared) == set(re.findall(r'extern "C" int (\w+_launch)\(', src))
    for fn_name, sig in declared.items():
        assert _c_signature(src, fn_name) == sig, fn_name
