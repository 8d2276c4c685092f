"""The entry-resident fleet route (tables over the dense budget) of the port
against the JAX package's, on the CPU.

Kernel level: ``fleet_solve_ref`` and ``fleet_solve`` (K3 -> K2 -> K16 per
chunk, K6, K5: their plain versions here) against the JAX ``_fleet_solve``
on the same seeded inputs, byte for byte on the wire and element for
element on the updated resident, in both row forms, with a resident wider
than ``k_out``, on the 21-bit (C <= 8192), 3-byte and int32 (C > 0xFFFF)
wires and with an entry cap below the total; and K16's plain version
against the matching stages of the JAX program.

Engine level: both engines at the same dense budget (0 unless a test says
otherwise) through the JAX package's multi-pass mutation fuzz, a k_res
growth, a route switch on table growth, a compaction, a forced overflow
rerun, a row named twice in one batch and a Duplicated result decoded
after a later pass. After every pass the outcomes, the host entry and meta
mirrors and the resident entries must be equal. Tolerance: exact."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.scheduler.fleet as jfleet
import karmada_tpu_torch
import karmada_tpu_torch.scheduler as TS
import karmada_tpu_torch.scheduler.fleet as tfleet
from karmada_tpu_torch.scheduler import fleet_kernels as fk
from karmada_tpu_torch.scheduler.fleet import _cap_round, _pow2

import chip_smoke
from test_torch_fleet import (CAP, CHUNK, J, T, assert_views_of, rows_for, spy_glue,
                              tables_state, variant)
from test_torch_fleet_engine import Pair, outcome

PKGS = (karmada_tpu, karmada_tpu_torch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# --------------------------------------------------------------------------
# the single-dispatch program
# --------------------------------------------------------------------------


def solve_inputs(c, kind, n, seed, chunk=CHUNK):
    """Seeded tables and state, a batch of ``n`` rows padded to whole
    chunks, and a resident that a JAX pass wrote and that was then
    perturbed: some rows' words changed, some zeroed."""
    tables, state = tables_state(seed, c)
    n_pad = -(-n // chunk) * chunk
    rows = rows_for(kind, n, n_pad, seed)
    wide, fast = variant(tables, state, c)
    has_agg = bool((state[4] == 3).any())
    reps = state[3][np.maximum(rows, 0)]
    k_out = min(c, _pow2(int(reps.max())))
    return tables, state, rows, n_pad, wide, fast, has_agg, k_out


def jax_solve(tables, state, rows, resident, **kw):
    flat, res = jfleet._fleet_solve(*map(J, tables), J(rows), *map(J, state),
                                    jnp.asarray(resident), **kw)
    return np.asarray(flat), np.asarray(res)


def perturbed_resident(tables, state, rows, k_res, kw, seed):
    """The resident after one JAX pass over ``rows``, then a few rows
    changed (a word bumped, a row zeroed) so the next pass finds both
    changed and unchanged rows."""
    _, res = jax_solve(tables, state, rows, np.zeros((CAP, k_res), np.int32),
                       **dict(kw, e_cap=1 << 16))
    res = res.copy()
    rng = np.random.default_rng(seed)
    live = rows[rows >= 0]
    for r in rng.choice(live, 30, replace=False):
        res[r, 0] += 1
    res[live[3]] = 0
    return res


CASES = [
    # c, kind, n, k_res extra columns, e_cap (None = the safe bound)
    (300, "all", 900, 0, None),
    (300, "part", 500, 16, None),
    (300, "all", 900, 16, 64),
    (300, "part", 500, 0, 64),
    (50, "all", 1000, 0, None),
    (9000, "all", 300, 8, None),
    (9000, "part", 300, 0, 64),
]


@pytest.mark.parametrize("c,kind,n,extra,e_cap", CASES)
def test_fleet_solve_equals_jax(c, kind, n, extra, e_cap, monkeypatch):
    """The wire byte for byte and the updated resident, for the plain
    version and for the chained wrappers (whose plain versions run here):
    pack21 at C <= 8192, the 3-byte wire above it, a resident wider than
    k_out, and an entry cap below the changed-entry total (the wire then
    carries the first e_cap entries and the full total). Each chunk's K16
    writes its rows of the pass-wide buffers K5 reads, metas included
    (no concatenation)."""
    seen = spy_glue(monkeypatch, "entry_diff", "entry_wire")
    tables, state, rows, n_pad, wide, fast, has_agg, k_out = solve_inputs(
        c, kind, n, 20 + c % 7)
    k_res = k_out + extra
    safe = int(np.minimum(state[3][rows[rows >= 0]], k_out).sum())
    kw = dict(chunk=CHUNK, n_chunks=n_pad // CHUNK, k_out=k_out, k_res=k_res,
              e_cap=e_cap or _cap_round(safe), wide=wide, fast=fast,
              has_aggregated=has_agg, all_rows=kind == "all",
              pack21=c <= 1 << 13)
    res0 = perturbed_resident(tables, state, rows, k_res, kw, 30 + c)
    w_flat, w_res = jax_solve(tables, state, rows, res0.copy(), **kw)
    for fn in (fk.fleet_solve_ref, fk.fleet_solve):
        t_res = T(res0.copy())
        g_flat, g_res = fn(*map(T, tables), T(rows), *map(T, state), t_res, **kw)
        assert g_res is t_res and g_flat.dtype == torch.uint8  # in place
        np.testing.assert_array_equal(g_flat.numpy(), w_flat, err_msg=fn.__name__)
        np.testing.assert_array_equal(g_res.numpy(), w_res, err_msg=fn.__name__)
    wire_args, wire_kw = seen["wire"]
    assert_views_of(seen["outs"], (wire_kw["meta"], wire_args[0]), CHUNK)
    total = int(w_flat[:4].view("<i4")[0])
    metas = w_flat[4 : 4 + 2 * n_pad].view("<u2")
    assert 0 < (metas >> 10 & 1).sum() < n  # changed and unchanged rows
    assert total > (e_cap or 0)


def test_fleet_solve_int32_wire_equals_jax(monkeypatch):
    """Above 0xFFFF clusters the wire is int32 [total, meta..., stream...],
    the metas written in place from K16's pass-wide buffer."""
    seen = spy_glue(monkeypatch, "entry_diff", "entry_wire")
    c, chunk = 0x10000 + 3, 64
    tables, state = tables_state(41, c, u=4, g=2, p=3)
    rows = rows_for("part", 50, chunk, 41)
    wide, fast = variant(tables, state, c)
    reps = state[3][rows[rows >= 0]]
    k_out = min(c, _pow2(int(reps.max())))
    kw = dict(chunk=chunk, n_chunks=1, k_out=k_out, k_res=k_out,
              e_cap=_cap_round(int(np.minimum(reps, k_out).sum())), wide=wide,
              fast=fast, has_aggregated=True, all_rows=False, pack21=False)
    res0 = np.zeros((CAP, k_out), np.int32)
    w_flat, w_res = jax_solve(tables, state, rows, res0.copy(), **kw)
    g_flat, g_res = fk.fleet_solve(*map(T, tables), T(rows), *map(T, state),
                                   T(res0.copy()), **kw)
    assert g_flat.dtype == torch.int32 and int(w_flat[0]) > 0
    np.testing.assert_array_equal(g_flat.numpy(), w_flat)
    np.testing.assert_array_equal(g_res.numpy(), w_res)
    wire_args, wire_kw = seen["wire"]
    assert_views_of(seen["outs"], (wire_kw["meta"], wire_args[0]), chunk)


def edge_solve_inputs(c, kind):
    """The card's edge batch of ``c`` (``chip_smoke.fleet_edge_tables``, k_prev
    32: duplicate, wrapping and negative previous counts, Duplicated rows,
    padding rows between live ones), its rows in the all-rows form
    (position j or -1) or as permuted table rows with one named twice."""
    t = chip_smoke.fleet_edge_tables(np.random.default_rng(1000 * c + 32), c, 32)
    rows = t["rows"].copy()
    if kind == "all":
        rows = np.where(rows >= 0, np.arange(rows.size, dtype=np.int32), -1)
    else:
        rows[2] = rows[1]  # one row named twice (rows[0] is padding)
    return t["tables"], t["state"], rows, rows.size, True, None, True


ENTRY_DIFF_CASES = [pytest.param(300, kind, None, id=kind) for kind in ("all", "part")] + [
    # the card's edge batches at k_out 1 (every row with two placed cells
    # truncates) and the fleet's widest, capped at C
    pytest.param(c, kind, k_out, id=f"edge-{c}-k{k_out}-{kind}")
    for c in chip_smoke.FLEET_EDGE_C
    for k_out in sorted({min(k, c) for k in chip_smoke.ENTRY_EDGE_K_OUT})
    for kind in ("all", "part")
]


@pytest.mark.parametrize("c,kind,k_out", ENTRY_DIFF_CASES)
def test_entry_diff_ref_equals_the_jax_stages(c, kind, k_out):
    """K16's plain version, chunk by chunk, against what the JAX program
    computes for the same rows: the meta words it ships (n_placed, unsched,
    has_cand, changed) and the entry rows it writes into the resident
    (those of the changed rows; the others must be zero), with the commit
    index naming each row the resident takes; on seeded tables and on the
    card's edge batches."""
    if k_out is None:
        tables, state, rows, n_pad, wide, fast, has_agg, k_out = solve_inputs(
            c, kind, 700, 50)
    else:
        tables, state, rows, n_pad, wide, fast, has_agg = edge_solve_inputs(c, kind)
    k_res = k_out + 8
    kw = dict(chunk=CHUNK, n_chunks=n_pad // CHUNK, k_out=k_out, k_res=k_res,
              e_cap=1 << 16, wide=wide, fast=fast, has_aggregated=has_agg,
              all_rows=kind == "all", pack21=True)
    res0 = perturbed_resident(tables, state, rows, k_res, kw, 51)
    w_flat, w_res = jax_solve(tables, state, rows, res0.copy(), **kw)
    w_meta = w_flat[4 : 4 + 2 * n_pad].view("<u2").astype(np.int32)
    tt, ts, resident = tuple(map(T, tables)), tuple(map(T, state)), T(res0)
    for i in range(n_pad // CHUNK):
        rows_c = T(rows[i * CHUNK : (i + 1) * CHUNK])
        m = fk.fleet_masks(*tt, rows_c, *ts)
        a, u = fk.divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w,
                                  m.avail, m.prev, m.fresh, has_agg, wide, fast)
        got = fk.entry_diff_ref(a, u, m.feasible, m.strategy, rows_c, resident,
                                k_out=k_out, all_rows=kind == "all", offset=i * CHUNK)
        sl = slice(i * CHUNK, (i + 1) * CHUNK)
        np.testing.assert_array_equal(got.meta.numpy(), w_meta[sl])
        ch = (w_meta[sl] >> 10 & 1).astype(bool)
        target = (np.arange(sl.start, sl.stop) if kind == "all"
                  else np.maximum(rows[sl], 0))
        want = np.where(ch[:, None], w_res[target], 0)
        np.testing.assert_array_equal(got.entries.numpy(), want)
        commit = got.commit.numpy()
        np.testing.assert_array_equal(commit >= 0, ch | ((rows[sl] < 0) & (kind == "all")))
        np.testing.assert_array_equal(commit[ch], target[ch])
    np.testing.assert_array_equal(resident.numpy(), res0)  # only read


def test_entry_diff_refuses_cuda_mismatch():
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.entry_diff(a, torch.zeros(4, dtype=torch.bool),
                      torch.zeros((4, 8), dtype=torch.bool),
                      torch.zeros(4, dtype=torch.int32),
                      torch.zeros(4, dtype=torch.int32, device="meta"),
                      torch.zeros((16, 8), dtype=torch.int32), k_out=4,
                      all_rows=False, offset=0)


# --------------------------------------------------------------------------
# the engine on the legacy route
# --------------------------------------------------------------------------


@pytest.fixture
def budget(monkeypatch):
    """Set both engines' dense budget (bytes) before their tables exist."""

    def set_budget(nbytes: int):
        monkeypatch.setattr(jfleet, "DENSE_RESIDENT_MAX_BYTES", nbytes)
        monkeypatch.setattr(tfleet, "DENSE_RESIDENT_MAX_BYTES", nbytes)

    set_budget(0)
    return set_budget


def legacy_state(fleet):
    res = fleet._resident_entries
    return (
        np.asarray(fleet._host_entries).copy(),
        np.asarray(fleet._host_meta).copy(),
        None if res is None else (res.numpy() if hasattr(res, "numpy") else np.asarray(res)).copy(),
    )


def assert_same_legacy_state(jax_fleet, port_fleet, label=""):
    assert port_fleet._resident_entries is not None, label
    assert port_fleet._res_dense is None, label  # the legacy route ran
    for a, b in zip(legacy_state(jax_fleet), legacy_state(port_fleet)):
        np.testing.assert_array_equal(b, a, err_msg=label)
    assert port_fleet._k_res == jax_fleet._k_res, label


def step(pair, batches, label):
    got = [outcome(e.schedule(b)) for e, b in zip(pair.engines, batches)]
    assert got[0] == got[1], label
    jt, tt = (e._fleet for e in pair.engines)
    assert_same_legacy_state(jt, tt, label)
    assert tt.last_breakdown["changed_rows"] == jt.last_breakdown["changed_rows"], label
    return got[1]


def mixed_problems(pkg, clusters, n, seed):
    """tests/test_fleet_engine.py's ``_mixed_problems``, for either package."""
    return __import__("chip_smoke").mixed_problems(pkg, clusters, n, seed)


def test_delta_fetch_sequence_fuzz_legacy(budget):
    """tests/test_fleet_engine.py::test_delta_fetch_sequence_fuzz[legacy]
    for both engines: 8 passes of replica bumps, prev rewrites, fresh
    flips, availability swaps and new bindings, full and partial batches,
    at budget 0 and chunk 64; every pass equal in outcomes, mirrors and
    resident."""
    b = [importlib.import_module(f"{p.__name__}.utils.builders") for p in PKGS]
    s = [importlib.import_module(f"{p.__name__}.scheduler") for p in PKGS]
    clusters = [bb.synthetic_fleet(40, seed=21) for bb in b]
    snaps = [ss.ClusterSnapshot(cl) for ss, cl in zip(s, clusters)]
    problems = [mixed_problems(p, cl, 240, 11) for p, cl in zip(PKGS, clusters)]
    engines = [JS.TensorScheduler(snaps[0], chunk_size=64),
               TS.TensorScheduler(snaps[1], chunk_size=64, device="cpu")]
    for e in engines:
        e.fleet_threshold = 1
    pair = type("P", (), {"engines": engines})()
    rng = np.random.default_rng(123)
    next_key = 240
    for pass_no in range(8):
        op = pass_no % 4
        draws = {}
        if op == 1:
            idx = rng.choice(240, 24, replace=False)
            for i in idx:
                draws[int(i)] = (int(rng.integers(0, 40)),
                                 [int(j) for j in rng.choice(40, 2, replace=False)]
                                 if rng.random() < 0.5 else [],
                                 [int(rng.integers(1, 9)) for _ in range(2)],
                                 bool(rng.random() < 0.3))
        drift = rng.integers(-2, 3, (40, 8)) if op == 2 else None
        grow = [int(rng.integers(0, 4)) for _ in range(16)] if op == 3 else None
        grow_reps = [int(rng.integers(0, 40)) for _ in range(16)] if op == 3 else None
        part = (sorted(int(j) for j in rng.choice(len(problems[0]) + (16 if op == 3 else 0),
                                                  96, replace=False))
                if pass_no % 2 else None)
        for k in range(2):
            probs, cl = problems[k], clusters[k]
            for i, (reps, sites, counts, fresh) in draws.items():
                p = probs[i]
                probs[i] = s[k].BindingProblem(
                    key=p.key, placement=p.placement, replicas=reps,
                    requests=p.requests, gvk=p.gvk,
                    prev={cl[j].name: c for j, c in zip(sites, counts)}, fresh=fresh)
            if drift is not None:
                for ci, c_ in enumerate(cl):
                    rs = c_.status.resource_summary
                    for di, (dim, q) in enumerate(sorted(rs.allocated.items())):
                        cap = rs.allocatable.get(dim, 0)
                        rs.allocated[dim] = int(min(max(0, q + int(drift[ci, di])
                                                        * max(1, cap // 100)), cap))
                assert engines[k].update_snapshot(s[k].ClusterSnapshot(cl))
            if grow is not None:
                for g, (pl, reps) in enumerate(zip(grow, grow_reps)):
                    probs.append(s[k].BindingProblem(
                        key=f"b{next_key + g}", placement=probs[pl].placement,
                        replicas=reps, requests=probs[0].requests,
                        gvk="apps/v1/Deployment"))
        if grow is not None:
            next_key += 16
        batches = [p if part is None else [p[j] for j in part] for p in problems]
        step(pair, batches, f"pass {pass_no}")


def test_k_res_growth_resets_the_resident(budget):
    """A straggler batch with more replicas widens k_res: the resident and
    the host entry mirror reset together (the dense route pads its mirror
    instead), so the pass reports every placed row as changed, in both
    engines alike."""
    pair = Pair()
    small = pair.problems(list(range(300)), 60)
    for k, pkg in enumerate(PKGS):
        s = importlib.import_module(f"{pkg.__name__}.scheduler")
        small[k] = [s.BindingProblem(key=p.key, placement=p.placement,
                                     replicas=p.replicas % 8, requests=p.requests,
                                     gvk=p.gvk, prev=p.prev, fresh=p.fresh)
                    for p in small[k]]
    step(pair, small, "small replicas")
    port = pair.engines[1]._fleet
    k0 = port._k_res
    step(pair, small, "steady")
    assert port.last_breakdown["changed_rows"] == 0
    wide = pair.problems(list(range(300)), 60)
    out = step(pair, wide, "straggler with more replicas")
    assert port._k_res > k0 and port._host_entries.shape[1] == port._k_res
    with_entries = int((port._host_entries[:300] != 0).any(axis=1).sum())
    assert port.last_breakdown["changed_rows"] == with_entries > 150
    assert sum(1 for o in out if o[2] == "") >= with_entries


def test_route_switch_on_growth(budget):
    """A table that grows past the dense budget moves from the dense route
    to the legacy route between passes; the first legacy pass starts from
    zeroed residents and reports every row with placed entries as
    changed."""
    pair = Pair()
    first = pair.problems(list(range(300)), 61)
    # the first table (cap 512 x 60 clusters) fits, the grown one does not
    budget(512 * 60)
    got = [outcome(e.schedule(b)) for e, b in zip(pair.engines, first)]
    assert got[0] == got[1]
    port = pair.engines[1]._fleet
    assert port._res_dense is not None and port._resident_entries is None
    grown = pair.problems(list(range(700)), 62)
    step(pair, grown, "grown past the budget")
    assert port.cap == 1024 and port._res_dense is None
    with_entries = int((port._host_entries[:700] != 0).any(axis=1).sum())
    assert port.last_breakdown["changed_rows"] == with_entries > 300


def test_compaction_resets_the_resident(budget):
    """Rows idle for COMPACT_IDLE_PASSES are compacted away before new keys
    would grow the table; the row ids move, so the resident resets and
    the next pass reports every row with entries as changed."""
    pair = Pair()
    step(pair, pair.problems(list(range(700)), 63), "700 keys")
    live = list(range(300))
    sub = pair.problems(live, 63)
    for _ in range(tfleet.FleetTable.COMPACT_IDLE_PASSES + 1):
        step(pair, sub, "subset")
    port = pair.engines[1]._fleet
    cap1 = port.cap
    fresh_keys = live + list(range(5000, 5350))
    step(pair, pair.problems(fresh_keys, 64), "compaction")
    assert port.n_rows == len(fresh_keys) and port.cap == cap1 == 1024
    with_entries = int((port._host_entries[:650] != 0).any(axis=1).sum())
    assert port.last_breakdown["changed_rows"] == with_entries > 200
    pair.drift(9)
    step(pair, pair.problems(fresh_keys, 64), "drift after compaction")


def test_forced_overflow_rerun(budget):
    """An entry cap below a churn pass's changed entries overflows: the
    first dispatch has already written the resident, so the rerun diffs
    against a re-upload of the host mirror. Diffing against the written
    resident would report no row changed and fold nothing."""
    pair = Pair()
    keys = list(range(400))
    b1 = pair.problems(keys, 65)
    step(pair, b1, "cold")
    for e in pair.engines:  # the smallest cap, as after quiet passes
        e._fleet._e_cap_cur, e._fleet._last_total = 1024, 0
    port = pair.engines[1]._fleet
    before = port.overflow_reruns
    b2 = pair.problems(keys, 66)
    step(pair, b2, "churn over the cap")
    assert port.overflow_reruns == before + 1
    assert port._last_total > 1024 and port.last_breakdown["changed_rows"] > 200
    step(pair, b2, "steady after the rerun")
    assert port.last_breakdown["changed_rows"] == 0


def test_row_named_twice_in_one_batch(budget):
    """Two problems with one key name one table row twice in a batch, in
    different chunks. JAX diffs both occurrences against the pre-pass
    resident, so both are changed and both ship their entries; the port
    diffs every chunk before it writes the resident, and agrees."""
    pair = Pair()
    keys = list(range(300))
    base = pair.problems(keys, 67)
    step(pair, base, "cold")
    other = pair.problems(keys, 68)
    twice = []
    for k in range(2):
        p = other[k][0]  # key b0, a Dynamic row, with new content
        twice.append(base[k] + [p])
        base[k][0] = p
    got = step(pair, twice, "row b0 named twice")
    assert got[0] == got[-1] and got[0][1]
    port = pair.engines[1]._fleet
    assert port._reuse is not None and len(set(port._reuse[2].tolist())) == 300
    jt = pair.engines[0]._fleet
    assert port._last_total == jt._last_total


def test_duplicated_result_decoded_after_a_later_pass(budget):
    """A Duplicated row's feasible set is computed lazily from the inputs
    of its own pass, on the legacy route as on the dense one: read after a
    second pass moved the row to a narrower placement, the port's set is
    the first pass's (the JAX set read before that pass)."""
    pair = Pair()
    keys = list(range(300))
    first = pair.problems(keys, 15)
    second = pair.problems(keys, 15)
    for k, (pkg, fleet) in enumerate(zip(PKGS, pair.fleets)):
        api = importlib.import_module(f"{pkg.__name__}.api")
        b = importlib.import_module(f"{pkg.__name__}.utils.builders")
        s = importlib.import_module(f"{pkg.__name__}.scheduler")
        narrow = b.duplicated_placement(cluster_affinity=api.ClusterAffinity(
            cluster_names=[c.name for c in fleet[:5]]))
        p = first[k][1]
        second[k][1] = s.BindingProblem(
            key=p.key, placement=narrow, replicas=p.replicas or 3,
            requests=p.requests, gvk=p.gvk, prev=p.prev, fresh=p.fresh)
    held = [e.schedule(b) for e, b in zip(pair.engines, first)]
    want = sorted(held[0][1].clusters)
    step(pair, second, "narrowed")
    assert sorted(held[1][1].clusters) == want and len(want) > 5
    placed = next(i for i in range(300) if first[1][i].replicas and i % 4 == 0)
    with pytest.raises(RuntimeError, match="stale"):
        held[1][placed].clusters


def test_dense_budget_env_is_read_at_table_construction(monkeypatch, capsys):
    """``KARMADA_TPU_DENSE_BUDGET`` sets the table's dense budget when the
    table is built; a malformed value prints the JAX table's stderr line
    and leaves the default."""
    monkeypatch.setenv("KARMADA_TPU_DENSE_BUDGET", "12345")
    assert tfleet._budgets(torch.device("cpu"))[0] == 12345
    monkeypatch.setenv("KARMADA_TPU_DENSE_BUDGET", "0")
    pair = Pair()
    batch = pair.problems(list(range(300)), 69)[1]
    pair.engines[1].schedule(batch)
    assert pair.engines[1]._fleet.dense_budget == 0
    assert pair.engines[1]._fleet._resident_entries is not None
    monkeypatch.setenv("KARMADA_TPU_DENSE_BUDGET", "6G")
    capsys.readouterr()
    assert tfleet._budgets(torch.device("cpu")) == (
        tfleet.DENSE_RESIDENT_MAX_BYTES, tfleet.CP_TABLE_MAX_BYTES)
    port_line = capsys.readouterr().err
    assert jfleet._dense_budget() == 6 << 30
    assert port_line == capsys.readouterr().err != ""


def test_chip_smoke_legacy_phases_rehearse_on_cpu(capsys):
    """chip_smoke's legacy phases end to end on the CPU at a small size: the
    config-5 storm at a dense budget of 0 (set through the environment
    variable) on the dense storm's problems and drift, equal to it pass
    for pass, with K16 and the whole pass checked on the table and an
    overflow rerun on the first churn pass; then the mixed phase on both
    routes, the legacy one with its gathered third pass equal to the dense
    phase's rows."""
    import chip_smoke

    cpu = torch.device("cpu")
    kw = dict(bindings=1500, clusters=200, steady=2, churn=2)
    dense = chip_smoke.run_fleet_storm(cpu, "cpu", **kw)
    legacy = chip_smoke.run_fleet_storm(cpu, "cpu", legacy=True,
                                        reference=dense["digests"], **kw)
    assert set(legacy["stats"]) == {"entry_diff"}
    assert legacy["reruns"][0] >= 1 and legacy["engine"]._fleet.dense_budget == 0
    assert len(legacy["digests"]["churn"]) == 2
    mixed = chip_smoke.run_mixed(cpu, "cpu", bindings=800, clusters=100, changed=40)
    chip_smoke.run_mixed(cpu, "cpu", bindings=800, clusters=100, changed=40,
                         legacy=True, reference=mixed["digests"])
    printed = capsys.readouterr().out
    assert printed.count("ok / 0 bad") >= 6 and "fleet_solve_ref" in printed
    assert "gathered chunk" in printed and "overflow reruns 1" in printed
