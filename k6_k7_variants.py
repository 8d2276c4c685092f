#!/usr/bin/env python3
"""Time K6 (``scatter_rows``: the resident commit and the dirty-row upsert;
``gather_meta``) and K7 (``model_overlay``) as built from one or more kernel
source directories, side by side, on one NVIDIA GPU, beside each form's
launch floor at its own grid and, for K6, torch's ``index_copy_``.

    python3 k6_k7_variants.py [CSRC_DIR ...]

Each directory named (``kernel_variants.start``: ``P N N P`` gives parent,
new, new, parent in one call) has its ``scatter_rows.cu`` and
``model_estimate.cu`` compiled on their own (``-Xptxas -v``: registers and
spills printed), held to the plain versions (``scatter_rows_ref``,
``gather_meta_ref``, ``model_overlay_ref``; exact) and timed behind the
device spin on every shape. The source forms known:

- the first slice's: K6 a 128-thread block a row, a byte a thread; K7 a
  thread a (profile, cluster) cell, its cluster's bounds read strided from
  global memory, an int64 division per requested dim and grade;
- the Hopper forms: K6 one wave of resident blocks, a warp a group of 32
  rows, one field and one slice, the rows outside [0, cap) dropped by
  ballot, the kept rows copied as one stream of 16-B (or narrower) units
  (the gather keeps the first-slice body); K7 a block a tile of clusters by
  a few profile lanes over a slice of the profiles, the tile's bounds
  staged once, each requested dim's multiplier and shift once a block
  (``divmagic.cuh``).

Shapes. K6's commit form at config 5's entry-resident shape, 102,400 rows
x k_res = 136 int32 (544 B), into a resident of as many rows: every row
committed (a cold pass), none (a steady pass) and a seeded half (a churn
pass), and a small table's 10,240 rows half committed; ``index_copy_``
of the committed rows alone is its yardstick, their indices and entries
compacted outside the timed window. The dirty-row
upsert at the smoke's shape: 512 rows (300 distinct, padded by repeating
the first) of the eight state fields (widths 4, 4, 4, 4, 1, 1, 128, 128 B)
of a 102,400-row table, beside one ``index_copy_`` a field. The gather at
65,536 rows, 53,953 of them named (the first churn pass's changed rows).
K7 on the config-5 models table's own inputs (caught at its first launch
through an engine on the card: 8 profiles x 5000 clusters x 9 grades),
on ``chip_smoke.model_batch`` at 64 x 5000 and 1024 x 5000 (R = 4), and at
64 x 5000 with 16 grades x 17 dims and x 41 dims (past the shared-memory
stage: the bounds read from global memory). Prints one line a measurement
and writes ``chiprun_out/k6_k7_variants.json``. K7's Hopper form is split
on every shape by copies that stop after a part (the prologue: the tile's
stage and the first multipliers) or leave one out (the grade sum; the
walk, so that every grade is summed), each cut made in both of its
bodies: ``MODEL_WITHOUT``, timed, not held. Its other read paths
(``MODEL_OTHER``: the general body at R <= 4, a 200 KB stage at 41 dims)
are held and timed beside it where they would run. Builds, calls and times
through ``kernel_variants``. Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
import tempfile

import numpy as np

import chip_smoke as cs
import kernel_variants as kv
import launch_floors

NAMES = ("scatter_rows", "model_estimate")
#: the timed entry point -> (library, C entry point)
ENTRY = {
    "scatter_rows": ("scatter_rows", "scatter_rows_launch"),
    "gather_meta": ("scatter_rows", "gather_meta_launch"),
    "model_overlay": ("model_estimate", "model_overlay_launch"),
}
ROWS = 102_400  # config 5's rows at its 4096-row chunk
SMALL_ROWS = 10_240  # the mixed phase's 10k rows


#: the Hopper K7's copies, each leaving one part out or stopping after one
#: (their answers are not exact: timed, not held); each edits every body
#: that holds the part, so that the split is of the body that runs at R
MODEL_WITHOUT = {
    "alone: the prologue": (  # the stage and the first multipliers
        ("  // the cluster's constants\n",
         "  if (a.u_n > 0) return;\n  // the cluster's constants\n"),
    ),
    "without the grade sum": (
        ("        for (int g = idx; g < G; ++g) {\n          unsigned long long per = SENTINEL;\n"
         "#pragma unroll",
         "        for (int g = G; g < G; ++g) {\n          unsigned long long per = SENTINEL;\n"
         "#pragma unroll"),
        ("        for (int g = idx; g < G; ++g) {\n          unsigned long long per = SENTINEL;\n"
         "          for (int r = 0; r < R; ++r)",
         "        for (int g = G; g < G; ++g) {\n          unsigned long long per = SENTINEL;\n"
         "          for (int r = 0; r < R; ++r)"),
    ),
    "without the walk (every grade summed)": (
        ("        for (int g = 0; g < G; ++g) {\n#pragma unroll\n",
         "        idx = 0;\n        for (int g = G; g < G; ++g) {\n#pragma unroll\n"),
        ("        for (int r = 0; r < R && idx < G; ++r) {",
         "        for (int r = R; r < R && idx < G; ++r) {"),
    ),
}

#: the Hopper K7's other read paths, exact, each timed beside the whole on
#: the shapes where it would run: the general body (any R) also at R <= 4,
#: in place of the body that holds 4 dims' multipliers in registers; and
#: the tile staged in shared memory up to 200 KB, where the whole reads a
#: wide G x R from global memory
MODEL_OTHER = {
    "general body": (("  if (r_dims > 4) return", "  if (r_dims > 0) return"),),
    "staged to 200 KB": (("STAGE_MOST = 100 * 1024;", "STAGE_MOST = 200 * 1024;"),),
}


def form(name: str, src: str) -> str:
    if name == "scatter_rows":
        return "block a row" if "scatter_rows_kernel<<<k, THREADS" in src else "warp groups"
    return ("thread a cell" if "const dim3 grid((c_n + TILE_C - 1) / TILE_C, u_n);" in src
            else "cluster tiles")


def sources(dirs: list) -> dict:
    """(dir, kernel, variant) -> source text: the whole of each kernel and
    each with its launch floor appended."""
    out = {}
    for d in dirs:
        for name in NAMES:
            src = kv.source(d, name)
            out[(d, name, "whole")] = src
            out[(d, name, "floor")] = launch_floors.floor_source(name, form(name, src), src)
            if form(name, src) == "cluster tiles":
                for var, text in kv.variants("k6_k7_variants", name, src,
                                             {**MODEL_WITHOUT, **MODEL_OTHER}).items():
                    out[(d, name, var)] = text
    return out


def caller(lib, entry: str, t: dict):
    """A function that runs one launch of ``lib``'s ``entry`` on its own
    copy of ``t``'s written tensors (so that no directory's launch writes
    another's) and returns what it wrote. Both entry points that write in
    place are idempotent on their inputs, so repeated calls time them."""
    import ctypes

    import torch
    from karmada_tpu_torch import native

    lib_name, fname = ENTRY[entry]
    rows = t.get("rows")
    dev = t["table"].device if entry == "model_overlay" else rows.device
    run = kv.entry(lib, fname, native.SIGNATURES[lib_name][fname], dev)
    if entry == "scatter_rows":
        state = tuple(a.clone() for a in t["state"])
        nf, k, cap = len(state), rows.shape[0], state[0].shape[0]
        ptrs = ctypes.c_void_p * 8
        dst = ptrs(*[a.data_ptr() for a in state], *[None] * (8 - nf))
        src = ptrs(*[v.data_ptr() for v in t["vals"]], *[None] * (8 - nf))
        wid = (ctypes.c_int * 8)(*[a[0].numel() * a.element_size() for a in state],
                                 *[0] * (8 - nf))

        def call():
            run(dst, src, wid, nf, rows, k, cap)
            return state
        return call
    if entry == "gather_meta":
        meta = t["meta"]

        def call():
            out = torch.empty((2 * rows.shape[0],), dtype=torch.uint8, device=rows.device)
            run(meta, meta.shape[0], rows, rows.shape[0], out)
            return out
        return call
    table = t["table"].clone()
    c, g, r = t["min_bounds"].shape
    u = t["requests"].shape[0]

    def call():
        run(t["min_bounds"], t["counts"], t["covered"], c, g, r, t["requests"], u,
            t["has_models"], t["has_summary"], t["available_cap"], t["pods_dim"], table)
        return table
    return call


def plain(entry: str, t: dict):
    from karmada_tpu_torch.models import modeling as mm
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    if entry == "scatter_rows":
        state = tuple(a.clone() for a in t["state"])
        return lambda: fk.scatter_rows_ref(state, t["rows"], t["vals"])
    if entry == "gather_meta":
        return lambda: fk.gather_meta_ref(t["meta"], t["rows"])
    table = t["table"].clone()
    return lambda: mm.model_overlay_ref(
        table, *(t[k] for k in ("min_bounds", "counts", "covered", "requests", "has_models",
                                "has_summary", "available_cap")), t["pods_dim"])


def bound(entry: str, t: dict, want) -> tuple[float, str]:
    """The bound of ``entry`` on ``t`` as ``chip_smoke`` counts it: each
    input byte the function needs read once and each output byte written
    once over HBM rate, against its plain definition's operations; the
    larger."""
    rows = t.get("rows")
    if entry == "scatter_rows":
        cap = t["state"][0].shape[0]
        ok = (rows >= 0) & (rows < cap)
        distinct = int(rows[ok].unique().numel())
        row_bytes = sum(v[0].numel() * v.element_size() for v in t["vals"])
        # the index once, each kept value row read once, each distinct row written once
        nbytes = cs._nbytes(rows) + int(ok.sum().item()) * row_bytes + distinct * row_bytes
        return cs._bound(nbytes, rows.numel())
    if entry == "gather_meta":
        named = int((rows >= 0).sum().item())
        return cs._bound(cs._nbytes(rows, want) + 4 * named, rows.numel() * 3)
    pack = [t[k] for k in ("min_bounds", "counts", "covered", "requests", "has_models",
                           "has_summary", "available_cap")]
    c, g, r = t["min_bounds"].shape
    # the table written once: the kernel never reads it (where the general
    # answer stands it leaves the cell)
    return cs._bound(cs._nbytes(*pack) + cs._nbytes(t["table"]),
                     cs._model_ops(t["requests"].shape[0], c, g, r))


def floor_args(entry: str, t: dict) -> tuple:
    if entry == "scatter_rows":
        return t["rows"].shape[0], len(t["state"]), launch_floors.scatter_floor_arg(
            [a[0].numel() * a.element_size() for a in t["state"]])
    if entry == "gather_meta":
        return t["rows"].shape[0], 0, 0
    c, g, r = t["min_bounds"].shape
    return t["requests"].shape[0], c, launch_floors.model_floor_arg(g, r)


def library(entry: str, t: dict):
    """torch's ``index_copy_`` of the kept rows of every field (the indices
    and values compacted here, outside the timed window); None for the
    other entry points."""
    if entry != "scatter_rows":
        return None
    rows = t["rows"]
    state = tuple(a.clone() for a in t["state"])
    ok = (rows >= 0) & (rows < state[0].shape[0])
    idx = rows[ok].contiguous()
    vals = tuple(v[ok].contiguous() for v in t["vals"])

    def call():
        for a, v in zip(state, vals):
            a.index_copy_(0, idx, v)
    return call


def commit_shapes(rng, device) -> list:
    """K6's commit form at config 5's entry-resident shape: cold, steady and
    churn commit indices over the same resident and entries."""
    import torch

    resident = torch.from_numpy(rng.integers(0, 1 << 20, (ROWS, cs.K_RES)).astype(np.int32))
    entries = torch.from_numpy(rng.integers(0, 1 << 20, (ROWS, cs.K_RES)).astype(np.int32))
    resident, entries = resident.to(device), entries.to(device)
    every = np.arange(ROWS, dtype=np.int64)
    half = np.where(rng.random(ROWS) < 0.53, every, -1)
    out = []
    for label, commit in (("every row committed (cold)", every),
                          ("no row committed (steady)", np.full(ROWS, -1, np.int64)),
                          ("53% committed (churn)", half)):
        out.append(("scatter_rows", f"commit {ROWS} x {cs.K_RES}, {label}",
                    {"state": (resident,), "vals": (entries,),
                     "rows": torch.from_numpy(commit).to(device)}))
    # a small table's pass (the mixed phase's 10k rows), half committed
    small = SMALL_ROWS
    out.append(("scatter_rows", f"commit {small} x {cs.K_RES}, 53% committed (a small table)",
                {"state": (resident[:small],), "vals": (entries[:small],),
                 "rows": torch.from_numpy(half[:small]).to(device)}))
    return out


def dirty_shape(rng, device) -> tuple:
    """The dirty-row upsert as the smoke's check runs it: 300 distinct rows
    padded to 512 by repeating the first, the eight state fields."""
    import torch

    k_u, k = 300, 512
    pick = rng.choice(ROWS, k_u, replace=False)
    rows = np.concatenate([pick, np.full(k - k_u, pick[0])]).astype(np.int64)
    state, vals = [], []
    for dtype, shape in cs.STATE_FIELD_KINDS:
        state.append(torch.from_numpy(cs._field(rng, dtype, (ROWS, *shape))).to(device))
        donor = cs._field(rng, dtype, (ROWS, *shape))  # values by row: one a row
        vals.append(torch.from_numpy(np.ascontiguousarray(donor[rows])).to(device))
    return ("scatter_rows", "dirty upsert 512 rows (300 distinct) x 8 fields",
            {"state": tuple(state), "vals": tuple(vals), "rows": torch.from_numpy(rows).to(device)})


def gather_shape(rng, device) -> tuple:
    import torch

    rows = np.full(65_536, -1, np.int32)
    rows[:53_953] = rng.choice(ROWS, 53_953, replace=False)
    meta = rng.integers(0, 1 << 11, ROWS).astype(np.int32)
    return ("gather_meta", "gather 65,536 rows (53,953 named)",
            {"meta": torch.from_numpy(meta).to(device), "rows": torch.from_numpy(rows).to(device)})


def models_table(device) -> dict:
    """K7's inputs at its first launch through a config-5 models engine on
    the card (the table rebuild of a fleet pass over the first 4096 rows)."""
    import karmada_tpu_torch as pkg
    from karmada_tpu_torch.scheduler import TensorScheduler, core

    snap, problems = cs.build_workload(pkg, 5, models=True)
    engine = TensorScheduler(snap, device=device)
    got = {}
    fn = core.model_overlay

    def spy(table, *args):
        if not got:
            got.update(zip(("table", "min_bounds", "counts", "covered", "requests",
                            "has_models", "has_summary", "available_cap"),
                           (a.clone() for a in (table, *args[:7]))))
            got["pods_dim"] = args[7]
        return fn(table, *args)
    core.model_overlay = spy
    try:
        engine.schedule(problems[:4096])
        cs.sync(device)
    finally:
        core.model_overlay = fn
    if not got:
        raise SystemExit("k6_k7_variants: the models pass never launched K7")
    return got


def model_shapes(rng, device) -> list:
    import torch
    from karmada_tpu_torch import ops

    t = models_table(device)
    u, c = t["table"].shape
    out = [("model_overlay", f"config-5 models table {u} x {c} x {t['min_bounds'].shape[1]}", t)]
    for u, g, r in ((64, 9, 4), (1024, 9, 4), (64, 16, 17), (64, 16, 41)):
        b = cs.to_device(cs.model_batch(rng, u, 5000, g=g, r=r), device)
        b["table"] = ops.profile_table(b["available_cap"], b["requests"], b["has_summary"])
        b["pods_dim"] = 2 if r == 4 else r - 1
        out.append(("model_overlay", f"model_batch {u} x 5000 x {g}, R = {r}", b))
    return out


def others(t: dict) -> list:
    """The ``MODEL_OTHER`` read paths that would run on ``t`` in place of
    the whole's: the general body at R <= 4, the 200 KB stage where the
    whole's stage (32 clusters) passes 100 KB."""
    _, g, r = t["min_bounds"].shape
    out = ["general body"] if r <= 4 else []
    if 32 * ((g * r) | 1) * 8 + 32 * (g | 1) * 4 > 100 * 1024:
        out.append("staged to 200 KB")
    return out


def split(libs, d: str, label: str, t: dict, whole_call, want, card: str) -> dict:
    """The Hopper K7's split on ``t``: each ``MODEL_WITHOUT`` copy timed
    beside the whole (medians of 3); a part's share is the whole less the
    copy without it, a stop's the copy's own time. Then each of
    ``others(t)`` held to ``want``, exactly, and timed whole, other,
    other, whole (medians of 3 each)."""
    whole = statistics.median(cs.cuda_ms(whole_call) for _ in range(3))
    cut_ms = {cut: statistics.median(cs.cuda_ms(caller(libs[(d, "model_estimate", cut)],
                                                        "model_overlay", t))
                                     for _ in range(3)) for cut in MODEL_WITHOUT}
    phases = {cut.replace("without ", ""): ms if cut.startswith("alone: ") else whole - ms
              for cut, ms in cut_ms.items()}
    print(f"# model_overlay {label}: cluster tiles form's split (whole {whole:.4f} ms): "
          + ", ".join(f"{c} {v:.4f} ms" for c, v in phases.items()) + f" ({d}); card {card}",
          flush=True)
    other_ms = {}
    for var in others(t):
        call = caller(libs[(d, "model_estimate", var)], "model_overlay", t)
        cs.compare(f"model_overlay {label} {var} ({d})", call(), want)
        ms = [statistics.median(cs.cuda_ms(f) for _ in range(3))
              for f in (whole_call, call, call, whole_call)]
        other_ms[var] = {"whole_ms": (ms[0] + ms[3]) / 2, "other_ms": (ms[1] + ms[2]) / 2,
                         "order": ms}
        print(f"# model_overlay {label}: whole {ms[0]:.4f} / {ms[3]:.4f} ms, {var} "
              f"{ms[1]:.4f} / {ms[2]:.4f} ms, exact ({d}); card {card}", flush=True)
    return {"shape": label, "dir": d, "whole_ms": whole, "cut_ms": cut_ms, "phases": phases,
            "others": other_ms}


def main(argv: list) -> int:
    import torch

    setup = kv.start(argv, "k6_k7_variants")
    if setup is None:
        return 1
    device, card, named, dirs = setup
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build("k6_k7_variants", sources(dirs), tmp, ptxas=True)
        forms = {d: {n: form(n, kv.source(d, n)) for n in NAMES} for d in dirs}
        rng = np.random.default_rng(cs.SEED)
        shapes = (commit_shapes(rng, device) + [dirty_shape(rng, device),
                                                gather_shape(rng, device)]
                  + model_shapes(rng, device))
        results = {"card": card, "dirs": named, "times": [], "splits": []}
        for entry, label, t in shapes:
            lib_name = ENTRY[entry][0]
            want = plain(entry, t)()
            calls = {d: caller(libs[(d, lib_name, "whole")], entry, t) for d in dirs}
            row = kv.time_row(entry, label, calls, want, named,
                              {d: forms[d][lib_name] for d in dirs}, card)
            row["bound_ms"], row["bound_by"] = bound(entry, t, want)
            lib = library(entry, t)
            row["library_ms"] = cs.cuda_ms(lib) if lib is not None else None
            row["floors"] = []
            for d in named:
                run = kv.entry(libs[(d, lib_name, "floor")], "launch_floor_launch",
                               launch_floors.FLOOR_SIGNATURE, device)
                fa = floor_args(entry, t)
                fl = cs.cuda_ms(lambda: run(*fa))
                row["floors"].append({"dir": d, "form": forms[d][lib_name], "floor_ms": fl})
                print(f"# {entry} {label}: launch floor at the {forms[d][lib_name]} form's grid "
                      f"{fl:.4f} ms ({d}); card {card}", flush=True)
            print(f"# {entry} {label}: bound {row['bound_ms']:.6f} ms by {row['bound_by']}"
                  + (f"; index_copy_ {row['library_ms']:.4f} ms" if lib is not None else "")
                  + f"; card {card}", flush=True)
            if entry == "model_overlay":
                for d in dirs:
                    if d in row["held"] and forms[d][lib_name] == "cluster tiles":
                        results["splits"].append(split(libs, d, label, t, row["held"][d], want,
                                                        card))
            row.pop("held")
            results["times"].append(row)
            del t, want, calls
            torch.cuda.empty_cache()
    kv.write(results, "k6_k7_variants")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
