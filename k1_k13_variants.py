#!/usr/bin/env python3
"""Time K13's per-row form (``quota_cluster_caps``) and K1 in its three forms
(``estimate_merge``, ``profile_table``, ``estimate_merge_table``) as built
from one or more kernel source directories, side by side, on one NVIDIA GPU,
and split each form's time into its phases.

    python3 k1_k13_variants.py [CSRC_DIR ...]

Each directory named (``kernel_variants.start``: ``P N N P`` gives parent,
new, new, parent in one call) has its ``quota_caps.cu`` and
``estimate_merge.cu`` compiled on their own (``-Xptxas -v``: registers and
spills printed), held to the plain versions (``cluster_caps_ref``,
``estimate_merge_ref``, ``profile_table_ref``, ``estimate_merge_table_ref``;
exact) and timed behind the device spin on every shape. The source forms
known:

- the first slice's: K13 a thread a cell, an int64 division per requested
  dim and a fresh read of the cell's caps; K1 a column a thread, 128 rows
  walked in series a block with dependent loads of each row's scalars, the
  U x 128 profile table recomputed by every row block with int64
  divisions, and the merge form's extras four a launch;
- the Hopper forms (``row_tiles.cuh``, ``divmagic.cuh``): K13 a block's
  rows ranked by namespace, a namespace's caps in registers, a
  multiplier-and-shift product per requested dim; K1 a row-streaming body,
  four columns a thread, the run's row scalars in shared memory, the
  profile table (or each row's multipliers) once a block, up to 32 extras a
  launch through a by-value argument struct.

The phase split: copies cut by text, each timed beside the whole. Of the
first-slice forms, cumulative cuts, so the differences are each phase's
share: K13 stores only (each cell's row and column from a 2-D grid, no
caps loads, no division), then with the caps loads, then with the
divisions, then whole (the 64-bit ``cell / c_n`` a thread that the 2-D
grid replaced); K1 the prologue alone (the per-block profile table;
nothing in the table and merge forms), then the row loop without its
dependent loads of the row scalars (each row's profile ``b & 7``, its
replicas ``b & 63``), then whole. Of the Hopper
forms, copies that leave one part out (not exact: timed, not held): K13
without its high products, and its fills alone and its prologue alone (the
copies that return after them); K1's shared-table form without its row
loop (the prologue alone). Beside them, torch's own ``fill_`` and
``copy_`` of an 82 MB int32 tensor (the write and read-write streams at
the outputs' size).

Shapes: K13 on ``chip_smoke.caps_batch`` (4096 x 5000, N = 8, R = 4, and
R = 17, past the four dims whose caps stay in registers) and
on the paths' own first chunks (the quota cell's recipe on the general
route: 4 capped namespaces capping cluster 0, 7 of 8 rows uncapped; the
ranked cell's: caps on 600 clusters); K1 ``estimate_merge`` on
``chip_smoke.estimate_batch`` (4096 x 5000, U = 9) and on config 5's
general chunk 0; the merge form at 4096 x 5000 with E = 0, 1, 2, 5 and 9
(``check_merge_table``'s draws) and on the models general pass's chunk 0
(E = 0), the quota chunk's and the ranked chunk's (E = 1); the table form at
8 x 5000, beside the launch floor of each form's grid there (an empty
kernel appended to the source, ``launch_floors.FLOORS``). A path's chunk
is its first 4096 rows through an engine on the card, each kernel's inputs
caught at its first launch. Prints one line a measurement and writes
``chiprun_out/k1_k13_variants.json``. Builds, calls and times through
``kernel_variants``. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
import tempfile

import numpy as np

import chip_smoke as cs
import kernel_variants as kv
import launch_floors

NAMES = ("quota_caps", "estimate_merge")
#: the timed entry point -> (library, C entry point)
ENTRY = {
    "quota_cluster_caps": ("quota_caps", "quota_caps_launch"),
    "estimate_merge": ("estimate_merge", "estimate_merge_launch"),
    "profile_table": ("estimate_merge", "profile_table_launch"),
    "estimate_merge_table": ("estimate_merge", "estimate_merge_table_launch"),
}

#: the first-slice K13's cuts, cumulative: (text, replacement) pairs in turn.
#: CAPS_INDEX gives each cell its row and column from a 2-D grid (a block
#: of 256 columns of one row), in place of the 64-bit ``cell / c_n`` a thread
CAPS_INDEX = (
    ("  const size_t cell = (size_t)blockIdx.x * THREADS + threadIdx.x;\n"
     "  if (cell >= (size_t)b_n * c_n) return;\n  const int b = (int)(cell / c_n);\n"
     "  const int c = (int)(cell - (size_t)b * c_n);",
     "  const int b = blockIdx.y;\n  const int c = blockIdx.x * THREADS + threadIdx.x;\n"
     "  if (c >= c_n) return;\n  const size_t cell = (size_t)b * c_n + c;"),
    ("  quota_caps_kernel<<<blocks_for(cells), THREADS, 0, stream>>>(",
     "  quota_caps_kernel<<<dim3((c_n + THREADS - 1) / THREADS, b_n), THREADS, 0, stream>>>("),
)
CAPS_DIVISION = ("      ratio = a / qr;\n      if (a % qr != 0 && a < 0) --ratio;  // floor, not truncation",
                 "      ratio = a ^ qr;")
CAPS_CUTS = {
    "stores only": (*CAPS_INDEX, CAPS_DIVISION,
                    ("    const long long a = cap[r];", "    const long long a = qr + r;")),
    "+ caps loads": (*CAPS_INDEX, CAPS_DIVISION),
    "+ divisions": CAPS_INDEX,
}
#: the first-slice K1's cuts, cumulative
MERGE_PROLOGUE = ("  const int b0 = row0 + blockIdx.y * ROWS;\n  const int b1 = min(b0 + ROWS, b_n);\n"
                  "  for (int b = b0; b < b1; ++b) {\n    if (table_form)",
                  "  if (b_n > 0) return;\n  const int b0 = row0 + blockIdx.y * ROWS;\n"
                  "  const int b1 = min(b0 + ROWS, b_n);\n"
                  "  for (int b = b0; b < b1; ++b) {\n    if (table_form)")
MERGE_NO_ROW_LOADS = (
    ("    int p = prof_idx[b];\n    if (p < 0) p += u_n;\n    p = p < 0 ? 0 : (p >= u_n ? u_n - 1 : p);\n"
     "    int32_t est = use_table",
     "    int p = (b & 7) < u_n ? (b & 7) : 0;\n    int32_t est = use_table"),
    ("    if (!summary) est = -1;                    // UnauthenticReplica\n"
     "    const int32_t reps = replicas[b];",
     "    if (!summary) est = -1;                    // UnauthenticReplica\n"
     "    const int32_t reps = b & 63;"),
    ("      int p = prof_inv[b];\n      if (p < 0) p += u_n;\n"
     "      p = p < 0 ? 0 : (p >= u_n ? u_n - 1 : p);\n      v = (int32_t)MAX_I32;",
     "      int p = (b & 7) < u_n ? (b & 7) : 0;\n      v = (int32_t)MAX_I32;"),
    ("    if (last) {  // once, after the last estimate\n      const int32_t reps = replicas[b];",
     "    if (last) {  // once, after the last estimate\n      const int32_t reps = b & 63;"),
)
MERGE_CUTS = {
    "prologue alone": (MERGE_PROLOGUE,),
    "+ row loop without its dependent loads": MERGE_NO_ROW_LOADS,
}
#: the Hopper forms' copies, each leaving one part out
CAPS_WITHOUT = {
    "alone: the fills": (  # every block fills, then returns
        ("  const bool fills_first = (blockIdx.x & 1) == 0;\n  if (fills_first) fills();\n",
         "  const bool fills_first = true;\n  fills();\n  if (b_n > 0) return;\n"),
    ),
    "alone: the prologue": (  # the fills and the prologue, then returns
        ("  unsigned long long x2[VEC][G];  // ONE: the segment's namespace's caps, staged",
         "  if (b_n > 0) {\n    if (!fills_first) fills();\n    return;\n  }\n"
         "  unsigned long long x2[VEC][G];"),
    ),
    "without the high products": (
        ("            const long long q = floor_staged(x[r].m, x[r].l, x2[j][r], sign_of(sg[j][r]));",
         "            const long long q = (long long)(x2[j][r] ^ (unsigned)sg[j][r] ^ x[r].m);"),
    ),
}
MERGE_WITHOUT = {
    "without the row loop (shared table)": (
        ("    __syncthreads();  // the row scalars\n    for (int i = grp; i < rows; i += rg) {",
         "    __syncthreads();  // the row scalars\n    if (a.b_n > 0) return;\n"
         "    for (int i = grp; i < rows; i += rg) {"),
    ),
}


def form(name: str, src: str) -> str:
    if name == "quota_caps":
        return "thread a cell" if "quota_caps_kernel<<<blocks_for(cells)" in src else "namespace runs"
    return "column a thread" if "run_grid(" in src else "row streaming"


def cuts_of(name: str, src: str) -> tuple[str, dict]:
    """("cumulative" | "without", cut -> edits) for the form of ``src``."""
    if form(name, src) in ("thread a cell", "column a thread"):
        return "cumulative", CAPS_CUTS if name == "quota_caps" else MERGE_CUTS
    return "without", CAPS_WITHOUT if name == "quota_caps" else MERGE_WITHOUT


def sources(dirs: list) -> dict:
    """(dir, kernel, variant) -> source text: the whole of each kernel, its
    cut copies, and K1's with its launch floor appended."""
    out = {}
    for d in dirs:
        for name in NAMES:
            src = kv.source(d, name)
            out[(d, name, "whole")] = src
            for var, text in kv.variants("k1_k13_variants", name, src, cuts_of(name, src)[1]).items():
                out[(d, name, var)] = text
            if name == "estimate_merge":
                out[(d, name, "floor")] = launch_floors.floor_source(name, form(name, src), src)
    return out


def caller(lib, entry: str, t: dict):
    """A function that runs one launch of ``lib``'s ``entry`` on the tensors
    ``t`` (allocating the outputs as the wrapper does) and returns them."""
    import torch
    from karmada_tpu_torch import native

    lib_name, fname = ENTRY[entry]
    dev = next(v for v in t.values() if isinstance(v, torch.Tensor)).device
    run = kv.entry(lib, fname, native.SIGNATURES[lib_name][fname], dev)
    if entry == "quota_cluster_caps":
        n, c, r = t["caps"].shape
        b = t["ns_rows"].shape[0]

        def call():
            out = torch.empty((b, c), dtype=torch.int32, device=dev)
            run(t["caps"], n, c, r, t["ns_rows"], t["requests"], b, out)
            return out
        return call
    if entry == "estimate_merge":
        c, r = t["available_cap"].shape
        u, b = t["profiles"].shape[0], t["prof_idx"].shape[0]

        def call():
            out = torch.empty((b, c), dtype=torch.int32, device=dev)
            run(t["available_cap"], c, r, t["profiles"], u, t["prof_idx"], t["has_summary"],
                t["replicas"], b, out)
            return out
        return call
    if entry == "profile_table":
        c, r = t["available_cap"].shape
        u = t["profiles"].shape[0]

        def call():
            out = torch.empty((u, c), dtype=torch.int32, device=dev)
            run(t["available_cap"], c, r, t["profiles"], u, t["has_summary"], out)
            return out
        return call
    u, c = t["table"].shape
    b = t["prof_inv"].shape[0]
    extras = t["extras"]
    ptrs = (ctypes.c_void_p * max(len(extras), 1))(*(x.data_ptr() for x in extras))
    groups = -(-len(extras) // 4)  # scratch as the first-slice form needs it (groups of 4)

    def call():
        out = torch.empty((b, c), dtype=torch.int32, device=dev)
        scratch = torch.empty_like(out) if groups > 1 else None
        run(t["table"], u, c, t["prof_inv"], ptrs, len(extras), t["replicas"], b,
            scratch.data_ptr() if scratch is not None else None, out)
        return out
    return call


def plain(entry: str, t: dict):
    from karmada_tpu_torch import ops

    if entry == "quota_cluster_caps":
        return lambda: ops.cluster_caps_ref(t["caps"], t["ns_rows"], t["requests"])
    if entry == "estimate_merge":
        return lambda: ops.estimate_merge_ref(t["available_cap"], t["profiles"], t["prof_idx"],
                                              t["has_summary"], t["replicas"])
    if entry == "profile_table":
        return lambda: ops.profile_table_ref(t["available_cap"], t["profiles"], t["has_summary"])
    return lambda: ops.estimate_merge_table_ref(t["table"], t["prof_inv"], tuple(t["extras"]),
                                                t["replicas"])


def bound(entry: str, t: dict, want) -> tuple[float, str]:
    """The bound of ``entry`` on ``t`` as ``chip_smoke`` counts it: each
    input read once and the output written once over HBM rate, against the
    plain definition's operations over the integer peak; the larger."""
    import torch

    tensors = [v for v in t.values() if isinstance(v, torch.Tensor)]
    tensors += list(t.get("extras", ()))
    nbytes = cs._nbytes(*tensors, want)
    cells = want.numel()
    if entry == "quota_cluster_caps":
        ops = cells * t["requests"].shape[1] * 3
    elif entry == "estimate_merge_table":
        ops = cells * (2 * (len(t["extras"]) + 1) + 3)
    elif entry == "profile_table":
        ops = cells * t["profiles"].shape[1] * 2
    else:
        u, r = t["profiles"].shape
        ops = u * t["available_cap"].shape[0] * r + cells * cs.OPS_PER_ELEM["estimate_merge"]
    return cs._bound(nbytes, ops)


def seeded(rng, device) -> list:
    """(entry, label, tensors) on the seeded shapes of PERF.md section 6."""
    import torch

    out = [("quota_cluster_caps", "caps_batch 4096 x 5000, N = 8, R = 4",
            cs.to_device(cs.caps_batch(rng), device)),
           ("estimate_merge", "estimate_batch 4096 x 5000, U = 9",
            cs.to_device(cs.estimate_batch(rng, 4096, 5000), device))]
    a = cs.estimate_batch(rng, 1, 5000, u=8)
    out.append(("profile_table", "8 x 5000", cs.to_device(
        {k: a[k] for k in ("available_cap", "profiles", "has_summary")}, device)))
    # the merge form as check_merge_table draws it
    hi = 2**31 - 1
    b, c, u = 4096, 5000, 9
    table = rng.integers(-1, 400, (u, c)).astype(np.int32)
    table[rng.random((u, c)) < 0.05] = hi
    base = cs.to_device({"table": table, "prof_inv": rng.integers(0, u, b).astype(np.int32),
                         "replicas": np.where(rng.random(b) < 0.1, 0,
                                              rng.integers(1, 100, b)).astype(np.int32)}, device)
    for e_n in (0, 1, 2, 5, 9):
        extras = []
        for _ in range(e_n):
            e = rng.integers(-1, 300, (b, c)).astype(np.int32)
            e[rng.random((b, c)) < 0.05] = hi
            extras.append(torch.from_numpy(e).to(device))
        out.append(("estimate_merge_table", f"4096 x 5000, E = {e_n}", dict(base, extras=extras)))
    # drawn last, so that the shapes above keep their draws
    out.append(("quota_cluster_caps", "caps_batch 4096 x 5000, N = 8, R = 17",
                cs.to_device(cs.caps_batch(rng, r=17), device)))
    return out


def caught(device, engine, problems, names: tuple) -> dict:
    """The inputs of each kernel entry point in ``names`` at its first launch
    while ``engine`` schedules ``problems`` (cloned; extras as a list)."""
    from karmada_tpu_torch.scheduler import core

    keys = {"quota_cluster_caps": ("caps", "ns_rows", "requests"),
            "estimate_merge": ("available_cap", "profiles", "prof_idx", "has_summary", "replicas"),
            "profile_table": ("available_cap", "profiles", "has_summary"),
            "estimate_merge_table": ("table", "prof_inv", "extras", "replicas")}
    got, saved = {}, {}
    for name in names:
        fn = getattr(core, name)
        saved[name] = fn

        def spy(*args, _name=name, _fn=fn):
            if _name not in got:
                got[_name] = {k: ([x.clone() for x in v] if isinstance(v, tuple) else v.clone())
                              for k, v in zip(keys[_name], args)}
            return _fn(*args)
        setattr(core, name, spy)
    try:
        engine.schedule(problems)
        cs.sync(device)
    finally:
        for name, fn in saved.items():
            setattr(core, name, fn)
    missing = [n for n in names if n not in got]
    if missing:
        raise SystemExit(f"k1_k13_variants: the path never launched {missing}")
    return got


def path_inputs(device) -> list:
    """(entry, label, tensors) on the paths' own first chunks."""
    import karmada_tpu_torch as pkg
    from karmada_tpu_torch.scheduler import TensorScheduler
    from karmada_tpu_torch.scheduler.quota import build_quota_snapshot

    out = []
    chunk = 4096
    snap, problems = cs.build_workload(pkg, 5)
    engine = TensorScheduler(snap, chunk_size=chunk, device=device)
    engine.fleet_threshold = chunk + 1
    got = caught(device, engine, problems[:chunk], ("estimate_merge",))
    out.append(("estimate_merge", "config 5 general chunk 0", got["estimate_merge"]))
    del engine
    snap, problems = cs.build_workload(pkg, 5, models=True)
    engine = TensorScheduler(snap, chunk_size=chunk, device=device)
    engine.fleet_threshold = chunk + 1
    got = caught(device, engine, problems[:chunk], ("estimate_merge_table",))
    out.append(("estimate_merge_table", "models general chunk 0, E = 0",
                got["estimate_merge_table"]))
    del engine
    snap, problems = cs.quota_workload(pkg)
    limits = {ns: dict(cs.GENEROUS) for ns in cs.QUOTA_NAMESPACES}
    engine = TensorScheduler(snap, chunk_size=chunk, device=device)
    engine.fleet_threshold = chunk + 1
    engine.set_quota(build_quota_snapshot(cs.quota_frqs(pkg, snap, limits), snap, 1))
    got = caught(device, engine, problems[:chunk], ("quota_cluster_caps", "estimate_merge_table"))
    out.append(("quota_cluster_caps", "quota general chunk 0", got["quota_cluster_caps"]))
    out.append(("estimate_merge_table", "quota general chunk 0, E = 1",
                got["estimate_merge_table"]))
    del engine
    snap, problems = cs.ranked_workload(pkg)
    limits = {ns: dict(cs.GENEROUS) for ns in cs.RANKED_NAMESPACES}
    engine = TensorScheduler(snap, chunk_size=chunk, device=device)
    engine.set_quota(build_quota_snapshot(cs.quota_frqs(pkg, snap, limits,
                                                        caps=cs.ranked_caps(snap)), snap, 1))
    got = caught(device, engine, problems[:chunk], ("quota_cluster_caps", "estimate_merge_table"))
    out.append(("quota_cluster_caps", "ranked chunk 0", got["quota_cluster_caps"]))
    out.append(("estimate_merge_table", "ranked chunk 0, E = 1", got["estimate_merge_table"]))
    for entry, label, t in out:
        if entry == "quota_cluster_caps":
            capped = int((t["ns_rows"] >= 0).sum().item())
            print(f"# {label}: {t['ns_rows'].shape[0]} rows, {capped} capped, caps "
                  f"{tuple(t['caps'].shape)}, {int((t['caps'] < 2**62).sum().item())} cells "
                  f"below UNLIMITED", flush=True)
    return out


def split(libs, d: str, lib_name: str, entry: str, label: str, t: dict, whole_call,
          form_name: str, card: str) -> dict:
    """The phase split of ``d``'s form of ``entry`` on ``t``: each cut copy
    timed beside the whole (medians of 3)."""
    kind, cuts = cuts_of(lib_name, kv.source(d, lib_name))
    cut_ms = {cut: statistics.median(cs.cuda_ms(caller(libs[(d, lib_name, cut)], entry, t))
                                     for _ in range(3)) for cut in cuts}
    whole = statistics.median(cs.cuda_ms(whole_call) for _ in range(3))
    if kind == "cumulative":
        cut_ms["whole"] = whole
        prev, phases = 0.0, {}
        for cut, ms in cut_ms.items():
            phases[cut] = ms - prev
            prev = ms
    else:  # "alone: ..." copies are the part's own time
        phases = {cut.replace("without ", ""): ms if cut.startswith("alone: ") else whole - ms
                  for cut, ms in cut_ms.items()}
        cut_ms["whole"] = whole
    print(f"# {entry} {label}: {form_name} form's phases ("
          + ("cut differences" if kind == "cumulative" else "whole minus a copy without each")
          + "; the alone copies their own time): "
          + ", ".join(f"{c} {v:.4f} ms" for c, v in phases.items())
          + f" (whole {whole:.4f}; {d}); card {card}", flush=True)
    return {"entry": entry, "shape": label, "dir": d, "cut_ms": cut_ms, "phases": phases}


def yardsticks(device, card: str) -> dict:
    """torch's own ``fill_`` of a 4096 x 5000 int32 tensor and ``copy_``
    into it: what a write stream and a read-write stream take at the size of
    K13's and K1's outputs (yardsticks, not versions of either kernel)."""
    import torch

    out = torch.empty((4096, 5000), dtype=torch.int32, device=device)
    src = torch.ones_like(out)
    ms = {"fill_": cs.cuda_ms(lambda: out.fill_(7)), "copy_": cs.cuda_ms(lambda: out.copy_(src))}
    print(f"# torch yardsticks at 4096 x 5000 int32 (82 MB): fill_ {ms['fill_']:.4f} ms, "
          f"copy_ {ms['copy_']:.4f} ms; card {card}", flush=True)
    return ms


def main(argv: list) -> int:
    import torch

    setup = kv.start(argv, "k1_k13_variants")
    if setup is None:
        return 1
    device, card, named, dirs = setup
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build("k1_k13_variants", sources(dirs), tmp, ptxas=True)
        forms = {d: {n: form(n, kv.source(d, n)) for n in NAMES} for d in dirs}
        shapes = seeded(np.random.default_rng(cs.SEED), device) + path_inputs(device)
        results = {"card": card, "dirs": named, "times": [], "splits": [], "floors": []}
        for entry, label, t in shapes:
            lib_name = ENTRY[entry][0]
            want = plain(entry, t)()
            calls = {d: caller(libs[(d, lib_name, "whole")], entry, t) for d in dirs}
            row = kv.time_row(entry, label, calls, want, named,
                              {d: forms[d][lib_name] for d in dirs}, card)
            row["bound_ms"], row["bound_by"] = bound(entry, t, want)
            print(f"# {entry} {label}: bound {row['bound_ms']:.6f} ms by {row['bound_by']}",
                  flush=True)
            results["times"].append(row)
            cut_here = label.startswith(("estimate_batch", "quota general chunk 0"))
            cut_here = cut_here or label.endswith("R = 4")
            cut_here = cut_here or (entry == "estimate_merge_table" and label.endswith("E = 1")
                                    and label.startswith("4096"))
            for d in dirs:
                if d in row["held"] and cut_here:
                    results["splits"].append(split(libs, d, lib_name, entry, label, t,
                                                   row["held"][d], forms[d][lib_name], card))
                if entry == "profile_table" and d in row["held"]:
                    u, c = t["profiles"].shape[0], t["available_cap"].shape[0]
                    r = t["profiles"].shape[1]
                    run = kv.entry(libs[(d, lib_name, "floor")], "launch_floor_launch",
                                   launch_floors.FLOOR_SIGNATURE, device)
                    fl = cs.cuda_ms(lambda: run(u, c, r))
                    ms = cs.cuda_ms(row["held"][d])
                    print(f"# launch floor at K1's table-form {label} grid ({forms[d][lib_name]} "
                          f"form): {fl:.4f} ms; the table form {ms:.4f} ms, {ms / fl:.2f}x the "
                          f"floor ({d}); card {card}", flush=True)
                    results["floors"].append({"shape": label, "dir": d, "floor_ms": fl,
                                              "ms": ms})
            row.pop("held")
            del t, want, calls
            torch.cuda.empty_cache()
    results["yardsticks"] = yardsticks(device, card)
    kv.write(results, "k1_k13_variants")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
