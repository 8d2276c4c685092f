#!/usr/bin/env python3
"""Time build variants and truncated copies of K2 (``divide_replicas``) on
one NVIDIA GPU, beside the built kernel's phase split; with ``--fleet``,
truncated copies of K3 (``fleet_masks``, both forms), K4 (``fleet_diff``),
K16 (``entry_diff``) and K5's two wires (``fleet_wire``) instead.

    python3 k2_variants.py [E/THREADS/MIN_BLOCKS/CUT,...]
    python3 k2_variants.py --fleet [CSRC_DIR ...]

Each variant is a copy of ``karmada_tpu_torch/csrc/divide_replicas.cu``
compiled on its own (``nvcc``, as the port builds it) with E elements a
thread, at most THREADS threads a block, ``__launch_bounds__(THREADS,
MIN_BLOCKS)`` on the main kernel, and CUT:
  0  the whole kernel (held to ``divide_replicas_ref``, exact);
  1  returns after pass 1 (the loads and the cohort sums);
  2  returns after pass 3 (also the Aggregated cut and the floors);
  3  skips pass 4 (everything but the bonus selection).
A truncated copy writes nothing past its cut, so it is timed, not checked;
the differences between cuts are what each pass adds to a launch. Prints
each variant's registers and spills, and its ms per launch (CUDA events,
``chip_smoke.cuda_ms``) on the K2 batches of ``chip_smoke.py``: seeded
4096 x 5000, 4096 x 10,000, 1024 x 16,385, 256 x 40,000 and 512 x 1000,
and chunk 0 of the config-5 fleet table; then the built kernel's phase
split (``chip_smoke.k2_phase_split``) on the first and the last. Imports
nothing of JAX.

``--fleet`` compiles, for each kernel source directory named (default: the
port's own ``csrc``; another checkout's, such as a parent commit's, can be
named beside it), a whole copy and the cuts of ``FLEET_CUTS`` of
``fleet_masks.cu`` (K3: cut before and after the previous-site pass),
``fleet_diff.cu`` (K4: its entry rows cut to their loads, with no
compaction) and ``entry_diff.cu`` (K16: cut before its compaction, the
loads, n_placed, has_cand, the diff and the outputs kept). A source that
defines ``FLEET_CUT`` is cut with ``-DFLEET_CUT=1`` / ``2``; an older one
by the text replacements of ``FLEET_TEXT_CUTS``. Each copy is timed (CUDA
events behind a device spin, ``chip_smoke.cuda_ms``), not checked; the
whole copies are also held to the plain versions. K3 runs on chunk 0 of
the config-5 fleet table (masks form, 4096 x 5000) and on every row of it
(bits form, 102,400 x 5000). K4 phase A is timed with d_slots 64 and 0 (no
delta compaction) on chunk 0 of a steady pass (the resident already holds
the chunk's result) and of a churn pass (the first drifted snapshot of
``chip_smoke.drift_snapshots``, against the cold pass's resident, restored
before each launch outside the timed events). K4's entry rows run on the
churn pass's changed rows (phase A over every chunk against a clone of
the cold resident; padded with -1 rows to max(2048, pow2), k_out from the
replicas, as the table fetches them). K16 runs on chunk 0 of the same
churn on a config-5 table at a dense budget of 0 (the entry-resident
route), all-rows form, against the resident widened to k_res = k_out + 8
(``chip_smoke.legacy_inputs``). K5's two wires (``fleet_wire.cu``) run on
four inputs: the phase-A outputs of a steady config-5 pass (after three
steady passes, at the caps the table then holds) and of the churn pass
(at the same caps), both through ``fleet_wire``; the churn pass's phase-B
entries (K4's entry rows over its changed rows, k_out 128: 65,536 x 128
words, 21-bit) and the entry-resident churn pass's own entries (K16 over
every chunk: 102,400 x k_res words, k_res 128 on config 5, 21-bit, e_cap
the safe bound), both through ``entry_wire``. A source with the three-kernel compaction (the
older form) is cut after its memsets (1), its count kernels (2), its
scans (3) and its write kernels (4), the serialiser dropped from every
cut, so the differences are each stage's time; the single-pass source
is cut with ``-DFLEET_CUT=1`` (loads, ranking and look-back, no write).
The entry-resident wire is also timed as ``fleet_solve`` ends: the
parent's wire and the concatenation that put the metas in, against the
single-pass wire writing them in place.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "karmada_tpu_torch", "csrc", "divide_replicas.cu")
#: where each cut returns: (text of the source, what replaces it)
CUTS = {
    1: ("  const long long assigned = s[0];",
        "  if (threadIdx.x == 0) a.unsched[b] = (uint8_t)(s[0] & 1);\n  return;\n"
        "  const long long assigned = s[0];"),
    2: ("  mark(2);\n\n  // --- 4.",
        "  if (threadIdx.x == 0) a.unsched[b] = (uint8_t)(f5[0] & 1);\n  return;\n"
        "  mark(2);\n\n  // --- 4."),
    3: ("  if (need_bonus) {\n    auto is_cand", "  if (false) {\n    auto is_cand"),
}
DEFAULT = "12/1024/1/0,12/1024/1/1,12/1024/1/2,12/1024/1/3,8/1024/1/0,16/512/1/0"


def variant_source(src: str, e: int, threads: int, min_blocks: int, cut: int) -> str:
    for old, new in (
        ("constexpr int E = 12;", f"constexpr int E = {e};"),
        ("constexpr int MAX_THREADS = 1024;", f"constexpr int MAX_THREADS = {threads};"),
        ("__launch_bounds__(MAX_THREADS)", f"__launch_bounds__(MAX_THREADS, {min_blocks})"),
    ) + ((CUTS[cut],) if cut else ()):
        if old not in src:
            raise SystemExit(f"k2_variants: the source no longer holds {old!r}")
        src = src.replace(old, new, 1)
    return src


#: the copies ``--fleet`` builds of each source, by cut (0: whole); K5's
#: by the form of its source (``wire_form``)
FLEET_CUTS = {"fleet_masks": (0, 1, 2), "fleet_diff": (0, 1), "entry_diff": (0, 1),
              "fleet_wire": (0, 1, 2, 3, 4)}
WIRE_CUTS = {"three-pass": (0, 1, 2, 3, 4), "single-pass": (0, 1)}
FLEET_CUT_NAMES = {
    "fleet_masks": {0: "whole", 1: "cut before prev", 2: "cut after prev"},
    "fleet_diff": {0: "whole", 1: "entry rows: loads only"},
    "entry_diff": {0: "whole", 1: "cut before compaction"},
    "fleet_wire": {0: "whole", 1: "cut 1", 2: "cut 2", 3: "cut 3", 4: "cut 4"},
}
#: the three-kernel form's K5 entry points (scratch of block counts)
THREE_PASS_SIGNATURES = {"fleet_wire_launch": "ppppp" "iiii" "ppppp" "i",
                         "entry_wire_launch": "pqiiipppi"}


def wire_form(src: str) -> str:
    """``three-pass`` for K5 sources with a count, a scan and a write
    kernel per compaction and a serialiser; ``single-pass`` otherwise."""
    return "three-pass" if "count_kernel" in src else "single-pass"
#: cuts of kernel sources that predate ``FLEET_CUT``: source -> cut ->
#: ((text, replacement), ...). K3 cut 1 returns before the previous-site
#: pass (row loads, the pairs in shared memory, the row scalars); cut 2
#: runs that pass and stores ``prev`` (masks) or its positive bits (bits)
#: and returns. K4 cut 1 reads each tile of an entry row into a running
#: hash (written only on an impossible value) in place of the block scan.
#: K16 cut 1 drops the per-tile ``__syncthreads_count`` and block scan.
FLEET_TEXT_CUTS = {
    "fleet_masks": {
        1: (("  const size_t o = (size_t)j * c_n + c;\n  int32_t pv;",
             "  return;\n  const size_t o = (size_t)j * c_n + c;\n  int32_t pv;"),
            ("  int32_t pv;\n  const bool f = c < c_n && cell(",
             "  if (c >= 0) return;\n  int32_t pv;\n  const bool f = c < c_n && cell(")),
        2: (("  const size_t o = (size_t)j * c_n + c;\n  int32_t pv;",
             "  const size_t o = (size_t)j * c_n + c;\n  {\n    uint32_t p2 = 0;\n"
             "    for (int k = 0; k < k_prev; ++k)\n"
             "      if (s_site[k] == c) p2 += (uint32_t)s_cnt[k];\n"
             "    prev[o] = (int32_t)p2;\n    return;\n  }\n  int32_t pv;"),
            ("  int32_t pv;\n  const bool f = c < c_n && cell(",
             "  uint32_t p2 = 0;\n  for (int k = 0; k < k_prev; ++k)\n"
             "    if (s_site[k] == c) p2 += (uint32_t)s_cnt[k];\n"
             "  const bool f2 = c < c_n && (int32_t)p2 > 0;\n"
             "  const unsigned word2 = __ballot_sync(0xffffffffu, f2);\n"
             "  if ((threadIdx.x & 31) == 0 && (c >> 5) < ((c_n + 31) >> 5))\n"
             "    words[(size_t)j * ((c_n + 31) >> 5) + (c >> 5)] = (int32_t)word2;\n"
             "  return;\n  int32_t pv;\n  const bool f = c < c_n && cell(")),
    },
    "fleet_diff": {
        1: (("  int seen = 0;\n  if (row >= 0) {",
             "  int seen = 0, acc = 0;\n  if (row >= 0) {"),
            ("      int tile;\n"
             "      const int pos = seen + block_scan(d > 0 ? 1 : 0, s_warp, &tile);\n"
             "      if (d > 0 && pos < k_out) o[pos] = (c << 8) | d;\n"
             "      seen += tile;\n",
             "      acc = acc * 31 + d;\n"),
            ("  const int filled = seen < k_out ? seen : k_out;",
             "  if (acc == 0x5bd1e995) o[0] = acc;\n"
             "  const int filled = seen < k_out ? seen : k_out;")),
    },
    # K5 (three-pass form): each cut skips the serialisers, and returns
    # from every compaction before its count (1), scan (2) or write (3)
    # kernel, or runs it whole (4)
    "fleet_wire": {
        cut: tuple(
            ((f"  {k}<<<", f"  if ({cut} == {i}) return cudaSuccess;\n  {k}<<<")
             for i, k in ((1, "count_kernel<S>"), (2, "scan_kernel"), (3, "write_kernel<S>"))
             if i == cut)
        ) + (("  const long long len = 4 + n / 8",
              "  return 0;\n  const long long len = 4 + n / 8"),
             ("  if (!byte_wire)\n    return (int)cudaMemcpyAsync",
              "  return 0;\n  if (!byte_wire)\n    return (int)cudaMemcpyAsync"))
        for cut in (1, 2, 3, 4)
    },
    "entry_diff": {
        1: (("    if (seen < k_out && __syncthreads_count(sel) > 0) {  // block-uniform\n"
             "      int tile;\n"
             "      const int pos = seen + block_scan(sel ? 1 : 0, s_warp, &tile);\n"
             "      if (sel && pos < k_out) words[pos] = (c << 8) | av;\n"
             "      seen += tile;\n"
             "    }\n", ""),),
    },
}


def _fleet_builds(csrc: str, tmp: str, tag: str) -> dict:
    """Start nvcc on the copies ``FLEET_CUTS`` names of ``csrc``'s sources;
    (kernel, cut) -> (process, library path)."""
    from karmada_tpu_torch import native

    procs = {}
    for name, cuts in FLEET_CUTS.items():
        src = open(os.path.join(csrc, f"{name}.cu")).read()
        if name == "fleet_wire":
            cuts = WIRE_CUTS[wire_form(src)]
        for cut in cuts:
            flags = []
            if cut and "FLEET_CUT" in src:
                flags = [f"-DFLEET_CUT={cut}"]
                text = src
            else:
                text = src
                for old, new in FLEET_TEXT_CUTS[name].get(cut, ()):
                    if old not in text:
                        raise SystemExit(f"k2_variants: {csrc}/{name}.cu holds neither "
                                         f"FLEET_CUT nor {old!r}")
                    text = text.replace(old, new, 1)
            path = os.path.join(tmp, f"{tag}_{name}_{cut}")
            with open(path + ".cu", "w") as f:
                f.write(text)
            procs[(name, cut)] = (subprocess.Popen(
                [native.nvcc(), *native.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o",
                 path + ".so", path + ".cu"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), path + ".so",
                wire_form(src) if name == "fleet_wire" else None)
    return procs


def _fleet_lib(proc, so: str, label: str, form=None):
    from karmada_tpu_torch import native

    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"k2_variants: {label} does not build:\n{log}")
    usage = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"# {label}: " + "; ".join(usage), flush=True)
    lib = ctypes.CDLL(so)
    for lib_name in FLEET_CUTS:
        sigs = native.SIGNATURES[lib_name]
        if lib_name == "fleet_wire" and form == "three-pass":
            sigs = THREE_PASS_SIGNATURES
        for fn_name, sig in sigs.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes = [native._CTYPES[k] for k in sig] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
    lib.wire_form = form
    return lib


def fleet_main(dirs: list) -> int:
    import torch
    import karmada_tpu_torch
    from karmada_tpu_torch import native
    from karmada_tpu_torch.ops import divide_replicas
    from karmada_tpu_torch.scheduler import TensorScheduler
    from karmada_tpu_torch.scheduler import fleet_kernels as fk
    from karmada_tpu_torch.scheduler.fleet import _cap_round, _pow2

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"# card: {card}", flush=True)
    dirs = dirs or [native.CSRC]
    tmp = tempfile.mkdtemp(prefix="fleet_variants_")
    uniq = list(dict.fromkeys(dirs))  # a directory named twice is built once
    procs = {}
    for u, d in enumerate(uniq):
        procs.update({(u, *k): v for k, v in _fleet_builds(d, tmp, f"d{u}").items()})
    native.build()
    t0 = time.perf_counter()
    snap, problems = cs.build_workload(karmada_tpu_torch, 5)
    drift = cs.drift_snapshots(karmada_tpu_torch, snap, 1)
    dev = torch.device("cuda", 0)
    engine = TensorScheduler(snap, chunk_size=4096, device=dev)
    for _ in range(4):  # cold, then steady passes: the caps settle as the smoke's
        engine.schedule(problems)
    engine_l = TensorScheduler(snap, chunk_size=4096, device=dev)
    with cs.dense_budget(0):  # the entry-resident route
        engine_l.schedule(problems)
    torch.cuda.synchronize()
    table = engine._fleet
    if engine_l._fleet._resident_entries is None:
        raise SystemExit("k2_variants: the budget-0 table is not entry-resident")
    print(f"# config-5 tables (dense and entry-resident) built and scheduled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    built = {k: _fleet_lib(p, so, f"{uniq[k[0]]} {k[1]} {FLEET_CUT_NAMES[k[1]][k[2]]}", form)
             for k, (p, so, form) in procs.items()}
    libs = {(i, *k[1:]): lib for i, d in enumerate(dirs) for k, lib in built.items()
            if k[0] == uniq.index(d)}
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    chunk = table.chunk
    rows_all = table._all_rows_dev

    def masks_run(lib, tables, state, rows):
        b, c = rows.shape[0], tables[1].shape[1]
        out = fk.ChunkMasks(*(torch.empty((b, c), dtype=d, device=dev)
                              for d in (torch.bool, torch.int32, torch.int32, torch.int32)),
                            *(torch.empty((b,), dtype=d, device=dev)
                              for d in (torch.int32, torch.int32, torch.bool)))
        err = lib.fleet_masks_launch(*[t.data_ptr() for t in tables], c,
                                     tables[2].shape[1], rows.data_ptr(), b,
                                     *[t.data_ptr() for t in state], state[6].shape[1],
                                     *[t.data_ptr() for t in out], stream())
        native.check_launch("fleet_masks_launch", err)
        return out

    def bits_run(lib, tables, state, rows):
        b, c = rows.shape[0], tables[1].shape[1]
        out = torch.empty((b, (c + 31) // 32), dtype=torch.int32, device=dev)
        err = lib.fleet_bits_launch(*[t.data_ptr() for t in tables], c,
                                    tables[2].shape[1], rows.data_ptr(), b,
                                    *[t.data_ptr() for t in state], state[6].shape[1],
                                    out.data_ptr(), stream())
        native.check_launch("fleet_bits_launch", err)
        return out

    def diff_run(lib, args, res, d_slots):
        a, u, f, st, rows = args
        b, c = a.shape
        outs = (torch.empty((b,), dtype=torch.bool, device=dev),
                torch.empty((b,), dtype=torch.int32, device=dev),
                torch.empty((b,), dtype=torch.int32, device=dev),
                torch.empty((b, d_slots), dtype=torch.int32, device=dev))
        err = lib.fleet_diff_launch(*[t.data_ptr() for t in args], b, c,
                                    res[0].data_ptr(), res[1].data_ptr(), res[0].shape[0],
                                    1, 0, d_slots, *[t.data_ptr() for t in outs], stream())
        native.check_launch("fleet_diff_launch", err)
        return outs

    def event_ms(fn, restore, reps=20):
        """Median device ms of ``fn`` alone, ``restore()`` run before each
        launch outside the events, which are queued behind a device spin
        (the host's launch work is hidden)."""
        fn()
        per = []
        for _ in range(reps):
            restore()
            torch.cuda._sleep(cs.SPIN_CYCLES // 10)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            per.append(e0.elapsed_time(e1))
        return statistics.median(per)

    tables, state = table._dev_tables, table._dev_state
    rows0 = rows_all[:chunk]
    cold_res = (table._res_dense[:chunk].clone(), table._res_meta[:chunk].clone())
    for i, d in enumerate(dirs):
        line = []
        for cut in (0, 1, 2):
            lib = libs[(i, "fleet_masks", cut)]
            if cut == 0:
                cs.compare("K3 masks", tuple(masks_run(lib, tables, state, rows0)),
                           tuple(fk.fleet_masks_ref(*tables, rows0, *state)))
                cs.compare("K3 bits", bits_run(lib, tables, state, rows_all),
                           fk.fleet_bits_ref(*tables, rows_all, *state))
            ms_m = cs.cuda_ms(lambda: masks_run(lib, tables, state, rows0))
            ms_b = cs.cuda_ms(lambda: bits_run(lib, tables, state, rows_all), reps=5)
            line.append(f"{FLEET_CUT_NAMES['fleet_masks'][cut]} masks {ms_m:.4f} "
                        f"bits {ms_b:.4f}")
        print(f"# K3 split {d} (config-5 chunk 0 {chunk}x{tables[1].shape[1]}; bits "
              f"{rows_all.shape[0]} rows; ms): " + "; ".join(line) + f"; card {card}",
              flush=True)
    # K5's phase-A inputs of a steady pass (phase A over every chunk
    # against a clone of the settled resident: no row changes)
    m_cap, d_cap = table._m_cap_cur, table._d_cap_cur or 0
    wires = {"steady": phase_a_outputs(table, tables, state, rows_all, chunk)}
    # K4 phase A on chunk 0: steady (the cold tables) and churn (drifted)
    k4 = {}
    for kind in ("steady", "churn"):
        if kind == "churn":
            if not engine.update_snapshot(drift[0]):
                raise SystemExit("k2_variants: drifted snapshot refused")
            table._sync_device()
            tables, state = table._dev_tables, table._dev_state
        m = fk.fleet_masks(*tables, rows0, *state)
        has_agg = bool((table._st["strategy"][: table.n_rows] == 3).any())
        a, u = divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w, m.avail,
                               m.prev, m.fresh, has_agg)
        args = (a, u, m.feasible, m.strategy, rows0)
        for i, d in enumerate(dirs):
            lib = libs[(i, "fleet_diff", 0)]
            res = (cold_res[0].clone(), cold_res[1].clone())
            want_res = (cold_res[0].clone(), cold_res[1].clone())
            got = diff_run(lib, args, res, 64)
            want = fk.fleet_diff_ref(*args, *want_res, all_rows=True, offset=0, d_slots=64)
            cs.compare(f"K4 {kind}", tuple(got) + res, tuple(want) + want_res)

            def restore():
                res[0].copy_(cold_res[0])
                res[1].copy_(cold_res[1])

            k4[(kind, i)] = (int(got[0].sum().item()), int(got[2].sum().item()), [
                event_ms(lambda: diff_run(lib, args, res, ds), restore) for ds in (64, 0)])
    for i, d in enumerate(dirs):
        print(f"# K4 split {d} (config-5 chunk 0, ms a launch, d_slots 64 / 0): "
              + "; ".join(f"{kind} ({k4[(kind, i)][0]} changed rows, {k4[(kind, i)][1]} "
                          f"changed cells) {k4[(kind, i)][2][0]:.4f} / {k4[(kind, i)][2][1]:.4f}"
                          for kind in ("steady", "churn")) + f"; card {card}", flush=True)

    # K4's entry rows on the churn pass's changed rows: phase A over every
    # chunk against a clone of the cold resident, as chip_smoke's check
    wires["churn"] = phase_a_outputs(table, tables, state, rows_all, chunk)
    res_d = wires["churn"][-1]
    ch_rows = torch.nonzero(wires["churn"][0]).flatten().to(torch.int32)
    rows_b = torch.full((max(2048, _pow2(max(ch_rows.numel(), 1))),), -1,
                        dtype=torch.int32, device=dev)
    rows_b[: ch_rows.numel()] = ch_rows
    c = res_d.shape[1]
    k_out = min(c, _pow2(int(table._st["replicas"][: table.n_rows].max())))

    def rows_run(lib):
        out = torch.empty((rows_b.shape[0], k_out), dtype=torch.int32, device=dev)
        err = lib.fleet_entry_rows_launch(res_d.data_ptr(), res_d.shape[0], c,
                                          rows_b.data_ptr(), rows_b.shape[0], k_out,
                                          out.data_ptr(), stream())
        native.check_launch("fleet_entry_rows_launch", err)
        return out

    want = fk.fleet_entry_rows_ref(res_d, rows_b, k_out)
    phase_b = want
    for i, d in enumerate(dirs):
        cs.compare("K4 entry rows", rows_run(libs[(i, "fleet_diff", 0)]), want)
        line = [f"{FLEET_CUT_NAMES['fleet_diff'][cut]} "
                f"{cs.cuda_ms(lambda: rows_run(libs[(i, 'fleet_diff', cut)]), reps=5):.4f}"
                for cut in FLEET_CUTS["fleet_diff"]]
        print(f"# K4 entry rows split {d} (config-5 churn: {ch_rows.numel()} changed rows "
              f"padded to {rows_b.shape[0]}, k_out {k_out}; ms a launch): "
              + "; ".join(line) + f"; card {card}", flush=True)
    del res_d

    # K16 on chunk 0 of the same churn on the entry-resident table
    if not engine_l.update_snapshot(drift[0]):
        raise SystemExit("k2_variants: drifted snapshot refused")
    engine_l._fleet._sync_device()
    li = cs.legacy_inputs(engine_l._fleet)
    args, _ = cs.entry_diff_args(li, li["rows_all"][: li["chunk"]])
    k_out = li["k_out"]

    def diff16_run(lib):
        a, res = args[0], args[5]
        b, c = a.shape
        outs = (torch.empty((b,), dtype=torch.int32, device=dev),
                torch.empty((b, res.shape[1]), dtype=torch.int32, device=dev),
                torch.empty((b,), dtype=torch.int64, device=dev))
        err = lib.entry_diff_launch(*[t.data_ptr() for t in args[:5]], b, c,
                                    res.data_ptr(), res.shape[0], res.shape[1], k_out, 1, 0,
                                    *[t.data_ptr() for t in outs], stream())
        native.check_launch("entry_diff_launch", err)
        return outs

    want = fk.entry_diff_ref(*args, k_out=k_out, all_rows=True, offset=0)
    n_changed = int(((want.meta >> 10) & 1).sum().item())
    for i, d in enumerate(dirs):
        cs.compare("K16", diff16_run(libs[(i, "entry_diff", 0)]), tuple(want))
        line = [f"{FLEET_CUT_NAMES['entry_diff'][cut]} "
                f"{cs.cuda_ms(lambda: diff16_run(libs[(i, 'entry_diff', cut)])):.4f}"
                for cut in FLEET_CUTS["entry_diff"]]
        print(f"# K16 split {d} (config-5 legacy churn chunk 0: {args[0].shape[0]} x "
              f"{args[0].shape[1]}, k_out {k_out}, k_res {args[5].shape[1]}, {n_changed} "
              f"changed rows; ms a launch): " + "; ".join(line) + f"; card {card}",
              flush=True)

    # K5 on its four inputs
    legacy = cs.legacy_pass_entries(li)
    safe = int(np.minimum(np.where(li["strat"] == 0, 0, li["reps"]), li["k_out"]).sum())
    pack21 = li["c"] <= 1 << 13
    inputs = {
        "steady phase A": ("pass", wires["steady"][:5], dict(m_cap=m_cap, d_cap=d_cap)),
        "churn phase A": ("pass", wires["churn"][:5], dict(m_cap=m_cap, d_cap=d_cap)),
        "dense phase B": ("entry", (phase_b,), dict(
            e_cap=_cap_round(max(int((phase_b > 0).sum().item()), 1)), pack21=pack21)),
        "legacy churn": ("entry", (legacy.entries,), dict(e_cap=_cap_round(safe),
                                                          pack21=pack21)),
    }
    for label, (kind, ins, kw) in inputs.items():
        desc = (f"{int(ins[0].sum().item())} changed rows of {ins[0].shape[0]}, m_cap "
                f"{kw['m_cap']}, d_cap {kw['d_cap']}" if kind == "pass" else
                f"{tuple(ins[0].shape)} words, {int((ins[0] > 0).sum().item())} entries, "
                f"e_cap {kw['e_cap']}, pack21 {kw['pack21']}")
        want = (fk.fleet_wire_ref(*ins, **kw) if kind == "pass" else
                fk.entry_wire_ref(ins[0], byte_wire=True, **kw))
        for i, d in enumerate(dirs):
            cuts = [c_ for (j, name, c_) in libs if j == i and name == "fleet_wire"]
            form = libs[(i, "fleet_wire", 0)].wire_form
            cs.compare(f"K5 {label} {d}", wire_run(libs[(i, "fleet_wire", 0)], kind, ins, kw),
                       want)
            times = {c_: cs.cuda_ms(lambda: wire_run(libs[(i, "fleet_wire", c_)], kind, ins,
                                                     kw)) for c_ in sorted(cuts)}
            print(f"# K5 split {d} ({form}; {label}: {desc}; ms a launch): "
                  + "; ".join(f"{WIRE_CUT_LABELS[form][c_]} {t:.4f}" for c_, t in times.items())
                  + f"; card {card}", flush=True)
    # the end of fleet_solve: the wire and its metas
    meta, ents = legacy.meta, legacy.entries
    kw = dict(e_cap=_cap_round(safe), pack21=pack21)
    want = fk.entry_wire_ref(ents, byte_wire=True, meta=meta, **kw)
    for i, d in enumerate(dirs):
        lib = libs[(i, "fleet_wire", 0)]
        if lib.wire_form == "three-pass":
            def tail():
                wire = wire_run(lib, "entry", (ents,), kw)
                return fk._solve_wire(wire[:4], meta, wire[4:], True)
        else:
            def tail():
                return wire_run(lib, "entry", (ents,), kw, meta=meta)
        cs.compare(f"K5 fleet_solve wire {d}", tail(), want)
        print(f"# K5 fleet_solve's wire {d} ({lib.wire_form}: the legacy churn entries "
              f"and {meta.numel()} metas; ms): {cs.cuda_ms(tail):.4f}; card {card}",
              flush=True)
    return 0


#: what each K5 copy runs, by source form and cut
WIRE_CUT_LABELS = {
    "three-pass": {0: "whole", 1: "memsets", 2: "+count", 3: "+scan", 4: "+write (no serialiser)"},
    "single-pass": {0: "whole", 1: "no writes"},
}


def phase_a_outputs(table, tables, state, rows_all, chunk):
    """(changed, meta, dcount, rows, deltas, res_dense): K3 -> K2 -> K4
    phase A over every chunk of the table's all-rows pass (d_slots 64)
    against a clone of its dense resident, and that clone after it."""
    import torch
    from karmada_tpu_torch.ops import divide_replicas
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    res_d, res_m = table._res_dense.clone(), table._res_meta.clone()
    has_agg = bool((table._st["strategy"][: table.n_rows] == 3).any())
    parts = []
    for i in range(rows_all.shape[0] // chunk):
        rc = rows_all[i * chunk:(i + 1) * chunk]
        m = fk.fleet_masks(*tables, rc, *state)
        a, u = divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w, m.avail,
                               m.prev, m.fresh, has_agg)
        parts.append(fk.fleet_diff(a, u, m.feasible, m.strategy, rc, res_d, res_m,
                                   all_rows=True, offset=i * chunk, d_slots=64))
    changed, meta, dcount, deltas = (torch.cat([p[k] for p in parts]) for k in range(4))
    return changed, meta, dcount, rows_all, deltas, res_d


def wire_run(lib, kind: str, ins: tuple, kw: dict, meta=None):
    """One launch of a K5 copy (either form) on a phase-A input
    (``kind`` "pass": changed, meta, dcount, rows, deltas; m_cap, d_cap)
    or an entry input (entries; e_cap, pack21; the byte wire), with the
    outputs its wrapper allocates; returns them."""
    import torch
    from karmada_tpu_torch import native
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    dev = ins[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    three = lib.wire_form == "three-pass"
    if kind == "pass":
        changed, _, _, _, deltas = ins
        m_cap, d_cap = kw["m_cap"], kw["d_cap"]
        n, d_slots = changed.shape[0], deltas.shape[1]
        flat = torch.empty((4 + n // 8 + 2 * m_cap + (4 + 3 * d_cap if d_cap else 0),),
                           dtype=torch.uint8, device=dev)
        rowbuf = torch.empty((m_cap,), dtype=torch.int32, device=dev)
        if three:
            nb = max(-(-n // 2048), -(-(n * d_slots) // 2048) if d_cap else 0, 1)
            mstream = torch.empty((m_cap,), dtype=torch.int32, device=dev)
            dstream = torch.empty((max(d_cap, 1),), dtype=torch.int32, device=dev)
            scratch = torch.empty((2 * nb + 4,), dtype=torch.int32, device=dev)
            err = lib.fleet_wire_launch(*[t.data_ptr() for t in ins], n, d_slots, m_cap,
                                        d_cap, mstream.data_ptr(), rowbuf.data_ptr(),
                                        dstream.data_ptr(), flat.data_ptr(),
                                        scratch.data_ptr(), nb, stream)
        else:
            scratch, fill = fk._wire_launch_args(n, fk.WIRE_ROW_TILE, 6 * m_cap + 3 * d_cap,
                                                 dev)
            err = lib.fleet_wire_launch(*[t.data_ptr() for t in ins], n, d_slots, m_cap,
                                        d_cap, flat.data_ptr(), rowbuf.data_ptr(),
                                        scratch.data_ptr(), fill, stream)
        native.check_launch("fleet_wire_launch", err)
        return flat, rowbuf
    entries = ins[0]
    n, e_cap, pack21 = entries.numel(), kw["e_cap"], kw["pack21"]
    m = 0 if meta is None else meta.numel()
    body = ((e_cap * 21 + 7) // 8 + 3) if pack21 else 3 * e_cap
    out = torch.empty((4 + 2 * m + body,), dtype=torch.uint8, device=dev)
    if three:
        nb = max(-(-n // 2048), 1)
        st = torch.empty((max(e_cap, 1),), dtype=torch.int32, device=dev)
        scratch = torch.empty((2 * nb + 4,), dtype=torch.int32, device=dev)
        err = lib.entry_wire_launch(entries.data_ptr(), n, e_cap, 1, int(pack21),
                                    st.data_ptr(), out.data_ptr(), scratch.data_ptr(), nb,
                                    stream)
    else:
        scratch, fill = fk._wire_launch_args(n, fk.WIRE_ENTRY_TILE, body, dev)
        err = lib.entry_wire_launch(entries.data_ptr(), n, e_cap, 2 if pack21 else 1,
                                    None if meta is None else meta.data_ptr(), m,
                                    out.data_ptr(), scratch.data_ptr(), fill, stream)
    native.check_launch("entry_wire_launch", err)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--fleet"]:
        return fleet_main(sys.argv[2:])
    import torch
    import karmada_tpu_torch
    from karmada_tpu_torch import native, ops
    from karmada_tpu_torch.ops.divide import launch_buffers
    from karmada_tpu_torch.scheduler import TensorScheduler

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"# card: {card}", flush=True)
    variants = [tuple(int(x) for x in v.split("/"))
                for v in (sys.argv[1] if len(sys.argv) > 1 else DEFAULT).split(",")]
    src = open(SOURCE).read()
    tmp = tempfile.mkdtemp(prefix="k2_variants_")
    procs = {}
    for v in variants:
        path = os.path.join(tmp, "k2_{}_{}_{}_{}".format(*v))
        with open(path + ".cu", "w") as f:
            f.write(variant_source(src, *v))
        procs[v] = (subprocess.Popen(
            [native.nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", "-o", path + ".so",
             path + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            path + ".so")
    native.build(("divide_replicas", "fleet_masks", "fleet_diff", "fleet_wire",
                  "scatter_rows", "estimate_merge"))
    fns = {}
    for v, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k2_variants: variant {v} does not build:\n{log}")
        usage = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"# variant E={v[0]} threads={v[1]} min_blocks={v[2]} cut={v[3]}: "
              + "; ".join(usage), flush=True)
        fn = ctypes.CDLL(so).divide_replicas_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[v] = fn
    dev = torch.device("cuda", 0)

    def run(fn, args, has_agg):
        b, c = args[2].shape
        bufs = launch_buffers(b, c, dev)
        err = fn(*[t.data_ptr() for t in args], b, c, int(has_agg),
                 *[x.data_ptr() for x in bufs[:4]], bufs[4],
                 torch.cuda.current_stream(dev).cuda_stream)
        native.check_launch("divide_replicas_launch", err)
        return bufs[0], bufs[1]

    def measure(label, args, has_agg=True):
        want = ops.divide_replicas_ref(*args, has_agg)
        out = []
        for v, fn in fns.items():
            got = run(fn, args, has_agg)
            if not v[3]:
                cs.compare(f"{label} {v}", got, (want.assignment, want.unschedulable))
            out.append("{}/{}/{}/{} {:.4f}".format(*v, cs.cuda_ms(lambda: run(fn, args, has_agg))))
        print(f"# {label} (E/threads/min_blocks/cut ms): " + "; ".join(out)
              + f"; card {card}", flush=True)

    rng = np.random.default_rng(cs.SEED)
    seeded = None
    for b, c in ((4096, 5000), (4096, 10_000), (1024, 16_385), (256, 40_000), (512, 1000)):
        t = cs.to_device(cs.divide_batch(rng, b, c), dev)
        args = [t[k] for k in cs.K2_ARGS]
        measure(f"{b}x{c} seeded", args)
        seeded = seeded or args
    cs.k2_phase_split(seeded, True, "4096x5000 seeded", card)
    t0 = time.perf_counter()
    snap, problems = cs.build_workload(karmada_tpu_torch, 5)
    engine = TensorScheduler(snap, chunk_size=4096, device=dev)
    engine.schedule(problems)
    torch.cuda.synchronize()
    args, has_agg = cs.k2_chunk_args(engine._fleet)
    print(f"# config-5 table built and scheduled in {time.perf_counter() - t0:.1f} s",
          flush=True)
    measure("config-5 chunk 0", args, has_agg)
    cs.k2_phase_split(args, has_agg, "config-5 chunk 0", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
