#!/usr/bin/env python3
"""Time K12 (``quota_admit``) and K15 (``preempt_select``) as built from one
or more kernel source directories, side by side, on one NVIDIA GPU, and
split each kernel's time into its phases.

    python3 k12_k15_variants.py [CSRC_DIR ...]

Each directory named (default: the port's own ``karmada_tpu_torch/csrc``;
another checkout's, such as a parent commit's unpacked with ``git archive``
into the ignored ``_archive/``, can be named beside it) has its
``quota_admit.cu`` and ``preempt_select.cu`` compiled on their own
(``nvcc``, as the port builds them, with the directory on the include
path), held to the plain versions (``quota_admit_ref``,
``preempt_select_ref``; exact) and timed (CUDA events behind a device
spin, ``chip_smoke.cuda_ms``) on every shape, the directories in the order
named for each shape, so ``P N N P`` gives parent, new, new, parent in one
call (a directory named twice is built once). Two source forms are known:

- the per-namespace K12 (one block per namespace walking every row) and the
  bitonic K15 (a sort network, a two-level scan, a binary-search select);
- the radix forms (``csrc/radix_sort.cuh``: a radix partition and a
  segmented scan; a radix sort of both keys, tile sums, the fused select,
  the product over the list of victims).

The phase split. Of the per-namespace K12: a copy with ``clock64`` read
around every block-wide scan and at each block's start and end gives, per
block, the cycles of its walk over the rows and of its scans (the block of
the most cycles is the critical path). Of the bitonic K15: copies that
return after the keys (cut 1), the sort (2), the scans (3) and the select
(4) are timed beside the whole, so the differences are each group of
launches. Of the radix forms: each device operation's time in one call
under ``torch.profiler``, summed by kernel name.

Shapes: K12 at 131,072 rows (``chip_smoke.admit_batch``) with N = 1, 32,
1024 and 4096 namespaces at R = 4, and N = 32 at R = 17 and 40; K15 on
``chip_smoke.preempt_batch`` (131,072 rows x 5000 clusters) at R = 4 and
17, and on the preemption pass's own inputs (``chip_smoke.preemption_scene``
at full size: 100k residents placed by a cold pass, 1000 surge rows;
101,000 rows, sort keys for 2^17). A form that refuses a shape (the
bitonic K15 past 16 dims) is reported as refused. Prints one line per
measurement and writes ``chiprun_out/k12_k15_variants.json``. Builds,
calls and times through ``kernel_variants``. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
import tempfile

import numpy as np

import chip_smoke as cs
import kernel_variants as kv

ENTRY = {"quota_admit": "quota_admit_launch", "preempt_select": "preempt_select_launch"}
#: C arguments of the older forms' entry points, before the stream (the
#: radix forms' are ``native.SIGNATURES``')
OLD_SIGNATURES = {
    ("quota_admit", "per-namespace"): "pppiiipp",
    ("preempt_select", "bitonic"): "ppppppp" "iiiii" "pppppp",
}

#: the per-namespace K12 with clock64 around its block scans: (text, replacement)
ADMIT_CLOCKS = (
    ("__global__ void quota_admit_kernel(",
     "__device__ long long g_cycles[2 * 8192];\n"
     "__device__ __forceinline__ long long timed_scan(long long& acc, long long x,\n"
     "                                                long long* ws, long long* total) {\n"
     "  const long long t0 = clock64();\n"
     "  const long long v = block_scan(x, ws, total);\n"
     "  acc += clock64() - t0;\n"
     "  return v;\n"
     "}\n\n"
     "__global__ void quota_admit_kernel("),
    ("  const int k = blockIdx.x;  // namespace row; k == n_ns owns the rest",
     "  const long long c_start = clock64();\n  long long c_scan = 0;\n"
     "  const int k = blockIdx.x;  // namespace row; k == n_ns owns the rest"),
    ("before + block_scan(x, warp_sums, &total)",
     "before + timed_scan(c_scan, x, warp_sums, &total)"),
    ("        block_scan(x, warp_sums, &total);\n"
     "        if (threadIdx.x == 0) used[r] += total;",
     "        timed_scan(c_scan, x, warp_sums, &total);\n"
     "        if (threadIdx.x == 0) used[r] += total;"),
    ("  if (pad) return;",
     "  if (pad) {\n    if (threadIdx.x == 0) {\n"
     "      g_cycles[blockIdx.x] = clock64() - c_start;\n"
     "      g_cycles[8192 + blockIdx.x] = c_scan;\n    }\n    return;\n  }"),
    ("        block_scan(take ? d_row[r] : 0, warp_sums, &total);",
     "        timed_scan(c_scan, take ? d_row[r] : 0, warp_sums, &total);"),
    ("    __syncthreads();\n  }\n}\n\n}  // namespace",
     "    __syncthreads();\n  }\n  if (threadIdx.x == 0) {\n"
     "    g_cycles[blockIdx.x] = clock64() - c_start;\n"
     "    g_cycles[8192 + blockIdx.x] = c_scan;\n  }\n}\n\n}  // namespace"),
    ("extern \"C\" int quota_admit_launch(",
     "extern \"C\" int quota_admit_cycles(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles), 0,\n"
     "                                   cudaMemcpyDeviceToDevice);\n}\n\n"
     "extern \"C\" int quota_admit_launch("),
)
#: the bitonic K15's cuts: each returns before the text named
SELECT_CUTS = {
    1: "  const dim3 tiles(n2 / SORT_TILE, 2);",
    2: "  scan_tiles_kernel<<<",
    3: "  if (b_n > 0) {\n    select_kernel<<<",
    4: "  cudaMemsetAsync(freed_caps",
}
SELECT_CUT_NAMES = {1: "keys", 2: "sort", 3: "scans", 4: "select", 0: "freed_caps"}


def form(name: str, src: str) -> str:
    if name == "quota_admit":
        return "per-namespace" if "quota_admit_kernel<<<n_ns + 1" in src else "radix"
    return "bitonic" if "sort_step_kernel" in src else "radix"


def sources(dirs: list) -> dict:
    """(dir, kernel, variant) -> source text: the whole of each kernel, and
    the phase-split copies of the older forms."""
    out = {}
    for d in dirs:
        for name in ENTRY:
            src = kv.source(d, name)
            out[(d, name, "whole")] = src
            if form(name, src) == "per-namespace":
                out[(d, name, "clocks")] = kv.variants(
                    "k12_k15_variants", name, src, {"clocks": ADMIT_CLOCKS})["clocks"]
            elif form(name, src) == "bitonic":
                cuts = {f"cut{cut}": ((text, f"  return (int)cudaGetLastError();\n{text}"),)
                        for cut, text in SELECT_CUTS.items()}
                for var, text in kv.variants("k12_k15_variants", name, src, cuts).items():
                    out[(d, name, var)] = text
    return out


def signature(name: str, kind: str) -> str:
    from karmada_tpu_torch import native

    return OLD_SIGNATURES.get((name, kind)) or native.SIGNATURES[name][ENTRY[name]]


def caller(lib, name: str, kind: str, t: dict):
    """A function that runs one launch of ``lib``'s entry point on the
    tensors ``t`` (allocating outputs and scratch as that form's wrapper
    does) and returns its outputs."""
    import torch
    from karmada_tpu_torch.ops import preempt, quota

    dev = next(iter(t.values())).device
    run = kv.entry(lib, ENTRY[name], signature(name, kind), dev)

    if name == "quota_admit":
        ns, demand, rem = t["ns_ids"], t["demand"], t["remaining"]
        b, (n, r) = ns.shape[0], rem.shape

        def call():
            admitted = torch.empty(b, dtype=torch.bool, device=dev)
            used = torch.empty((n, r), dtype=torch.int64, device=dev)
            scratch = quota.admit_scratch(b, n, r, dev) if kind == "radix" else ()
            run(ns, demand, rem, b, n, r, admitted, used, *scratch)
            return admitted, used
        return call
    args = [t[k] for k in ("prio", "demand", "freed", "victim_ok", "weight", "assigned",
                           "requests")]
    b, r = t["demand"].shape
    c = t["assigned"].shape[1]
    bk = t.get("b_key") or b

    def call():
        victims = torch.empty(b, dtype=torch.bool, device=dev)
        caps = torch.empty((c, r), dtype=torch.int64, device=dev)
        if kind == "radix":
            run(*args, b, bk, r, c, victims, caps, *preempt.select_scratch(b, r, dev))
        else:
            n2 = max(2048, 1 << (b - 1).bit_length())
            run(*args, b, bk, r, c, n2, victims, caps,
                torch.empty((2, n2), dtype=torch.int64, device=dev),
                torch.empty((2, n2), dtype=torch.int32, device=dev),
                torch.empty((2, r, n2), dtype=torch.int64, device=dev),
                torch.empty((2, r, n2 // 1024 + 1), dtype=torch.int64, device=dev))
        return victims, caps
    return call


def plain(name: str, t: dict):
    from karmada_tpu_torch import ops

    if name == "quota_admit":
        return lambda: ops.quota_admit_ref(t["ns_ids"], t["demand"], t["remaining"])
    args = [t[k] for k in ("prio", "demand", "freed", "victim_ok", "weight", "assigned",
                           "requests")]
    return lambda: ops.preempt_select_ref(*args, b_key=t.get("b_key"))


def admit_clock_split(lib, t: dict, card: str, label: str) -> dict:
    """The per-namespace K12's cycles per block: walk (everything but the
    scans) and scans, for the critical block and summed over blocks."""
    import torch

    caller(lib, "quota_admit", "per-namespace", t)()
    cycles = torch.empty(2 * 8192, dtype=torch.int64, device=t["demand"].device)
    torch.cuda.synchronize()
    if lib.quota_admit_cycles(ctypes.c_void_p(cycles.data_ptr())):
        raise RuntimeError("quota_admit_cycles failed")
    blocks = t["remaining"].shape[0] + 1
    tot = cycles[:blocks].cpu().numpy()
    scan = cycles[8192:8192 + blocks].cpu().numpy()
    k = int(np.argmax(tot))
    out = {"blocks": blocks, "critical_block": k, "critical_kcycles": tot[k] / 1e3,
           "critical_scan_share": float(scan[k] / tot[k]),
           "mean_kcycles": float(tot.mean() / 1e3),
           "scan_share_all": float(scan.sum() / tot.sum())}
    print(f"# K12 per-namespace phase split, {label}: {blocks} blocks; critical block {k}: "
          f"{out['critical_kcycles']:.1f} kcycles, scans {out['critical_scan_share']:.3f} of "
          f"them, the walk {1 - out['critical_scan_share']:.3f}; mean block "
          f"{out['mean_kcycles']:.1f} kcycles, scans {out['scan_share_all']:.3f} of all "
          f"block cycles; card {card}", flush=True)
    return out


def pass_inputs(device) -> dict:
    """K15's inputs on the preemption pass at full size, as the engine
    packs them: (tensors, b_key)."""
    import torch
    from karmada_tpu_torch.scheduler import BindingProblem, TensorScheduler

    snap, low, hi, req = cs.preemption_scene(100_000, 5000, 1000)
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    cold = engine.schedule(low)
    torch.cuda.synchronize()
    pool = [BindingProblem(key=p.key, placement=p.placement, replicas=2, requests=req,
                           gvk=p.gvk, prev=dict(r.clusters)) for p, r in zip(low, cold)]
    inputs, padded = engine._preempt_inputs(hi, pool)
    t = cs.to_device(inputs, device)
    t["b_key"] = padded
    return t


def main(argv: list) -> int:
    import torch
    from karmada_tpu_torch import native

    setup = kv.start(argv, "k12_k15_variants")
    if setup is None:
        return 1
    device, card, named, dirs = setup
    native.build()
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build("k12_k15_variants", sources(dirs), tmp)
        forms = {d: {n: form(n, kv.source(d, n)) for n in ENTRY} for d in dirs}
        rng = np.random.default_rng(cs.SEED)
        shapes = [("quota_admit", f"131072 x N={n} x R={r}",
                   cs.to_device(cs.admit_batch(rng, n=n, r=r), device))
                  for n, r in ((1, 4), (32, 4), (1024, 4), (4096, 4), (32, 17), (32, 40))]
        shapes += [("preempt_select", f"131072 x 5000 seeded R={r}",
                    cs.preempt_batch(rng, device, r=r)) for r in (4, 17)]
        shapes.append(("preempt_select", "the preemption pass's 101,000 rows",
                       pass_inputs(device)))
        results = {"card": card, "dirs": named, "times": [], "splits": []}
        for name, label, t in shapes:
            want = plain(name, t)()
            calls = {d: caller(libs[(d, name, "whole")], name, forms[d][name], t) for d in dirs}
            row = kv.time_row(name, label, calls, want, named,
                              {d: forms[d][name] for d in dirs}, card)
            held = row["held"]
            results["times"].append(row)
            for d in dirs:
                if forms[d][name] == "radix" and d in held:
                    split = kv.profiled(held[d])
                    print(f"# {name} {label}: radix form's device operations: "
                          + ("; ".join(f"{k} x{n} {ms:.4f} ms" for k, (n, ms) in split.items())
                             or "not measured (the profiler saw none)")
                          + f"; card {card}", flush=True)
                    results["splits"].append({"kernel": name, "shape": label, "dir": d,
                                              "ops": split})
                elif name == "quota_admit" and label.endswith("R=4") and "N=1 " not in label:
                    results["splits"].append({"kernel": name, "shape": label, "dir": d,
                                              "clocks": admit_clock_split(
                                                  libs[(d, name, "clocks")], t, card, label)})
                elif name == "preempt_select" and d in held:
                    cut_ms = {}
                    for cut in (1, 2, 3, 4):
                        fn = caller(libs[(d, name, f"cut{cut}")], name, "bitonic", t)
                        cut_ms[cut] = statistics.median(cs.cuda_ms(fn) for _ in range(3))
                    cut_ms[0] = statistics.median(cs.cuda_ms(held[d]) for _ in range(3))
                    prev, groups = 0.0, {}
                    for cut in (1, 2, 3, 4, 0):
                        groups[SELECT_CUT_NAMES[cut]] = cut_ms[cut] - prev
                        prev = cut_ms[cut]
                    print(f"# {name} {label}: bitonic form's groups (cut differences): "
                          + ", ".join(f"{k} {v:.4f} ms" for k, v in groups.items())
                          + f" (whole {cut_ms[0]:.4f}); card {card}", flush=True)
                    results["splits"].append({"kernel": name, "shape": label, "dir": d,
                                              "groups": groups, "whole": cut_ms[0]})
            del t, calls, held
            row.pop("held")
            torch.cuda.empty_cache()
    kv.write(results, "k12_k15_variants")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
