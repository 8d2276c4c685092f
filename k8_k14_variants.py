#!/usr/bin/env python3
"""Time K14 (``explain_pass``) and K8 (``node_sum_estimate``) as built from
one or more kernel source directories, side by side, on one NVIDIA GPU, and
split each form's time into its phases.

    python3 k8_k14_variants.py [CSRC_DIR ...]

Each directory named (``kernel_variants.start``: ``P N N P`` gives parent,
new, new, parent in one call) has its ``explain_pass.cu`` and
``node_sum.cu`` compiled on their own (``-Xptxas -v``: registers and spills
printed), held to the plain versions (``explain_pass_ref``,
``node_sum_estimate_ref``; exact) and timed behind the device spin on every
shape. The source forms known:

- the first slice's: K14 one 256-thread block a row, a cell a thread a
  step, every cell through the 8-deep insertion, k rounds of a block
  arg-max; K8 one 256-thread block a row, a node a thread a step, an int64
  division per requested dim;
- the Hopper forms: K14 a warp a row, 16 cells a lane a step, one sorted
  top-k queue across the warp fed by ballots; K8 clusters of blocks over
  the nodes, the node range staged in shared memory, one
  multiplier-and-shift high product per requested dim and cell;
- K8's float32 form (``float32 compare``), a Hopper form that compared the
  dims in float32 first and took the multiplier only where the float could
  not decide; timed whole, not split.

The phase split: copies cut by text, each timed beside the whole. Of the
first-slice forms, cumulative cuts, so the differences are each phase's
share. K14: loads and mask only (the insertion skipped), with the
insertion, with the merge, the whole (the merge's winners gathered). K8:
the mask and the sum only, with the loads of avail and the requests (no
division), the whole. Of the Hopper forms, copies that each leave one part
out (their answers are not exact: timed, not held), so the whole minus the
copy is that part's share: K14 without its top-k queue; K8 without its
mask loads or its dim loop, and its prologue alone (the requests, the first
tile and the multipliers).

Shapes: K14 at 4096 x 5000, k = 8 (``chip_smoke.explain_batch``: the main
path's chunk, full of key ties) and 4096 x 5, k = 5. K8 on
``chip_smoke.node_batch`` (uniform headroom and requests: an estimator
server's batch) at 4096 x 5000 with R = 4, 17 and 41 (two groups of
dims), at R = 4 with two dims tied (``tied``), and at the estimator phase's
8 profile rows x 4000 nodes, R = 4; and on the estimator phase's own node
data (``estimator_nodes``) at 8 x 4000 and 4096 x 5000. Beside K8, the
launch floor: an empty kernel appended to a Hopper-form ``node_sum.cu``
(``launch_floors.FLOORS``) at K8's grid and cluster shape on each K8
shape, and one block alone. Prints one line a
measurement and writes ``chiprun_out/k8_k14_variants.json``. Builds, calls
and times through ``kernel_variants``. Imports nothing of JAX.
"""

from __future__ import annotations

import statistics
import sys
import tempfile

import numpy as np

import chip_smoke as cs
import kernel_variants as kv
import launch_floors

ENTRY = {"explain_pass": "explain_pass_launch", "node_sum": "node_sum_launch"}

#: the first-slice K14's cuts: (text, replacement) pairs applied in turn
EXPLAIN_CUTS = {
    "loads and mask": (
        ("    for (int s = 0; s < MAXK; ++s) {\n      if (better(key, idx, kk[s], ii[s])) {",
         "    kk[0] ^= key + idx;\n"
         "    for (int s = 0; s < 0; ++s) {\n      if (better(key, idx, kk[s], ii[s])) {"),
        ("  const int lane = threadIdx.x & 31;\n  const int warp = threadIdx.x >> 5;\n",
         "  if (k == 99) topk[threadIdx.x] = (int)kk[0];\n  return;\n"
         "  const int lane = threadIdx.x & 31;\n  const int warp = threadIdx.x >> 5;\n"),
    ),
    "+ insertion": (
        ("  const int lane = threadIdx.x & 31;\n  const int warp = threadIdx.x >> 5;\n",
         "  if (k == 99) {\n    long long x = 0;\n"
         "    for (int s = 0; s < MAXK; ++s) x ^= kk[s] + ii[s];\n"
         "    topk[threadIdx.x] = (int)x;\n  }\n  return;\n"
         "  const int lane = threadIdx.x & 31;\n  const int warp = threadIdx.x >> 5;\n"),
    ),
    "+ merge": (
        ("  if (threadIdx.x < k) {\n    const int c = win[threadIdx.x];",
         "  if (k == 99) topk[threadIdx.x] = win[0];\n  return;\n"
         "  if (threadIdx.x < k) {\n    const int c = win[threadIdx.x];"),
    ),
}
#: the first-slice K8's cuts
NODE_CUTS = {
    "mask and sum": (
        ("    long long per = SENTINEL;\n    for (int r = 0; r < r_dims; ++r) {",
         "    long long per = n;\n    for (int r = 0; r < 0; ++r) {"),
    ),
    "+ loads": (
        ("      const long long ratio = a / qr;", "      const long long ratio = a ^ qr;"),
    ),
}


#: the Hopper forms' cuts: each copy leaves one part out (answers no longer
#: exact: timed, not held), so whole minus the copy is that part's share
EXPLAIN_WITHOUT = {
    "without the top-k queue": (
        ("    if (q.ti < 0) {  // uniform", "    if (false) {"),
        ("      q.offer(key_of(lane_of(as[j / 4], j % 4), lane_of(av[j / 4], j % 4)), c0 + j,\n"
         "              valid && c0 + j != skip, lane, k);",
         "      if (k == 99 && valid) topk[j] = (int)key_of(lane_of(as[j / 4], j % 4),\n"
         "                                                 lane_of(av[j / 4], j % 4));"),
        ("  if (lane < k) {\n    const int c = q.qi;", "  if (lane < k && q.qi >= 0) {\n    const int c = q.qi;"),
    ),
}
NODE_WITHOUT = {
    "without all but the prologue": (
        ("  if (threadIdx.x < MAX_TB) row_part[threadIdx.x] = 0;\n  __syncthreads();\n",
         "  if (threadIdx.x < MAX_TB) row_part[threadIdx.x] = 0;\n  __syncthreads();\n"
         "  if (r_dims < 100000) return;\n"),
    ),
    "without the mask loads": (
        ("            live[p] = last && c + p * 32 + lane < t1 - t0 && ok[c + p * 32];",
         "            live[p] = last;"),
    ),
    "without the dim loop": (
        ("            if (m == 0) continue;  // not requested: uniform over the warp",
         "            if (m == 0 || r_dims < 100000) continue;"),
    ),
}


def form(name: str, src: str) -> str:
    if name == "explain_pass":
        return "block a row" if "explain_pass_kernel<<<b_n, THREADS" in src else "warp a row"
    if "node_sum_kernel<<<b_n, THREADS" in src:
        return "block a row"
    return "float32 compare" if "tilef" in src else "clusters"


def cuts_of(name: str, src: str) -> tuple[str, dict]:
    """("cumulative" | "without", cut -> edits) for the form of ``src``."""
    kind = form(name, src)
    if kind == "block a row":
        return "cumulative", EXPLAIN_CUTS if name == "explain_pass" else NODE_CUTS
    if kind == "float32 compare":
        return "without", {}
    return "without", EXPLAIN_WITHOUT if name == "explain_pass" else NODE_WITHOUT


def sources(dirs: list) -> dict:
    """(dir, kernel, variant) -> source text: the whole of each kernel and
    its cut copies."""
    out = {}
    for d in dirs:
        for name in ENTRY:
            src = kv.source(d, name)
            out[(d, name, "whole")] = src
            for var, text in kv.variants("k8_k14_variants", name, src,
                                         cuts_of(name, src)[1]).items():
                out[(d, name, var)] = text
            if name == "node_sum" and form(name, src) == "clusters":
                out[(d, name, "floor")] = launch_floors.floor_source(name, "clusters", src)
    return out


def caller(lib, name: str, t: dict, k: int = 0):
    """A function that runs one launch of ``lib``'s entry point on the
    tensors ``t`` (allocating the outputs as the wrapper does) and returns
    its outputs."""
    import torch
    from karmada_tpu_torch import native
    from karmada_tpu_torch.ops.explain import TOPK_COLS

    dev = next(iter(t.values())).device
    run = kv.entry(lib, ENTRY[name], native.SIGNATURES[name][ENTRY[name]], dev)
    if name == "explain_pass":
        b, c = t["aff_ok"].shape

        def call():
            mask = torch.empty((b, c), dtype=torch.uint8, device=dev)
            topk = torch.empty((b, k, TOPK_COLS), dtype=torch.int32, device=dev)
            run(*t.values(), b, c, k, mask, topk)
            return mask, topk
        return call
    n, r = t["node_avail"].shape
    b = t["requests"].shape[0]

    def call():
        out = torch.empty((b,), dtype=torch.int32, device=dev)
        run(t["node_avail"], n, r, t["node_ok"], t["requests"], b, out)
        return out
    return call


def plain(name: str, t: dict, k: int = 0):
    from karmada_tpu_torch.estimator import accurate
    from karmada_tpu_torch.ops import explain

    if name == "explain_pass":
        return lambda: explain.explain_pass_ref(*t.values(), k=k)
    return lambda: accurate.node_sum_estimate_ref(t["node_avail"], t["node_ok"], t["requests"])


def floor_ms(lib, t: dict, device) -> dict:
    """The launch floor: the empty kernel at K8's grid and cluster shape for
    ``t``'s sizes (``launch_floors.FLOORS``), and one block alone."""
    b, n = t["node_ok"].shape
    r = t["requests"].shape[1]
    run = kv.entry(lib, "launch_floor_launch", launch_floors.FLOOR_SIGNATURE, device)
    return {"shape": cs.cuda_ms(lambda: run(n, r, b)), "one block": cs.cuda_ms(lambda: run(1, 1, 1))}


def tied(rng) -> dict:
    """``chip_smoke.node_batch`` at 4096 x 5000, R = 4, with dim 1 a copy of
    dim 0 in the node table and in the requests: every cell of a row that
    asks for dim 0 ties two ratios."""
    a = cs.node_batch(rng, 4096, 5000)
    a["node_avail"][:, 1] = a["node_avail"][:, 0]
    a["requests"][:, 1] = a["requests"][:, 0]
    return a


def estimator_nodes(b: int, n: int, seed: int) -> dict:
    """K8's inputs as the estimator phase makes them: ``n`` of its seeded
    nodes (``chip_smoke.node_states``) packed by the port's ``NodeCache``
    over the scheduler's dims (cpu, memory, pods, ephemeral-storage), every
    node passing the prefilter, and ``b`` request rows of round cpu and
    memory (row i: 250m x (i % 64 + 1) and 512Mi x ((i + i // 64) % 64 +
    1); at b = 8, the phase's eight profiles)."""
    import karmada_tpu_torch
    from karmada_tpu_torch.estimator.accurate import NodeCache
    from karmada_tpu_torch.scheduler.snapshot import DEFAULT_DIMS

    avail = NodeCache(DEFAULT_DIMS, cs.node_states(karmada_tpu_torch, n, seed)).available[:n]
    i = np.arange(b)
    req = np.zeros((b, len(DEFAULT_DIMS)), np.int64)
    req[:, 0] = 250 * (i % 64 + 1)
    req[:, 1] = (512 << 20) * ((i + i // 64) % 64 + 1)
    return {"node_avail": np.ascontiguousarray(avail), "node_ok": np.ones((b, n), bool),
            "requests": req}


def split(libs, d: str, name: str, label: str, t: dict, k: int, whole_call, form_name: str,
          card: str) -> dict:
    """The phase split of ``d``'s form on ``t``: each cut copy timed beside
    the whole (medians of 3)."""
    kind, cuts = cuts_of(name, kv.source(d, name))
    cut_ms = {cut: statistics.median(cs.cuda_ms(caller(libs[(d, name, cut)], name, t, k))
                                     for _ in range(3)) for cut in cuts}
    whole = statistics.median(cs.cuda_ms(whole_call) for _ in range(3))
    if kind == "cumulative":  # each copy adds a phase to the one before
        cut_ms["whole"] = whole
        prev, phases = 0.0, {}
        for cut, ms in cut_ms.items():
            phases[cut] = ms - prev
            prev = ms
    else:  # each copy leaves one part out; the prologue alone
        prologue = cut_ms.pop("without all but the prologue", None)
        phases = {cut.replace("without ", ""): whole - ms for cut, ms in cut_ms.items()}
        if prologue is not None:
            phases["prologue"] = cut_ms["prologue alone"] = prologue
        cut_ms["whole"] = whole
    print(f"# {name} {label}: {form_name} form's phases ("
          + ("cut differences" if kind == "cumulative" else
             "whole minus a copy without each; the prologue alone") + "): "
          + ", ".join(f"{c} {v:.4f} ms" for c, v in phases.items())
          + f" (whole {whole:.4f}; {d}); card {card}", flush=True)
    return {"kernel": name, "shape": label, "dir": d, "cut_ms": cut_ms, "phases": phases}


def main(argv: list) -> int:
    import torch

    setup = kv.start(argv, "k8_k14_variants")
    if setup is None:
        return 1
    device, card, named, dirs = setup
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build("k8_k14_variants", sources(dirs), tmp, ptxas=True)
        forms = {d: {n: form(n, kv.source(d, n)) for n in ENTRY} for d in dirs}
        rng = np.random.default_rng(cs.SEED)
        shapes = [("explain_pass", "4096 x 5000, k = 8", lambda: cs.explain_batch(rng, 4096, 5000), 8),
                  ("explain_pass", "4096 x 5, k = 5", lambda: cs.explain_batch(rng, 4096, 5), 5),
                  ("node_sum", "4096 x 5000, R = 4", lambda: cs.node_batch(rng, 4096, 5000), 0),
                  ("node_sum", "8 x 4000, R = 4 (the estimator phase's shape)",
                   lambda: cs.node_batch(rng, 8, 4000), 0),
                  ("node_sum", "4096 x 5000, R = 17", lambda: cs.node_batch(rng, 4096, 5000, r=17), 0),
                  ("node_sum", "4096 x 5000, R = 41", lambda: cs.node_batch(rng, 4096, 5000, r=41), 0),
                  ("node_sum", "4096 x 5000, R = 4, dims 0 and 1 tied", lambda: tied(rng), 0),
                  ("node_sum", "8 x 4000 on the estimator phase's nodes",
                   lambda: estimator_nodes(8, 4000, 1000), 0),
                  ("node_sum", "4096 x 5000 on the estimator phase's nodes",
                   lambda: estimator_nodes(4096, 5000, 1001), 0)]
        results = {"card": card, "dirs": named, "times": [], "splits": [], "floors": []}
        for name, label, make, k in shapes:
            t = cs.to_device(make(), device)
            want = plain(name, t, k)()
            calls = {d: caller(libs[(d, name, "whole")], name, t, k) for d in dirs}
            row = kv.time_row(name, label, calls, want, named,
                              {d: forms[d][name] for d in dirs}, card)
            nbytes, ops = (cs.explain_bound(t, k) if name == "explain_pass"
                           else cs.node_sum_bound(t, want))
            row["bound_ms"], row["bound_by"] = cs._bound(nbytes, ops)
            print(f"# {name} {label}: bound {row['bound_ms']:.6f} ms by {row['bound_by']}",
                  flush=True)
            results["times"].append(row)
            for d in dirs:
                if forms[d][name] != "float32 compare" and d in row["held"]:
                    results["splits"].append(split(libs, d, name, label, t, k, row["held"][d],
                                                   forms[d][name], card))
            if name == "node_sum":
                for d in dirs:
                    if forms[d][name] == "clusters":
                        fl = floor_ms(libs[(d, name, "floor")], t, device)
                        print(f"# launch floor at K8's {label} grid: {fl['shape']:.4f} ms; one "
                              f"block: {fl['one block']:.4f} ms ({d}); card {card}", flush=True)
                        results["floors"].append({"shape": label, "dir": d, **fl})
                        break
            row.pop("held")
            del t, want, calls
            torch.cuda.empty_cache()
    kv.write(results, "k8_k14_variants")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
