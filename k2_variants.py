#!/usr/bin/env python3
"""Time build variants and truncated copies of K2 (``divide_replicas``) on
one NVIDIA GPU, beside the built kernel's phase split.

    python3 k2_variants.py [E/THREADS/MIN_BLOCKS/CUT,...]

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
"""

from __future__ import annotations

import ctypes
import os
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


def main() -> int:
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
