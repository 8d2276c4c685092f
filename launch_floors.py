"""Launch floors of the port's kernels: a kernel's source with an empty
kernel appended (``FLOORS``), launched by ``launch_floor_launch`` at that
kernel's grid for given sizes. Its time is the least a launch of the kernel
at those sizes can take, the yardstick for a kernel whose byte bound lies
under it (K8 at the estimator's 8 x 4000, K1's table form at 8 x 5000, K7
at the engine's 8 profiles, K6's dirty upsert and gather).
The port's own libraries do not carry it.

- ``floor_source`` appends the empty kernel to a source of a known form.
- ``start`` / ``finish`` build the floors of the port's own sources
  (``PORT_FLOORS``) with ``nvcc`` processes started together, beside the
  port's own build; ``floor_entry`` loads one (building it if needed) as a
  function of three ints. A build is named by a hash of its text and of the
  shared headers (``csrc/*.cuh``), as ``native.so_path`` names the port's
  libraries, into the ignored ``karmada_tpu_torch/_build/``: a second run
  loads what the first built.

``chip_smoke`` and the timing scripts (``k8_k14_variants.py``,
``k1_k13_variants.py``, ``k6_k7_variants.py``) use it. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "karmada_tpu_torch", "csrc")

#: per (kernel, source form): the text appended to the source that adds
#: ``launch_floor_launch`` (C arguments ``FLOOR_SIGNATURE``, then the
#: stream), an empty kernel launched at the kernel's grid for those sizes
FLOORS = {
    ("node_sum", "clusters"): """
__global__ void launch_floor_kernel(int) {}

// K8's grid and cluster shape at N = a, R = b, B = c
extern "C" int launch_floor_launch(int n_nodes, int r_dims, int b_n, cudaStream_t stream) {
  if (b_n == 0) return 0;
  const Shape s = shape_of(n_nodes, r_dims, b_n);
  const int err = launch_clustered(launch_floor_kernel, (b_n + s.tb - 1) / s.tb * s.csize,
                                   s.csize, 0, stream, b_n);
  if (err) return err;
  return (int)cudaGetLastError();
}
""",
    ("estimate_merge", "row streaming"): """
__global__ void launch_floor_kernel(int) {}

// K1's table-form grid at U = a, C = b, R = c
extern "C" int launch_floor_launch(int u_n, int c_n, int r_dims, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  Args a = {};
  a.c_n = c_n, a.r_dims = r_dims, a.u_n = u_n, a.b_n = u_n;
  const Shape s = r_dims <= G ? sized<TABLE, true>(a) : sized<TABLE, false>(a);
  launch_floor_kernel<<<dim3((unsigned)((u_n + s.rb - 1) / s.rb), s.tiles), s.ct * s.rg, 0,
                       stream>>>(0);
  return (int)cudaGetLastError();
}
""",
    ("estimate_merge", "column a thread"): """
__global__ void launch_floor_kernel(int) {}

// K1's table-form grid at U = a, C = b (R = c unused)
extern "C" int launch_floor_launch(int u_n, int c_n, int r_dims, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  launch_floor_kernel<<<run_grid(c_n, u_n, 0), TILE_C, 0, stream>>>(r_dims);
  return (int)cudaGetLastError();
}
""",
    ("scatter_rows", "warp groups"): """
__global__ void launch_floor_kernel(int) {}

// K6's grids: the scatter over a rows x b fields (b > 0) whose widest row
// is c units, else the gather over a rows
extern "C" int launch_floor_launch(int k, int n_fields, int widest, cudaStream_t stream) {
  if (k == 0) return 0;
  if (n_fields > 0)
    launch_floor_kernel<<<scatter_grid(k, n_fields, widest).blocks, THREADS, 0, stream>>>(0);
  else
    launch_floor_kernel<<<(k + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS, 0,
                          stream>>>(0);
  return (int)cudaGetLastError();
}
""",
    ("scatter_rows", "block a row"): """
__global__ void launch_floor_kernel(int) {}

// K6's grids: the scatter over a rows x b fields (b > 0), else the gather
// over a rows (c, the widest row's units, unused)
extern "C" int launch_floor_launch(int k, int n_fields, int, cudaStream_t stream) {
  if (k == 0) return 0;
  if (n_fields > 0)
    launch_floor_kernel<<<k, THREADS, 0, stream>>>(0);
  else
    launch_floor_kernel<<<(k + 255) / 256, 256, 0, stream>>>(0);
  return (int)cudaGetLastError();
}
""",
    ("model_estimate", "cluster tiles"): """
__global__ void launch_floor_kernel(int) {}

// K7's grid at U = a, C = b, G = c >> 16, R = c & 0xFFFF
extern "C" int launch_floor_launch(int u_n, int c_n, int gr, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  const int r_dims = gr & 0xFFFF;
  const Shape s = shape_of(gr >> 16, r_dims, u_n);
  const void* kernel = kernel_of(s, r_dims);
  if (s.smem > 48 * 1024) {  // the occupancy query reads it
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err) return err;
  }
  int per_block = 0;
  launch_floor_kernel<<<grid_of(s, kernel, c_n, u_n, &per_block), THREADS, 0, stream>>>(0);
  return (int)cudaGetLastError();
}
""",
    ("model_estimate", "thread a cell"): """
__global__ void launch_floor_kernel(int) {}

// K7's grid at U = a, C = b (c unused)
extern "C" int launch_floor_launch(int u_n, int c_n, int, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  launch_floor_kernel<<<dim3((c_n + TILE_C - 1) / TILE_C, u_n), TILE_C, 0, stream>>>(0);
  return (int)cudaGetLastError();
}
""",
}
FLOOR_SIGNATURE = "iii"
#: the floors of the port's own sources, by kernel: their source form
PORT_FLOORS = {"node_sum": "clusters", "estimate_merge": "row streaming",
               "scatter_rows": "warp groups", "model_estimate": "cluster tiles"}


def model_floor_arg(g_n: int, r_dims: int) -> int:
    """K7's floor takes G and R as one int: ``G << 16 | R``."""
    return g_n << 16 | r_dims


def scatter_floor_arg(widths) -> int:
    """K6's floor takes the widest row in copy units: a row of w bytes is
    w / u units of the widest u of 16, 8, 4, 2, 1 that divides w (bases
    aligned, as fresh tensors are)."""
    return max(w // next(u for u in (16, 8, 4, 2, 1) if w % u == 0) for w in widths)

_LIBS: dict = {}


def floor_source(name: str, form: str, src: str) -> str:
    """``src`` (kernel ``name`` in source form ``form``) with its launch
    floor appended (as it is where the source defines one already, as an
    older K8's does)."""
    return src if "launch_floor_launch" in src else src + FLOORS[(name, form)]


def _paths(name: str, d: str) -> tuple[str, str, str]:
    """(source text, .cu path, .so path) of kernel ``name``'s floor build
    from directory ``d``, named by a hash of the text and of ``d``'s shared
    headers."""
    from karmada_tpu_torch import native

    with open(os.path.join(d, f"{name}.cu")) as f:
        text = floor_source(name, PORT_FLOORS[name], f.read())
    h = hashlib.sha256(text.encode())
    for fname in sorted(f for f in os.listdir(d) if f.endswith(".cuh")):
        with open(os.path.join(d, fname), "rb") as f:
            h.update(f.read())
    stem = os.path.join(native.BUILD_DIR, f"lib{name}_floor-{h.hexdigest()[:16]}")
    return text, stem + ".cu", stem + ".so"


def start(names=tuple(PORT_FLOORS), d: str = CSRC) -> dict:
    """Start one ``nvcc`` for each floor in ``names`` that has no current
    build; returns what ``finish`` waits on."""
    from karmada_tpu_torch import native

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        text, cu, so = _paths(name, d)
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        with open(cu, "w") as f:
            f.write(text)
        cmd = [native.nvcc(), *native.NVCC_FLAGS, "-I", d, "-o", tmp, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    return {"t0": time.perf_counter(), "procs": procs}


def finish(started: dict) -> dict[str, float]:
    """Wait for ``start``'s builds; the wall seconds each took from the
    start (none for a floor already built). Raises with the compiler's
    output on a failed build."""
    seconds, failed = {}, []
    for name, (proc, tmp, so) in started["procs"].items():
        log, _ = proc.communicate(timeout=600)
        seconds[f"{name} floor"] = time.perf_counter() - started["t0"]
        if proc.returncode:
            failed.append(f"{name} floor: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)  # atomic under concurrent builders
    if failed:
        raise RuntimeError("launch floor build failed:\n" + "\n".join(failed))
    return seconds


def floor_entry(name: str, device, d: str = CSRC):
    """``launch_floor_launch`` of the port's kernel ``name`` (from
    directory ``d``) as a function of three ints that launches on the
    current stream of ``device`` and raises on an error; built first if it
    has no current build."""
    import torch
    from karmada_tpu_torch import native

    key = (name, d)
    if key not in _LIBS:
        finish(start((name,), d))
        fn = ctypes.CDLL(_paths(name, d)[2]).launch_floor_launch
        fn.argtypes = [native._CTYPES[c] for c in FLOOR_SIGNATURE] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[key] = fn
    fn = _LIBS[key]

    def run(*args):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"launch_floor_launch ({name}): launch refused, error {err}")
    return run
