"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` holds one kernel with a plain C entry point. It is
compiled on first use by ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared`` into ``_build/lib<name>-<source hash>.so`` beside the package
(the directory is git-ignored) and loaded with ctypes. The hash covers the
source and the shared headers (``csrc/*.cuh``), so an edited kernel is never
served from a stale build.
``build()`` starts one ``nvcc`` per source, all at once, so a cold start
pays for the slowest kernel only.

``SIGNATURES`` declares every launch entry point's C arguments; ``load``
sets each function's ``argtypes`` once, when its library loads, and
``launch`` is the one way a wrapper calls a kernel: on the current stream
of the tensors' device, raising on a failed launch and counting it on the
wrapper. ``on_cpu`` and ``check`` are the wrappers' shared device, dtype
and contiguity checks.

The host wire runtime of the fleet path (``csrc/fold.c``, built with the
host compiler) is ``native.fold``.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = (
    "estimate_merge", "divide_replicas", "fleet_masks", "fleet_diff",
    "fleet_wire", "scatter_rows", "model_estimate", "node_sum",
    "quota_admit", "quota_caps", "explain_pass", "preempt_select",
    "entry_diff", "first_fit_group",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: each launch entry point's C arguments before its trailing
#: ``cudaStream_t``, one letter each: ``p`` a pointer (a tensor's data or a
#: ctypes array), ``i`` an int, ``q`` a long long. Every entry point
#: returns its ``cudaGetLastError`` as an int.
SIGNATURES = {
    "estimate_merge": {
        "estimate_merge_launch": "piipipppip",
        "profile_table_launch": "piipipp",
        "estimate_merge_table_launch": "piip" "pi" "pi" "pp",
    },
    "divide_replicas": {
        "divide_replicas_launch": "pppppppiii" "ppppi",
        "divide_replicas_phases_launch": "pppppppiii" "ppppi" "p",
    },
    "fleet_masks": {
        "fleet_masks_launch": "pppppiipi" "pppppppp" "i" "ppppppp",
        "fleet_bits_launch": "pppppiipi" "pppppppp" "i" "p",
    },
    "fleet_diff": {
        "fleet_diff_launch": "pppppii" "pp" "iiii" "pppp",
        "fleet_entry_rows_launch": "piipiip",
    },
    "fleet_wire": {
        "fleet_wire_launch": "ppppp" "iiii" "ppp" "i",
        "entry_wire_launch": "pqii" "pi" "pp" "i",
    },
    "scatter_rows": {
        "scatter_rows_launch": "pppipii",
        "gather_meta_launch": "pipip",
    },
    "model_estimate": {"model_overlay_launch": "pppiiipi" "ppp" "i" "p"},
    "node_sum": {"node_sum_launch": "piippip"},
    "quota_admit": {"quota_admit_launch": "pppiiipp" "ppppp" "i"},
    "quota_caps": {
        "quota_caps_launch": "piiippip",
        "quota_fold_launch": "piiippip",
    },
    "explain_pass": {"explain_pass_launch": "pppppppppppp" "iii" "pp"},
    "preempt_select": {"preempt_select_launch": "ppppppp" "iiii" "pppppppp"},
    "entry_diff": {"entry_diff_launch": "pppppii" "p" "iiiii" "ppp"},
    "first_fit_group": {"first_fit_group_launch": "ppppppppp" "iiiii" "ppp"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$NVCC``, then ``nvcc`` on PATH, then
    the toolkit PyTorch itself resolves (``CUDA_HOME``)."""
    path = os.environ.get("NVCC") or shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME")


def so_path(name: str) -> str:
    """The build of ``csrc/<name>.cu``, named by a hash of the source and of
    every shared header beside it (``csrc/*.cuh``)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compile every kernel in ``names`` that has no current build, one
    ``nvcc`` process per source, all started together. Returns the wall
    seconds until each finished (0.0 for one already built). Raises with
    the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = so_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate(timeout=600)
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic under concurrent builders
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    the argument types of its entry points set from ``SIGNATURES``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(so_path(name))
            for fn_name, sig in SIGNATURES.get(name, {}).items():
                fn = getattr(lib, fn_name)
                fn.argtypes = [_CTYPES[k] for k in sig] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def on_cpu(tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    raises unless they all lie on one CUDA device otherwise."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"inputs must all lie on one CUDA device, got {devs}")
    return False


def check(name: str, **tensors) -> None:
    """Each value is (tensor, dtype): contiguous and of that dtype."""
    for arg, (t, dt) in tensors.items():
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dt} tensor, "
                             f"got {t.dtype}")


def launch(wrapper, lib_name: str, fn_name: str, device, *args) -> None:
    """Call a kernel's C entry point on the current stream of ``device``;
    each argument is a tensor (its data pointer is passed), a Python int or
    a ctypes array, as ``SIGNATURES`` declares. Raises on a non-zero launch
    status; otherwise adds one to ``wrapper.launches``."""
    fn = getattr(load(lib_name), fn_name)
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*vals, torch.cuda.current_stream(device).cuda_stream)
    check_launch(fn_name, err)
    with _COUNT_LOCK:  # estimator fan-out threads launch concurrently
        wrapper.launches += 1
