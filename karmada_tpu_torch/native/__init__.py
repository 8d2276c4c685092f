"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` holds one kernel with a plain C entry point. It is
compiled on first use by ``nvcc -gencode arch=compute_90a,code=sm_90a
-shared`` into ``_build/lib<name>-<source hash>.so`` beside the package
(the directory is git-ignored) and loaded with ctypes. The source hash in
the file name means an edited kernel is never served from a stale build.
``build()`` starts one ``nvcc`` per source, all at once, so a cold start
pays for the slowest kernel only.

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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: every kernel source of the port, by name (``csrc/<name>.cu``)
KERNELS = ("estimate_merge", "divide_replicas")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
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
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


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
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(so_path(name))
            _LIBS[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
