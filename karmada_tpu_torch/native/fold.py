"""Host wire runtime of the fleet path: the byte-wire decoders and the
entry-mirror folds, compiled from ``csrc/fold.c``.

Counterpart of ``karmada_tpu/native`` (``le32``, ``decode2``, ``decode3``,
``decode21``, ``fold_entries``, ``apply_deltas``). The C source is built on
first use with the host compiler (``g++ -O2 -shared -fPIC``) into the
package's git-ignored ``_build/``, keyed by source hash like the CUDA
builds, and loaded with ctypes. A failed build raises: unlike the JAX
module, the port has no silent numpy fallback on its hot path. The numpy
forms (``*_np``) are kept beside each loop as the reference the tests hold
the compiled loops to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from . import BUILD_DIR, CSRC

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def so_path() -> str:
    src = os.path.join(CSRC, "fold.c")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfold-{digest}.so")


def build() -> float:
    """Compile ``csrc/fold.c`` unless a current build exists. Returns the
    wall seconds spent (0.0 when already built); raises with the
    compiler's output on failure."""
    import time

    out = so_path()
    if os.path.exists(out):
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, os.path.join(CSRC, "fold.c")],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"fold.c build failed (g++ exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic under concurrent builders
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            build()
            so = ctypes.CDLL(so_path())
            i64 = ctypes.c_int64
            p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            for name, args in (
                ("decode3", [p_u8, i64, p_i32]),
                ("decode2", [p_u8, i64, p_i32]),
                ("decode21", [p_u8, i64, p_i32]),
                ("fold_entries", [p_i32, i64, p_i32, p_i64, i64, p_i32]),
                ("apply_deltas", [p_i32, i64, p_i32, p_i64, i64, p_i32, p_i32]),
            ):
                fn = getattr(so, name)
                fn.argtypes = args
                fn.restype = None
            _LIB = so
    return _LIB


def _u8(raw: np.ndarray) -> np.ndarray:
    raw = np.asarray(raw)
    if raw.dtype != np.uint8:
        raise ValueError(f"wire buffers are uint8, got {raw.dtype}")
    return np.ascontiguousarray(raw)


def _mirror(mirror: np.ndarray) -> None:
    if mirror.dtype != np.int32 or mirror.ndim != 2 or not mirror.flags["C_CONTIGUOUS"]:
        raise ValueError("the entry mirror must be a C-contiguous int32[cap, k_res]")


def le32(raw: np.ndarray) -> int:
    """First 4 bytes as a little-endian int (the wire's total header)."""
    return (
        int(raw[0]) | (int(raw[1]) << 8)
        | (int(raw[2]) << 16) | (int(raw[3]) << 24)
    )


def decode3(raw: np.ndarray) -> np.ndarray:
    """uint8[3n] little-endian packed entries -> int32[n]."""
    raw = _u8(raw)
    n = len(raw) // 3
    out = np.empty(n, np.int32)
    lib().decode3(np.ascontiguousarray(raw[: 3 * n]), n, out)
    return out


def decode2(raw: np.ndarray) -> np.ndarray:
    """uint8[2n] little-endian meta words -> int32[n]."""
    raw = _u8(raw)
    n = len(raw) // 2
    out = np.empty(n, np.int32)
    lib().decode2(np.ascontiguousarray(raw[: 2 * n]), n, out)
    return out


def decode21(raw: np.ndarray, n: int) -> np.ndarray:
    """21-bit little-endian bitstream -> int32[n]; ``raw`` must extend at
    least 3 bytes past the packed payload (the device wire pads)."""
    raw = _u8(raw)
    if n and len(raw) < ((21 * (n - 1)) >> 3) + 4:
        raise ValueError("decode21: buffer shorter than the padded payload")
    out = np.empty(n, np.int32)
    lib().decode21(raw, n, out)
    return out


def fold_entries(
    mirror: np.ndarray,  # int32[cap, k_res] C-contiguous
    rows: np.ndarray,  # per changed row (any int dtype)
    counts: np.ndarray,  # entries per row
    stream: np.ndarray,  # int32 concatenated runs, row order
) -> None:
    """Scatter entry runs into the host mirror, zero-filling each row's
    tail; a run longer than k_res is clamped to it. In place."""
    _mirror(mirror)
    counts = np.ascontiguousarray(counts, np.int64)
    stream = np.ascontiguousarray(stream, np.int32)
    if int(counts.sum()) > len(stream):
        raise ValueError("fold_entries: stream shorter than the counts")
    lib().fold_entries(
        mirror, mirror.shape[1], np.ascontiguousarray(rows, np.int32),
        counts, len(counts), stream,
    )


def apply_deltas(
    mirror: np.ndarray,  # int32[cap, k_res] C-contiguous
    rows: np.ndarray,  # per delta row (any int dtype)
    dcounts: np.ndarray,  # deltas per row
    stream: np.ndarray,  # int32 (site<<9 | newcount+1), row order,
    # site-ascending within each row
) -> None:
    """Merge cell deltas into the mirror's sorted entry runs (newcount 0
    removes the site, otherwise set or insert); merged rows are clamped to
    k_res entries like ``fold_entries``. In place."""
    _mirror(mirror)
    dcounts = np.ascontiguousarray(dcounts, np.int64)
    stream = np.ascontiguousarray(stream, np.int32)
    if int(dcounts.sum()) > len(stream):
        raise ValueError("apply_deltas: stream shorter than the counts")
    scratch = np.empty(mirror.shape[1], np.int32)
    lib().apply_deltas(
        mirror, mirror.shape[1], np.ascontiguousarray(rows, np.int32),
        dcounts, len(dcounts), stream, scratch,
    )


# --------------------------------------------------------------------------
# numpy reference forms (tests only)
# --------------------------------------------------------------------------


def decode3_np(raw: np.ndarray) -> np.ndarray:
    n = len(raw) // 3
    e = raw[: 3 * n].astype(np.int32)
    return e[0::3] | (e[1::3] << 8) | (e[2::3] << 16)


def decode2_np(raw: np.ndarray) -> np.ndarray:
    n = len(raw) // 2
    m = raw[: 2 * n].astype(np.int32)
    return m[0::2] | (m[1::2] << 8)


def decode21_np(raw: np.ndarray, n: int) -> np.ndarray:
    bit = np.arange(n, dtype=np.int64) * 21
    byte = bit >> 3
    sh = (bit & 7).astype(np.uint32)
    b = raw.astype(np.uint32)
    u32 = b[byte] | (b[byte + 1] << 8) | (b[byte + 2] << 16) | (b[byte + 3] << 24)
    return ((u32 >> sh) & 0x1FFFFF).astype(np.int32)


def fold_entries_np(mirror, rows, counts, stream) -> None:
    total = int(counts.sum())
    mirror[rows] = 0
    flat_rows = np.repeat(rows, counts)
    starts = np.cumsum(counts) - counts
    cols = np.arange(total) - np.repeat(starts, counts)
    ok = cols < mirror.shape[1]
    mirror[flat_rows[ok], cols[ok]] = stream[:total][ok]


def apply_deltas_np(mirror, rows, dcounts, stream) -> None:
    k_res = mirror.shape[1]
    off = 0
    for r, nd in zip(rows, dcounts):
        nd = int(nd)
        d = stream[off : off + nd]
        off += nd
        if not nd:
            continue
        sites = {int(v) >> 8: int(v) & 0xFF for v in mirror[r] if v != 0}
        for v in d:
            v = int(v)
            site, cnt = v >> 9, (v & 0x1FF) - 1
            if cnt > 0:
                sites[site] = cnt
            else:
                sites.pop(site, None)
        merged = [(s << 8) | c for s, c in sorted(sites.items())][:k_res]
        mirror[r] = 0
        mirror[r, : len(merged)] = merged
