"""The shared harness of the port's kernel timing scripts
(``k12_k15_variants.py``, ``k8_k14_variants.py``, ``k1_k13_variants.py``):
each names its kernels,
their source forms, the text edits that make a form's phase-split copies,
its shapes and its callers as data, and this module builds, calls and times
them.

- ``start`` reads the source directories named on the command line (default
  the port's own ``karmada_tpu_torch/csrc``; another checkout's, such as a
  parent commit's unpacked with ``git archive`` into the ignored
  ``_archive/``, can be named beside it). A directory named twice is built
  once and timed each time it is named, so ``P N N P`` gives parent, new,
  new, parent in one call.
- ``variants`` applies a form's edits to its source, each edit required to
  match once.
- ``build`` compiles every variant of every directory with the port's own
  ``nvcc`` flags, all at once, the directory on the include path, and loads
  each with ctypes (argument letters as in ``native.SIGNATURES``).
- ``entry`` wraps a loaded entry point as a call on the current stream.
- ``time_row`` holds each directory's build to the plain version, exactly,
  then times each (CUDA events behind a device spin, ``chip_smoke.cuda_ms``)
  in the order named.
- ``profiled`` sums one call's device time by kernel name under
  torch.profiler.

``launch_floors`` builds the launch floors (an empty kernel appended to a
kernel's source).

Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "karmada_tpu_torch", "csrc")


def start(argv: list, tag: str):
    """(device, card, named, dirs): the card and the directories named, in
    order (``named``) and each once (``dirs``); None without a card."""
    import torch

    if not torch.cuda.is_available():
        print(f"{tag}: no CUDA device", file=sys.stderr)
        return None
    card = cs.card_line()
    named = [os.path.abspath(d) for d in (argv or [CSRC])]
    print(f"# card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"directories {named}", flush=True)
    return torch.device("cuda", 0), card, named, list(dict.fromkeys(named))


def source(d: str, name: str) -> str:
    with open(os.path.join(d, f"{name}.cu")) as f:
        return f.read()


def variants(tag: str, name: str, src: str, edits: dict) -> dict:
    """variant -> ``src`` with each of its (old, new) text edits applied in
    turn; every ``old`` must occur exactly once."""
    out = {}
    for var, pairs in edits.items():
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{tag}: {name} no longer holds {old!r} once")
            text = text.replace(old, new)
        out[var] = text
    return out


def build(tag: str, sources: dict, tmp: str, ptxas: bool = False) -> dict:
    """Compile ``sources`` ((dir, kernel, variant) -> source text), every
    nvcc at once, each with its directory on the include path; returns
    (dir, kernel, variant) -> ctypes library. With ``ptxas``, the register
    and spill lines of each whole kernel are printed."""
    from karmada_tpu_torch import native

    procs = {}
    for k, ((d, name, var), text) in enumerate(sources.items()):
        src = os.path.join(tmp, f"{name}-{k}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = src[:-3] + ".so"
        cmd = [native.nvcc(), *native.NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas else ()),
               "-I", d, "-o", so, src]
        procs[(d, name, var)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (d, name, var), (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed on {d} {name} {var}:\n{log}")
        if ptxas and var == "whole":
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"# ptxas {name} ({d}): {line.strip()}", flush=True)
        libs[(d, name, var)] = ctypes.CDLL(so)
    return libs


def entry(lib, fname: str, letters: str, device):
    """``lib``'s entry point ``fname`` (C arguments ``letters`` before the
    stream) as a function of tensors and ints that launches on the current
    stream of ``device`` and raises on an error."""
    import torch
    from karmada_tpu_torch import native

    fn = getattr(lib, fname)
    fn.argtypes = [native._CTYPES[c] for c in letters] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(*args):
        vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = fn(*vals, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"{fname}: launch refused, error {err}")
    return run


def time_row(name: str, label: str, calls: dict, want, named: list, forms: dict,
             card: str) -> dict:
    """Hold each directory's call (``calls``: dir -> function, or an
    exception it refused with) to ``want``, exactly, then time the held ones
    in the order ``named``; prints a line each and returns the row."""
    held = {}
    for d, call in calls.items():
        if isinstance(call, Exception):
            continue
        try:
            cs.compare(f"{name} {label} ({d})", call(), want)
            held[d] = call
        except RuntimeError as e:
            calls[d] = e
    row = {"kernel": name, "shape": label, "ms": []}
    for d in named:
        ms = cs.cuda_ms(held[d]) if d in held else None
        row["ms"].append({"dir": d, "form": forms[d], "ms": ms})
        print(f"# {name} {label}: {forms[d]} form ({d}): "
              + (f"{ms:.4f} ms, exact" if ms is not None else f"refused: {calls[d]}")
              + f"; card {card}", flush=True)
    row["held"] = held
    return row


def profiled(fn) -> dict:
    """Device milliseconds of one call of ``fn`` by kernel name (memsets
    included), from torch.profiler; empty if it saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for _ in range(2):  # a trace that caught nothing, once more
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
                name = name.split("(")[0].split("<")[0].split("::")[-1]
                n, ms = out.get(name, (0, 0.0))
                out[name] = (n + e.count, ms + us / 1e3)
        if out:
            break
    return out


def write(results: dict, stem: str) -> None:
    """``results`` (less each row's calls) to ``chiprun_out/<stem>.json``."""
    for row in results.get("times", ()):
        row.pop("held", None)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{stem}.json"), "w") as f:
        json.dump(results, f, indent=1)
