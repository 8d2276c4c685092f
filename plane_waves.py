"""Time the control plane's waves on the card for one or more trees.

    python3 plane_waves.py DIR [DIR ...]

Each DIR is a checkout of this repository (``.`` for this one, or a parent
commit unpacked with ``git archive`` into the ignored ``_archive/``). For
each DIR in the order named, one process started in DIR builds that tree's
kernels (the build of an earlier DIR is reused where the sources hash the
same) and runs its ``chip_smoke.run_plane`` on the card at full size:
BASELINE config 4, 10k Deployments x 500 clusters. The process prints the
plane's ``# plane <wave>:`` lines; this script then prints one line per
wave with each run's wall (store apply + settle), its engine passes, the
garbage collector's pauses in it (``gc.callbacks``: seconds and full
collections) and the card's name and power limit. Naming the trees ``P N
N P`` times parent, new, new, parent in one call. Exits non-zero if a run
fails or no card is present.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

RUN = r"""
import gc, json, sys, time, torch
import chip_smoke
from karmada_tpu_torch import native
from karmada_tpu_torch.native import fold
if not torch.cuda.is_available():
    sys.exit("plane_waves: no CUDA device")
native.build()
fold.build()
card = chip_smoke.card_line()
# the garbage collector's pauses (seconds, full collections), summed by wave
paused, started = [0.0, 0], [0.0]
def on_gc(phase, info):
    if phase == "start":
        started[0] = time.perf_counter()
    else:
        paused[0] += time.perf_counter() - started[0]
        paused[1] += info["generation"] == 2
gc.callbacks.append(on_gc)
gc_by = {}
settle = chip_smoke.plane_wave
def plane_wave(tag, *args, **kw):
    before = list(paused)
    out = settle(tag, *args, **kw)
    gc_by[tag] = (paused[0] - before[0], paused[1] - before[1])
    return out
chip_smoke.plane_wave = plane_wave
out = chip_smoke.run_plane(torch.device("cuda", 0), card)
print("PLANE_WAVES " + json.dumps({
    "card": card,
    "walls": {k: w["apply_s"] + w["wall"] for k, w in out["waves"].items()},
    "engine": {k: w["split"]["engine pass"] for k, w in out["waves"].items()},
    "gc": gc_by,
}), flush=True)
"""


def build_dir(tree: str) -> str:
    return os.path.join(tree, "karmada_tpu_torch", "_build")


def main(trees: list[str]) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, tree in enumerate(trees):
        # reuse earlier builds: a library's name hashes its sources
        dst = build_dir(tree)
        for prev in trees[:i]:
            src = build_dir(prev)
            if os.path.isdir(src) and os.path.abspath(src) != os.path.abspath(dst):
                os.makedirs(dst, exist_ok=True)
                for name in os.listdir(src):
                    if name.endswith(".so") and not os.path.exists(os.path.join(dst, name)):
                        shutil.copy2(os.path.join(src, name), dst)
        print(f"# plane_waves: run {i + 1} of {len(trees)} in {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True,
                              text=True, timeout=1800)
        sys.stdout.write("".join(line + "\n" for line in proc.stdout.splitlines()
                                 if line.startswith("# plane")))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            print(f"# plane_waves: run in {tree} failed ({proc.returncode})", flush=True)
            return 1
        line = next(x for x in proc.stdout.splitlines() if x.startswith("PLANE_WAVES "))
        runs.append(json.loads(line[len("PLANE_WAVES "):]))
    waves = list(dict.fromkeys(k for r in runs for k in r["walls"]))
    print("# plane_waves: wave walls (apply + settle, s) by run: "
          + ", ".join(f"{i + 1}={t}" for i, t in enumerate(trees)), flush=True)
    for wave in waves:
        walls = [r["walls"].get(wave) for r in runs]
        engine = [r["engine"].get(wave) for r in runs]
        gc_s = [r["gc"].get(wave) for r in runs]
        print(f"# plane_waves {wave}: walls "
              + " ".join("-" if w is None else f"{w:.4f}" for w in walls)
              + "; engine passes " + " ".join("-" if e is None else f"{e:.4f}" for e in engine)
              + "; garbage collection s (full collections) "
              + " ".join("-" if g is None else f"{g[0]:.4f} ({g[1]})" for g in gc_s)
              + f"; card {runs[0]['card']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
