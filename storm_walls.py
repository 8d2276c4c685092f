"""Time the config-5 storm and general phases on the card for one or more trees.

    python3 storm_walls.py DIR [DIR ...]

Each DIR is a checkout of this repository (``.`` for this one, or a parent
commit unpacked with ``git archive`` into the ignored ``_archive/``). For
each DIR in the order named, one process started in DIR builds that tree's
kernels (the build of an earlier DIR is reused where the sources hash the
same) and runs its ``chip_smoke`` storm and general phases on the card at
full size, as ``chip_smoke.main`` runs them: ``run_fleet_storm`` (config 5,
100k bindings x 5000 clusters: cold, steady and churn passes, each checked)
and ``run_general`` over its first 40,000 rows. The process prints the
phases' own ``# config 5`` lines; this script then prints, per run, the
storm's cold, steady and churn pass walls, the general pass wall, each
phase's whole wall (its builds and numpy checks included) and the card's
name and power limit. Naming the trees ``P N N P`` times parent, new, new,
parent in one call: a tree whose storm orders its clusters by name against
one that keeps bench.py's build order. Exits non-zero if a run fails or no
card is present.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

RUN = r"""
import json, sys, time, torch
import chip_smoke
from karmada_tpu_torch import native
from karmada_tpu_torch.native import fold
if not torch.cuda.is_available():
    sys.exit("storm_walls: no CUDA device")
native.build()
fold.build()
card = chip_smoke.card_line()
device = torch.device("cuda", 0)
t0 = time.perf_counter()
storm = chip_smoke.run_fleet_storm(device, card)
storm_phase = time.perf_counter() - t0
cold_out = storm["cold_out"]
walls = {k: storm[k] for k in ("cold_s", "steady_s", "churn_s")}
del storm
t0 = time.perf_counter()
general = chip_smoke.run_general(device, card, cold_out, rows=40_000)
print("STORM_WALLS " + json.dumps({
    "card": card, "storm_phase": storm_phase, **walls,
    "general_pass": general["pass_s"],
    "general_phase": time.perf_counter() - t0,
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
        print(f"# storm_walls: run {i + 1} of {len(trees)} in {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True,
                              text=True, timeout=1800)
        sys.stdout.write("".join(line[:400] + "\n" for line in proc.stdout.splitlines()
                                 if line.startswith("# config 5")))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-8000:])
            print(f"# storm_walls: run in {tree} failed ({proc.returncode})", flush=True)
            return 1
        line = next(x for x in proc.stdout.splitlines() if x.startswith("STORM_WALLS "))
        runs.append(json.loads(line[len("STORM_WALLS "):]))
    print("# storm_walls: walls (s) by run: "
          + ", ".join(f"{i + 1}={t}" for i, t in enumerate(trees)), flush=True)
    for key in ("cold_s", "steady_s", "churn_s", "storm_phase", "general_pass",
                "general_phase"):
        print(f"# storm_walls {key}: " + " | ".join(json.dumps(r[key]) for r in runs)
              + f"; card {runs[0]['card']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
