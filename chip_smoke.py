#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karmada_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (name and power limit), the torch and CUDA versions, and
   builds the port's kernels from ``karmada_tpu_torch/csrc`` (one nvcc per
   source, all at once);
2. kernel phase: holds each kernel against its plain PyTorch version on the
   card, on seeded batches at the north-star chunk (4096 x 5000) and at
   C = 10,000 — K1 ``estimate_merge`` and K2 ``divide_replicas``; equality
   is exact (integer outputs, tolerance 0). Prints each kernel's median time
   beside the plain version's and its byte bound;
3. end-to-end phase: the port's ``TensorScheduler.schedule`` on BASELINE
   configs 1, 2, 4 and 5 at full size (config 5 = the 100k bindings x 5k
   clusters rebalance storm), every row checked against the port's numpy
   divider on the same packed inputs; on config 5 both kernels' launch
   counters must move. Prints wall time per pass and bindings/s;
4. prints one JSON line of per-kernel numbers, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is present or any
phase fails. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the non-tensor-core
#: rate used as the ceiling for scalar integer operations
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
#: integer operations a kernel does per [B, C] element in its plain
#: definition: K1 a merge of 4 compares/selects; K2 the cohort, weight,
#: floor and bonus arithmetic (about 30 selects, compares and adds)
OPS_PER_ELEM = {"estimate_merge": 4, "divide_replicas": 30}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# workloads: BASELINE configs as bench.py builds them, for either package
# --------------------------------------------------------------------------


def build_workload(pkg, config: int, bindings: int | None = None,
                   clusters: int | None = None):
    """(snapshot, problems) of BASELINE config 1, 2, 4 or 5, built with the
    api/builders/scheduler modules of ``pkg`` (karmada_tpu_torch, or any
    package with the same layout): the same seeds and placement mix as
    bench.py ``run_engine_config`` (configs 1-4) and
    ``build_headline_workload`` (config 5). ``bindings``/``clusters`` cut
    configs 4 and 5 below their full 10k x 500 and 100k x 5k."""
    api = importlib.import_module(f"{pkg.__name__}.api")
    b = importlib.import_module(f"{pkg.__name__}.utils.builders")
    q = importlib.import_module(f"{pkg.__name__}.utils.quantity")
    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    req = q.parse_resource_list({"cpu": "250m", "memory": "512Mi"})
    if config in (1, 2):
        fleet = [b.new_cluster(f"member{i}") for i in (1, 2, 3)]
        if config == 1:  # samples/nginx: Duplicated across 3 members
            pl, key, reps = b.duplicated_placement(), "nginx", 2
        else:
            pl = b.static_weight_placement({"member1": 2, "member2": 1, "member3": 1})
            key, reps = "web", 10
        problems = [s.BindingProblem(key=key, placement=pl, replicas=reps,
                                     requests=req, gvk="apps/v1/Deployment")]
        return s.ClusterSnapshot(fleet), problems
    if config == 4:
        fleet = b.synthetic_fleet(clusters or 500, seed=4)
        pl = b.dynamic_weight_placement(
            cluster_affinity=api.ClusterAffinity(
                label_selector=api.LabelSelector(match_labels={"env": "prod"})
            ),
            spread_constraints=[
                api.SpreadConstraint(spread_by_field="region", min_groups=2, max_groups=4),
                api.SpreadConstraint(spread_by_field="cluster", min_groups=2, max_groups=10),
            ],
        )
        problems = [
            s.BindingProblem(key=f"b{i}", placement=pl, replicas=(i % 40) + 1,
                             requests=req, gvk="apps/v1/Deployment")
            for i in range(bindings or 10_000)
        ]
        return s.ClusterSnapshot(fleet), problems
    if config != 5:
        raise ValueError(f"no workload for config {config}")
    c = clusters or 5_000
    n = bindings or 100_000
    snap = s.ClusterSnapshot(b.synthetic_fleet(c, seed=7, taint_fraction=0.08))
    names = snap.names
    tol = api.Toleration(key="fleet.io/dedicated", operator="Exists")
    pl_plain = b.dynamic_weight_placement()
    pl_tol = b.dynamic_weight_placement(cluster_tolerations=[tol])
    profiles = [
        q.parse_resource_list({"cpu": f"{250 * (p + 1)}m", "memory": f"{512 * (p + 1)}Mi"})
        for p in range(8)
    ]
    rng = np.random.default_rng(42)
    replicas = rng.integers(1, 100, n)
    prof_idx = rng.integers(0, 8, n)
    tol_mask = rng.random(n) < 0.30
    has_prev = rng.random(n) < 0.7
    prev_sites = rng.integers(0, c, (n, 8))
    prev_counts = rng.integers(1, 30, (n, 8))
    n_prev = rng.integers(1, 9, n)
    fresh = rng.random(n) < 0.05
    problems = [
        s.BindingProblem(
            key=f"b{i}",
            placement=pl_tol if tol_mask[i] else pl_plain,
            replicas=int(replicas[i]),
            requests=profiles[prof_idx[i]],
            gvk="apps/v1/Deployment",
            prev=(
                {names[prev_sites[i, k]]: int(prev_counts[i, k]) for k in range(n_prev[i])}
                if has_prev[i] else {}
            ),
            fresh=bool(fresh[i]),
        )
        for i in range(n)
    ]
    return snap, problems


# --------------------------------------------------------------------------
# seeded kernel batches
# --------------------------------------------------------------------------


def estimate_batch(rng, b: int, c: int, r: int = 4, u: int = 9) -> dict:
    """K1 inputs: every sentinel path — no-summary clusters (-1), profiles
    requesting nothing (MAX_INT32), zero-replica rows, negative capacity,
    ratios beyond int32."""
    cap = rng.integers(-1000, 1 << 40, (c, r), dtype=np.int64)
    cap[rng.random((c, r)) < 0.05] = -5
    profiles = rng.integers(0, 1 << 12, (u, r), dtype=np.int64)
    profiles[rng.random((u, r)) < 0.3] = 0
    profiles[0] = 0  # requests nothing -> the sentinel clamps to replicas
    profiles[1] = [1, 0, 0, 0][:r] + [0] * max(0, r - 4)  # huge ratios
    return {
        "available_cap": cap,
        "profiles": profiles,
        "prof_idx": rng.integers(0, u, b).astype(np.int32),
        "has_summary": rng.random(c) < 0.9,
        "replicas": np.where(rng.random(b) < 0.1, 0, rng.integers(1, 100, b)).astype(np.int32),
    }


def divide_batch(rng, b: int, c: int) -> dict:
    """K2 inputs: all four strategies; fresh, scale-up, scale-down and steady
    rows; Aggregated rows; zero replicas; all-zero static weights; and a
    slice of rows with near-int32 weights and previous counts."""
    strategy = rng.integers(0, 4, b).astype(np.int32)
    replicas = rng.integers(0, 200, b).astype(np.int32)
    replicas[rng.random(b) < 0.05] = 0
    cand = rng.random((b, c)) < rng.uniform(0.05, 1.0, (b, 1))
    static_w = rng.integers(0, 10, (b, c)).astype(np.int32)
    static_w[rng.random(b) < 0.1] = 0
    avail = rng.integers(0, 400, (b, c)).astype(np.int32)
    prev = np.where(rng.random((b, c)) < 8.0 / c, rng.integers(1, 30, (b, c)), 0).astype(np.int32)
    fresh = rng.random(b) < 0.2
    # steady rows: previous placement summing exactly to replicas
    steady = rng.random(b) < 0.1
    for i in np.flatnonzero(steady):
        sites = np.flatnonzero(cand[i])[:3]
        prev[i] = 0
        if sites.size:
            prev[i, sites] = np.diff(np.linspace(0, replicas[i], sites.size + 1).astype(np.int64))
    big = rng.random(b) < 0.05  # near-int32 weights and counts
    hi = 2**31 - 1
    avail[big] = rng.integers(hi - 1000, hi, (int(big.sum()), c), dtype=np.int64).astype(np.int32)
    static_w[big] = rng.integers(hi - 1000, hi, (int(big.sum()), c), dtype=np.int64).astype(np.int32)
    prev[big] = np.where(rng.random((int(big.sum()), c)) < 0.5, hi - 7, 0).astype(np.int32)
    replicas[big] = rng.integers(hi - 100, hi, int(big.sum())).astype(np.int32)
    return {
        "strategy": strategy, "replicas": replicas, "candidates": cand,
        "static_w": static_w, "avail": avail, "prev": prev, "fresh": fresh,
    }


def to_device(arrays: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def cuda_ms(fn, reps: int = 10, batches: int = 5) -> float:
    """Device milliseconds per call of ``fn()``: CUDA events around
    ``reps`` back-to-back calls (so host-side launch work overlaps the
    device), divided by ``reps``; the median over ``batches`` such runs,
    after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def kernel_bounds(name: str, arrays: dict) -> tuple[float, str]:
    """(bound_ms, bound_by): each input read once and each output written
    once over HBM bandwidth, against the plain definition's integer
    operations over the non-tensor-core peak; the larger wins."""
    if name == "estimate_merge":
        b, c = arrays["prof_idx"].shape[0], arrays["available_cap"].shape[0]
        u, r = arrays["profiles"].shape
        nbytes = sum(a.nbytes for a in arrays.values()) + b * c * 4
        ops = u * c * r + b * c * OPS_PER_ELEM[name]
    else:
        b, c = arrays["candidates"].shape
        nbytes = sum(a.nbytes for a in arrays.values()) + b * c * 4 + b
        ops = b * c * OPS_PER_ELEM[name]
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name: str, arrays: dict, device, reps: int = 10) -> dict:
    """Run kernel ``name`` and its plain version on the card on the same
    inputs, require exact equality, and time both."""
    import torch
    from karmada_tpu_torch import ops

    t = to_device(arrays, device)
    if name == "estimate_merge":
        args = [t[k] for k in ("available_cap", "profiles", "prof_idx", "has_summary", "replicas")]
        kern = lambda: ops.estimate_merge(*args)  # noqa: E731
        plain = lambda: ops.estimate_merge_ref(*args)  # noqa: E731
        outs = lambda r: (r,)  # noqa: E731
    else:
        args = [t[k] for k in ("strategy", "replicas", "candidates", "static_w", "avail", "prev", "fresh")]
        kern = lambda: ops.divide_replicas(*args)  # noqa: E731
        plain = lambda: ops.divide_replicas_ref(*args)  # noqa: E731
        outs = lambda r: (r.assignment, r.unschedulable)  # noqa: E731
    got, want = outs(kern()), outs(plain())
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(diff.max().item()) if diff.numel() else 0)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    ms = cuda_ms(kern, reps)
    plain_ms = cuda_ms(plain, max(3, reps // 3))
    bound_ms, bound_by = kernel_bounds(name, arrays)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# --------------------------------------------------------------------------
# end-to-end phase
# --------------------------------------------------------------------------


def oracle_check(engine, problems, results) -> int:
    """Re-solve every row on the host from the same packed inputs: the
    engine's packing, the numpy estimate, the host spread selection and the
    numpy divider. Returns the number of rows that differ."""
    from karmada_tpu_torch.refimpl import assign_batch_np
    from karmada_tpu_torch.scheduler.spread import select_clusters_batch

    bad = 0
    snap = engine.snapshot
    for start in range(0, len(problems), engine.chunk_size):
        chunk = problems[start : start + engine.chunk_size]
        compiled = [engine._compiled(p.placement) for p in chunk]
        feasible, strategy, replicas, static_w, requests, prev, fresh = (
            engine._pack_chunk(chunk, compiled, 0)
        )
        avail = engine._availability_np(requests, replicas)
        cand = select_clusters_batch(snap, chunk, compiled, 0, feasible, avail, prev)
        assignment, unsched = assign_batch_np(
            strategy, replicas, cand, static_w, avail, prev, fresh
        )
        want = engine._unpack(chunk, compiled, 0, cand, assignment, unsched)
        for got, exp in zip(results[start : start + len(chunk)], want):
            if (got.key, got.clusters, got.error, got.feasible) != (
                exp.key, exp.clusters, exp.error, exp.feasible
            ):
                bad += 1
    return bad


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chunk_breakdown(engine, problems, device) -> dict:
    """Host-clock seconds of each stage of ``_schedule_chunk`` on the first
    chunk of ``problems``, synchronising the card after each device stage:
    pack (numpy masks), estimate (uploads + K1), select, assign (uploads +
    kernel_variant's max + K2), fetch (result to host), unpack."""
    from karmada_tpu_torch.scheduler.spread import select_clusters_batch

    chunk = problems[: engine.chunk_size]
    compiled = [engine._compiled(p.placement) for p in chunk]
    out = {}
    t0 = time.perf_counter()
    feasible, strategy, replicas, static_w, requests, prev, fresh = (
        engine._pack_chunk(chunk, compiled, 0)
    )
    out["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    avail = engine._availability(requests, replicas)
    sync(device)
    out["estimate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand = select_clusters_batch(engine.snapshot, chunk, compiled, 0, feasible, avail, prev)
    out["select"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = engine._assign(strategy, replicas, cand, static_w, avail, prev, fresh)
    sync(device)
    out["assign"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assignment = res.assignment.cpu().numpy()
    unsched = res.unschedulable.cpu().numpy()
    out["fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine._unpack(chunk, compiled, 0, cand, assignment, unsched)
    out["unpack"] = time.perf_counter() - t0
    return out


def run_config(config: int, device, card: str, passes: int = 3,
               bindings: int | None = None, clusters: int | None = None) -> dict:
    import karmada_tpu_torch
    from karmada_tpu_torch import ops
    from karmada_tpu_torch.scheduler import TensorScheduler

    t0 = time.perf_counter()
    snap, problems = build_workload(karmada_tpu_torch, config, bindings, clusters)
    build_s = time.perf_counter() - t0
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    ops.estimate_merge.launches = 0
    ops.divide_replicas.launches = 0
    t0 = time.perf_counter()
    results = engine.schedule(problems)  # the main path: one full pass
    sync(device)
    first_s = time.perf_counter() - t0
    launches = {
        "estimate_merge": ops.estimate_merge.launches,
        "divide_replicas": ops.divide_replicas.launches,
    }
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        again = engine.schedule(problems)
        sync(device)
        walls.append(time.perf_counter() - t0)
    if [(r.clusters, r.error) for r in again] != [(r.clusters, r.error) for r in results]:
        raise AssertionError(f"config {config}: passes disagree")
    stages = None
    if len(problems) * snap.num_clusters > 1 << 16:
        stages = chunk_breakdown(engine, problems, device)
        print(f"# config {config} stages of one {min(len(problems), engine.chunk_size)}-row "
              "chunk (s): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
              + f"; card {card}", flush=True)
    t0 = time.perf_counter()
    bad = oracle_check(engine, problems, results)
    check_s = time.perf_counter() - t0
    ok = sum(r.success for r in results)
    wall = statistics.median(walls)
    print(
        f"# config {config}: {len(problems)} bindings x {snap.num_clusters} clusters; "
        f"{ok} scheduled; first pass {first_s:.3f} s; pass p50 {wall:.4f} s "
        f"(walls {[round(w, 4) for w in walls]}); {len(problems) / wall:.0f} bindings/s; "
        f"launches {launches}; numpy-divider check {len(problems) - bad} ok / {bad} bad "
        f"({check_s:.1f} s); build {build_s:.1f} s; card {card}",
        flush=True,
    )
    if bad:
        raise AssertionError(f"config {config}: {bad} rows differ from the numpy divider")
    return {"config": config, "bindings": len(problems), "clusters": snap.num_clusters,
            "pass_s": wall, "walls": walls, "first_pass_s": first_s,
            "bindings_per_s": len(problems) / wall, "launches": launches,
            "stages": stages}


KERNELS = {
    "estimate_merge": ("karmada_tpu_torch/csrc/estimate_merge.cu", "karmada_tpu/ops/estimate.py:25"),
    "divide_replicas": ("karmada_tpu_torch/csrc/divide_replicas.cu", "karmada_tpu/ops/divide.py:233"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card only",
              file=sys.stderr)
        return 1
    from karmada_tpu_torch import native

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = native.build()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)

    rng = np.random.default_rng(SEED)
    stats = {}
    # the main path's chunk (U = 9 profiles: the shared-table branch of K1),
    # then the 10k-cluster tier with U = 300 (K1's direct branch)
    for b, c, u in ((4096, 5000, 9), (4096, 10_000, 300)):
        batches = (("estimate_merge", estimate_batch(rng, b, c, u=u)),
                   ("divide_replicas", divide_batch(rng, b, c)))
        for name, arrays in batches:
            st = check_kernel(name, arrays, device)
            print(f"# kernel {name} {b}x{c}: exact; {st['ms']:.4f} ms (plain "
                  f"{st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms by "
                  f"{st['bound_by']}); card {card}", flush=True)
            if (b, c) == (4096, 5000):
                stats[name] = st

    print("# config 3 (Aggregated + ResourceModels) needs the resource-model "
          "estimator, not ported yet: skipped", flush=True)
    runs = {cfg: run_config(cfg, device, card) for cfg in (1, 2, 4, 5)}
    launches = runs[5]["launches"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"config 5 never launched {name}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"], "ms": stats[name]["ms"],
         "plain_ms": stats[name]["plain_ms"], "bound_ms": stats[name]["bound_ms"],
         "bound_by": stats[name]["bound_by"], "library_ms": None}
        for name in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
