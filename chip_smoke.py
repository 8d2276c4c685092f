#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karmada_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (name and power limit), the torch and CUDA versions, and
   builds the port's kernels from ``karmada_tpu_torch/csrc`` (one nvcc per
   CUDA source, all at once, and g++ for the host wire runtime ``fold.c``);
2. kernel phase: holds K1 ``estimate_merge`` against its plain PyTorch
   version on the card on seeded batches at the north-star chunk (4096 x
   5000) and at C = 10,000; K2 ``divide_replicas`` at 4096 x 5000, 4096 x
   10,000, 1024 x 16,385 and 256 x 40,000 (seeded) and on its selection's
   edge cases (``divide_edge_batch``: ties, INT32_MIN, a remainder one
   less than the positive weights, Aggregated cuts inside equal-weight
   groups and wrapped negative weights) at 512 x 5000, 64 x 16,385, 16 x
   40,000 and 64 x 1 and 2, and prints its phase split (clock64 per block
   and pass, ``k2_phase_split``) at 4096 x 5000; K1's table form
   ``profile_table`` at U = 8 x 5000 (beside its launch floor: an empty
   kernel at its grid), K1's merge form
   ``estimate_merge_table`` at 4096 x 5000 with 0, 1, 2, 5 and 9 extra
   estimates, K1's three forms on their edge batches
   (``estimate_edge_batch``: divisors 1, 2, 3, 7, 2^k and 2^k +- 1, 2^40,
   2^63 - 1; capacities at INT64_MIN, -1, 0, UNLIMITED - 1, UNLIMITED,
   INT64_MAX and beside multiples of the divisors; C 1 to 16,385 and a
   misaligned view; U 1, 64, 65; negative and out-of-range profile indices;
   every row at zero replicas; E 0, 1, 4, 5, 32, 33), K17 ``first_fit_group`` on a seeded ranked chunk (4096 x 3
   terms x 5000, also with ``with_base`` off) and on its edge cases
   (``group_edge_batch``: T = 1, 4 and 9, C from 1 to 16,385),
   K8 ``node_sum_estimate`` at 4096 profile rows x 5000 nodes and 8 x 4000
   (each beside its launch floor: an empty kernel at K8's grid and cluster
   shape, timed the same way) and on its edge batches
   (``node_edge_batch``: divisors 1, 2, 3, 7, 2^k and 2^k +- 1, large
   primes, 2^63 - 1; dividends at and beside their multiples, 2^62 - 1,
   2^63 - 1, negatives; rows requesting nothing, filtering every node,
   wrapping the int64 sum, tying two dims; N 1 to 16,385, B 1 to 4096, R 1
   to 41), K12
   ``quota_admit`` at 131072 rows x 32 namespaces with 4, 17 and 40 dims
   and x 1, 1024 and 4096 namespaces with 4, and on its edge batches
   (``admit_edge_batch``: B = 1, ragged, N = 0 and 1, unquota'd and
   out-of-range ids, runs across and along the tiles, 2^17 clamp-sized
   rows, remaining 0 and UNLIMITED, a denied row's place in line, R = 1,
   16, 17 and 40), K13's per-row form ``quota_cluster_caps`` at 4096 x
   5000 and on its edge batches (``caps_edge_batch``: the same divisors;
   caps at INT64_MIN, -1, 0, UNLIMITED - 1, UNLIMITED, INT64_MAX, beside
   multiples of the divisors and with quotients below -2^31; C 1 to 16,385
   and a misaligned view; ids -1, past N, one namespace for every row; R
   1, 4, 17, 41), K14 ``explain_pass`` at 4096 x 5000 (a batch full of key ties)
   and at C = 5, and on its edge batches (``explain_edge_batch``: C 1 to
   16,385 about the 16-cell step, k 1 to 8, rows at every offset mod 16,
   tied keys, keys that wrap int64, fewer than k non-zero keys, padding
   rows; one batch also through misaligned views), and K15
   ``preempt_select`` at 131072 rows (R = 4 and 17,
   C = 5000, 16 priority classes, ~30% victims, ~5% demanders) and on its
   edge batches (``preempt_edge_batch``: no victims, no demanders, equal
   keys, wrapping keys, b_key above B, B = 1 and 2^17, weights out of
   range, rows that free nothing, R = 1, 16, 17 and 40); K3 (both forms), K4 (phase A and
   the entry rows) and K16 (both forms) on the fleet edge batches
   (``fleet_edge_tables``: duplicate, wrapping and negative previous
   counts, padding rows, sites outside [0, C), k_prev 1, 32 and 128, C from
   1 to 5000; cold, steady and churn residents, all-rows and partial
   batches; ``check_entry_edges``: K16 at k_out 1 and 128 with a row named
   twice, the entry rows over odd and even rows with counts up to 255),
   K3 on a seeded 4096 x 5000 batch, and K5's two wires on the 33
   ``wire_edge_batch`` cases (``check_wire_edges``); equality is
   exact (integer outputs, tolerance 0). Prints each kernel's median time
   beside the plain version's and its bound (CUDA events behind a device
   spin, so the wrappers' host work is not timed). Then the shapes past
   the kernels' old limits, served: K1 at 65535 x 128 + 1 rows (past the
   first slice's one grid) in its three forms against the plain versions, an engine at 16,385 clusters scheduling 2000
   config-5 bindings through the fleet (every row against the numpy
   divider), a 17-dim quota wave (``wide_quota_scene``) whose
   partition equals ``admit_wave_np`` and whose admitted rows equal the
   numpy divider, and a 17-dim preemption wave (``preemption_scene`` with
   13 extended resources: 2000 residents x 500 clusters, a 100-row surge)
   that launches K15 once and whose victims and placements equal
   ``preempt_and_place_np``;
3. end-to-end phase, every row checked against the port's numpy divider on
   the same packed inputs (``oracle_check``, solved by forked worker
   processes, one a core):
   - BASELINE configs 1 and 2 (host-small numpy path), 3 (resource models
     on the host-small numpy path; no kernel may launch) and 4 (10k x 500,
     spread rows riding the fleet through derived selections);
   - config 5, the 100k bindings x 5k clusters storm, through the fleet
     table: one cold pass, 3 steady passes (the batch-identity route) and 3
     churn passes (every cluster's allocation drifts, bench.py's recipe);
     every row checked after the cold and the last churn pass; a traced
     steady, churn and cold pass (the cold one on a new engine, equal to the
     last churn pass) give the device time by kernel. Before the
     first churn pass it holds K3 (both forms; the masks form also at
     k_prev = 128 and in one launch over all 102,400 rows), K2 (on the
     first chunk's inputs, with its phase split), K4 (both stages), K5
     (the phase-A wire on a steady and on this churn pass's outputs, the
     entry wire on the churn's phase-B entries; each entry point's device
     operations under the profiler, and none a concatenation in a whole
     ``fleet_pass``) and K6 (both entry points) against their plain
     versions on the table's own inputs at config-5 shapes (exact), and
     times them;
   - the same storm on the entry-resident route (``KARMADA_TPU_DENSE_BUDGET=0``
     around the table's construction; 2 steady and 2 churn passes): every
     pass equal to the dense storm's row for row, the oracle after the cold
     and the last churn pass, an overflow rerun on the first churn pass,
     K16 against its plain version in both forms, the whole pass against
     ``fleet_solve_ref`` byte for byte (no concatenation in it) and K5's
     entry wire on the pass's own entries, metas in place, before the
     first churn pass;
   - a mixed-strategy fleet phase (10k x 1000: the four strategies,
     zero-replica, fresh and previous-site rows), whose second pass makes a
     few hundred rows dirty: every row equal to the port's general path on
     the card (a second engine with ``fleet_threshold`` raised); then the
     same phase on the entry-resident route with a permuted third pass (the
     gathered form), every row equal to the dense phase's;
   - config 5 on the general path (the first slice's route: K1 + K2), its
     first 40k rows in one pass, every row equal to the fleet's cold pass;
   - config 5 again under Karmada's nine default resource-model grades:
     the storm as above with two steady and two churn passes (K7 in every
     table rebuild, held to its plain
     version on the table's inputs and on a seeded U = 64 batch), then one
     20k-row pass on the general path
     (K1 table form, K7 overlay, K1 merge form, K2);
   - the in-process accurate estimator: 128 clusters of 4000 seeded nodes
     behind an ``EstimatorRegistry``, 10k bindings through
     ``extra_estimators``; cold, steady, hard-refresh and pod-event passes
     must launch K8 128, 0, 128 and 4 times and leave no registered
     cluster unanswered or unmemoized; the cold and pod-event passes are checked against
     the numpy divider over merge(general, the node-sum numpy mirror);
   - the quota plane (bench.py ``run_quota``'s recipe at the engine):
     config 5 in 32 namespaces, one FederatedResourceQuota each, four of
     them capping cluster 0; cold, steady (replay), surge, raise and delta
     passes on the fleet route must launch K12 1, 0, 1, 1 and 1 times, and
     every partition equals the sequential ``admit_wave_np``; admitted rows
     equal the numpy divider on cap-folded availability; then 20k rows on
     the general route (K12, K13's per-row form, K1's merge form), equal to
     the fleet's. K12 is held to its plain version at B = 131072, N = 32,
     K13 at 4096 x 5000 and (fold form) on the quota table;
   - the ranked multi-term path: 10k rows with three ClusterAffinities
     groups over the config-5 fleet, half in namespaces capping 600
     clusters; every row equal to the ordered-failover referent, some on a
     fallback group; K17 held to its plain version on each of the cell's
     chunks, and a chunk's stages timed (``ranked_breakdown``);
   - provenance: the config-5 storm engine takes one steady pass disarmed
     and one with an ExplainStore armed (one K14 launch per chunk: 25), and
     the quota cell's surge wave is replayed armed (every denied row
     carries the QuotaExceeded bit); every chunk's K14 output equals its
     plain version on the same device inputs (``held_to_plain``), each
     capture's first chunk equals it on the composed inputs and a 64-row
     sample of every capture equals the numpy referent ``explain_batch_np``;
   - preemption (bench.py ``run_preemption``'s scene at the engine): 100k
     priority-0 residents on config 5's 5000 clusters in 64 label groups,
     cpu then saturated exactly, and a surge of 1000 priority-100 rows: one
     K15 launch over 101,000 rows (padded to 2^17), the boosted re-solve's
     group selection on K17, victims and placements equal to
     ``preempt_and_place_np``, K15 equal to its plain
     version on the pass's own inputs; then the residents' steady pass with
     the plane armed and disarmed.
   - the scheduler process (``run_controller``): a ``Store`` and a
     ``Runtime`` driving the port's ``SchedulerController`` from
     ResourceBinding events to written placements (``binding_objects``
     builds every object; each binding round-trips to its recipe problem):
     config 5's 100k bindings x 5000 clusters in a cold wave (every written
     placement equal to the storm's cold pass on the controller's cluster
     order and to the numpy divider), a settle with nothing to do and a
     resync that gates everything out (no engine pass), a 1000-row scale
     wave, a drift round of the ``ContinuousDescheduler`` at its default
     budget (the trigger set equal to ``rebalance_np``'s, exactly those
     bindings rescheduled), the quota cell's recipe at 20k rows (partitions
     equal to ``admit_wave_np``; a raise re-enqueues exactly the raised
     namespace's denied bindings) and the preemption scene at 20k residents
     (victims, eviction tasks and placements equal to
     ``preempt_and_place_np``); each wave's wall split into store apply,
     gate and problem build, engine pass and write-back, and the
     controller's share. K3, K2, K4 and K5 must launch in the cold wave,
     K12 in the quota wave and K15 in the preemption surge.
   - the solver sidecar's in-process seams (the card's machine has neither
     grpc nor protobuf; tier-1 holds the wire): ``run_sidecar`` drives
     config 5 through a port ``SolverService``'s protobuf-free core
     (``InProcessSolver``: placements as canonical JSON, rows as records):
     sync, a cold request, the same request, a request at a stale version
     (must raise ``StaleSnapshotError``), a re-sync and the same request,
     bench.py's drift synced and the same request; every row equal to the
     config-5 fleet phase's numpy-checked cold or last pass (that phase,
     the general pass and the estimator phase run in name order, the
     sidecar's), each request's wall split into the client's encode, the
     sidecar's decode, engine and encode, the client's decode. K1's table
     form, K2, K3 and K4 must launch. ``run_sidecar_estimator`` serves the
     estimator phase's own node caches from 4 ``MultiClusterEstimatorService``s
     of 32 clusters behind ``EstimatorConnection``s to the estimator-aware
     sidecar (``solver.__main__.estimator_service``): cold, quiet and
     pod-event passes with batch RPCs 4 / 0 / 4, pings 0 / 4 / 4, K8
     launches 128 / 0 / 4, every cluster answered and memoized, every row
     equal to the estimator phase's. ``run_sidecar_controller``: config 4
     under ``SchedulerController(solver=...)``, a cold wave on the
     sidecar, a scale wave while it is down (the in-process fallback on
     the card, one degraded pass) and one after (a re-sync first), every
     wave's placements held by ``written_check``.
   - the control plane's propagation path (``run_plane``): the port's
     ``ControlPlane`` on BASELINE config 4 (10k Deployments x 500 member
     clusters whose NodeStates sum to the recipe's summaries, config 4's
     PropagationPolicy and a registry OverridePolicy on one region): join
     (every Cluster Ready with its recipe summary), a cold wave (every
     binding equal to the numpy divider on the plane's own engine
     snapshot, one Work per placed cluster, every member holding exactly
     its Deployments with the divided replicas and the override's image on
     its region), a status round (status back to every template), a
     1000-template scale wave (one engine pass over exactly them, no other
     Work written again) and a 1000-template delete wave (their bindings,
     Works and member objects gone, nothing else touched); each wave's wall
     split into store apply, detector, scheduler gate, engine pass, binding
     render, execution apply and status collection. K1's table form, K3,
     K2, K4 and K5 must launch in the cold wave. Then the failover path on
     the same plane (``plane_failover_waves``, injected clock, Failover
     gate on): 25 of the 500 clusters killed through the chaos seam
     (``cluster.health=down``, seed 7; one of them among the 10 clusters
     that host bindings) and every displaced binding re-solved
     to the numpy divider with its killed clusters evicted (the rows whose
     eviction task is already done ride the fleet table, the others the
     general route: K1's table and general forms, K2, K3, K4, K5 and K6
     must launch), the eviction drain (every eviction task done, the killed
     clusters' Works and member objects gone), a descheduler round over 200
     bindings with unschedulable pods (seed 11; each shrunk and re-solved to
     the numpy divider on the general route, K1 and K2 launched, nothing
     else moved) and the recovery (every killed
     cluster Ready and untainted); then the autoscaling, networking and
     resume waves on the same plane (``plane_autoscale_waves``): 1000
     FederatedHPAs (seed 7) on aggregate member samples, each template at
     the HPA rule and the 800 rescaled rows in one pass to the numpy
     divider (the fleet route: K1's table form, K2-K5), 200 more held by
     their 300 s window and then scaled down in one general-route pass (K1,
     K2), 500 CronFederatedHPAs firing at 09:00 UTC in one fleet pass, 50
     exported services with MultiClusterServices to 4 consumers each and
     20 MultiClusterIngresses (seed 13) dispatched and torn down with no
     engine pass, and the store checkpointed and resumed into a new plane
     over the same members built with the drift rebalancer (every binding
     and member object kept; its first drift round dry-solves every
     binding on the resumed scheduler's new engine, K1's table form and
     K2-K5, each row to the numpy divider, and the settle re-places the
     rows it stamps); and a small Pull-mode plane
     (``run_pull_plane``: agents apply Works and report status, a stopped
     agent's cluster degrades only past ``lease_grace_seconds``).
   Each path sets the launch counters to 0 just before it and reads them
   just after; every kernel of the path must have launched.
4. prints one JSON line of per-kernel numbers, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is present or any
phase fails. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
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


def with_default_models(pkg, clusters, seed: int = 5, max_count: int = 6) -> None:
    """Give every cluster Karmada's nine default cpu/memory grades
    (``default_resource_models``, what the cluster webhook sets on a
    Cluster that declares none) and seeded AllocatableModelings: 0 to
    ``max_count - 1`` allocatable nodes in each grade."""
    cl_api = importlib.import_module(f"{pkg.__name__}.api.cluster")
    rng = np.random.default_rng(seed)
    grades = len(cl_api.default_resource_models())
    counts = rng.integers(0, max_count, (len(clusters), grades))
    for cl, row in zip(clusters, counts):
        cl.spec.resource_models = cl_api.default_resource_models()
        cl.status.resource_summary.allocatable_modelings = [
            cl_api.AllocatableModeling(grade=g, count=int(n)) for g, n in enumerate(row)
        ]


def config4_placement(pkg):
    """BASELINE config 4's placement: Divided by available replicas over the
    ``env=prod`` clusters, spread over 2-4 regions and 2-10 clusters."""
    api = importlib.import_module(f"{pkg.__name__}.api")
    b = importlib.import_module(f"{pkg.__name__}.utils.builders")
    return b.dynamic_weight_placement(
        cluster_affinity=api.ClusterAffinity(
            label_selector=api.LabelSelector(match_labels={"env": "prod"})
        ),
        spread_constraints=[
            api.SpreadConstraint(spread_by_field="region", min_groups=2, max_groups=4),
            api.SpreadConstraint(spread_by_field="cluster", min_groups=2, max_groups=10),
        ],
    )


def build_workload(pkg, config: int, bindings: int | None = None,
                   clusters: int | None = None, models: bool = False):
    """(snapshot, problems) of BASELINE config 1, 2, 3, 4 or 5, built with the
    api/builders/scheduler modules of ``pkg`` (karmada_tpu_torch, or any
    package with the same layout): the same seeds and placement mix as
    bench.py ``run_engine_config`` (configs 1-4) and
    ``build_headline_workload`` (config 5). ``bindings``/``clusters`` cut
    configs 4 and 5 below their full 10k x 500 and 100k x 5k. With
    ``models``, config 5's clusters carry the nine default resource-model
    grades and seeded allocatable modelings (``with_default_models``)."""
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
    if config == 3:  # per-cluster ResourceModels (bench.py:384-409)
        fleet = b.synthetic_fleet(20, seed=3)
        for cl in fleet:
            cl.spec.resource_models = [
                api.ResourceModel(grade=g, ranges=[
                    api.ResourceModelRange(name="cpu", min=1000 * 2**g,
                                           max=1000 * 2**(g + 1)),
                    api.ResourceModelRange(name="memory", min=(2 << 30) * 2**g,
                                           max=(2 << 30) * 2**(g + 1)),
                ])
                for g in range(3)
            ]
            cl.status.resource_summary.allocatable_modelings = [
                api.AllocatableModeling(grade=g, count=10 * (g + 1)) for g in range(3)
            ]
        pl = b.aggregated_placement()
        problems = [
            s.BindingProblem(key=f"b{i}", placement=pl, replicas=(i % 20) + 1,
                             requests=req, gvk="apps/v1/Deployment")
            for i in range(100)
        ]
        return s.ClusterSnapshot(fleet), problems
    if config == 4:
        fleet = b.synthetic_fleet(clusters or 500, seed=4)
        pl = config4_placement(pkg)
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
    fleet = b.synthetic_fleet(c, seed=7, taint_fraction=0.08)
    if models:
        with_default_models(pkg, fleet)
    snap = s.ClusterSnapshot(fleet)
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


def binding_objects(pkg, snap, problems, limits: dict | None = None,
                    used: dict | None = None, caps: dict | None = None,
                    triggered_at: float = 1.0):
    """(clusters, ResourceBindings, FederatedResourceQuotas) of one recipe
    in ``pkg``: the snapshot's own Cluster objects, one binding per
    problem, and (with ``limits``) ``quota_frqs``'s FRQs. Each binding is
    built so that the scheduler process's ``_build_problem`` round-trips it
    to a problem equal to the recipe's: the key is the binding's namespaced
    name (``ns/name``, or the bare name in namespace ""), the gvk splits at
    its last "/", ``prev`` becomes ``spec.clusters``, each evicted cluster a
    graceful-eviction task (a preemption task where the problem names it in
    ``preempt_clusters``), and a fresh row carries a reschedule trigger at
    ``triggered_at`` that was never served."""
    api = importlib.import_module(f"{pkg.__name__}.api")
    work = importlib.import_module(f"{pkg.__name__}.api.work")
    out = []
    for p in problems:
        ns, _, name = p.key.rpartition("/")
        if ns != p.namespace or "/" not in p.gvk:
            raise ValueError(f"binding_objects: {p.key!r} (namespace {p.namespace!r}, "
                             f"gvk {p.gvk!r}) does not round-trip")
        api_version, _, kind = p.gvk.rpartition("/")
        tasks = [work.GracefulEvictionTask(
            from_cluster=c, reason=(work.EVICTION_REASON_PREEMPTED if c in p.preempt_clusters
                                    else work.EVICTION_REASON_APPLICATION_FAILURE))
            for c in p.evict_clusters]
        out.append(api.ResourceBinding(
            meta=api.ObjectMeta(name=name, namespace=ns),
            spec=api.ResourceBindingSpec(
                resource=api.ObjectReference(api_version=api_version, kind=kind,
                                             namespace=ns, name=name),
                replicas=p.replicas,
                replica_requirements=api.ReplicaRequirements(resource_request=p.requests),
                placement=p.placement,
                priority=p.priority,
                clusters=[api.TargetCluster(name=c, replicas=r) for c, r in p.prev.items()],
                graceful_eviction_tasks=tasks,
                reschedule_triggered_at=triggered_at if p.fresh else None,
            ),
        ))
    frqs = [] if limits is None else quota_frqs(pkg, snap, limits, used, caps)
    return list(snap.clusters), out, frqs


#: the plane cell's OverridePolicy: a registry override on one region's
#: clusters, so the override manager runs on a share of the Works
PLANE_OVERRIDE_REGION = "region-5"
PLANE_REGISTRY = "mirror.example.com"
PLANE_NODES = 4  # NodeStates a member


def member_nodes(pkg, cluster, k: int = PLANE_NODES) -> list:
    """``k`` NodeStates whose sums are ``cluster``'s recipe allocatable and
    allocated (the remainders on the first node): what the cluster status
    controller sums back into the same summary."""
    NodeState = importlib.import_module(f"{pkg.__name__}.estimator.accurate").NodeState
    rs = cluster.status.resource_summary
    nodes = [NodeState(name=f"{cluster.name}-n{j}") for j in range(k)]
    for total, attr in ((rs.allocatable, "allocatable"), (rs.allocated, "requested")):
        for r, v in total.items():
            q, rem = divmod(int(v), k)
            for j, node in enumerate(nodes):
                getattr(node, attr)[r] = q + (rem if j == 0 else 0)
    return nodes


def plane_objects(pkg, templates: int = 10_000, clusters: int = 500) -> dict:
    """BASELINE config 4 as the control plane receives it, built with the
    modules of ``pkg``: ``synthetic_fleet(clusters, seed=4)`` as Cluster
    objects, one MemberCluster each whose NodeStates sum to its recipe
    summary (``member_nodes``), ``templates`` Deployments ``d{i}`` with
    replicas ``(i % 40) + 1`` (config 4's requests: 250m cpu and 512Mi),
    one PropagationPolicy with config 4's placement, and one OverridePolicy
    whose ImageOverrider rewrites the registry on the clusters of
    ``PLANE_OVERRIDE_REGION``."""
    api = importlib.import_module(f"{pkg.__name__}.api")
    pol = importlib.import_module(f"{pkg.__name__}.api.policy")
    b = importlib.import_module(f"{pkg.__name__}.utils.builders")
    member = importlib.import_module(f"{pkg.__name__}.utils.member")
    fleet = b.synthetic_fleet(clusters, seed=4)
    members = []
    for cl in fleet:
        m = member.MemberCluster(cl.name)
        m.nodes = member_nodes(pkg, cl)
        members.append(m)
    selectors = [pol.ResourceSelector(api_version="apps/v1", kind="Deployment")]
    policy = pol.PropagationPolicy(
        meta=api.ObjectMeta(name="config4", namespace="default"),
        spec=pol.PropagationSpec(resource_selectors=selectors,
                                 placement=config4_placement(pkg)))
    override = pol.OverridePolicy(
        meta=api.ObjectMeta(name="regional-mirror", namespace="default"),
        spec=pol.OverrideSpec(resource_selectors=selectors, override_rules=[
            pol.RuleWithCluster(
                target_cluster=pol.ClusterAffinity(field_selector=pol.FieldSelector(
                    match_expressions=[pol.LabelSelectorRequirement(
                        key="region", operator="In", values=(PLANE_OVERRIDE_REGION,))])),
                overriders=pol.Overriders(image_overrider=[pol.ImageOverrider(
                    component="Registry", operator="replace", value=PLANE_REGISTRY)]))]))
    deployments = [b.new_deployment(f"d{i}", replicas=(i % 40) + 1)
                   for i in range(templates)]
    return {"clusters": fleet, "members": members, "deployments": deployments,
            "policy": policy, "override": override}


def plane_picks(templates: int, scale: int, delete: int) -> tuple[dict, list]:
    """The plane's later waves, from seed 99: ``scale`` templates' indices
    with new replica counts in [1, 40], each other than its count
    ``(i % 40) + 1``, and ``delete`` other templates' indices."""
    rng = np.random.default_rng(99)
    picked = [int(i) for i in rng.choice(templates, scale + delete, replace=False)]
    reps = rng.integers(1, 41, scale)
    scaled = {i: int(r) if int(r) != (i % 40) + 1 else int(r) % 40 + 1
              for i, r in zip(sorted(picked[:scale]), reps)}
    return scaled, sorted(picked[scale:])


#: the plane's failover cell: the clusters the chaos seam kills (seed 7),
#: the bindings the descheduler reclaims from (seed 11), and where the
#: plane's injected clock starts
PLANE_KILL, PLANE_DESCHEDULE, PLANE_CLOCK0 = 25, 200, 1_000_000.0


class PlaneClock:
    """The plane's injected clock; the waves advance it by hand."""

    def __init__(self, now: float = PLANE_CLOCK0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def plane_kills(names, kill: int, hosting) -> list:
    """``kill`` cluster names picked with seed 7: one among the clusters
    that host bindings (``hosting``), the others among the rest. Config 4's
    spread fills its largest prod clusters (10 of 500 hold every binding),
    so a uniform draw misses them all; an outage the plane must fail over
    takes down one of them. Only names no other name extends are drawn:
    the chaos seam's ``match=`` is a substring test (a rule for member-4
    would fire on member-40 too), so each rule fires on its own cluster
    alone."""
    names = sorted(names)
    own = [n for n in names if not any(o != n and o.startswith(n) for o in names)]
    rng = np.random.default_rng(7)
    hit = [n for n in own if n in hosting]
    picked = [hit[int(rng.integers(len(hit)))]]
    rest = [n for n in own if n not in hosting]
    picked += [rest[int(i)] for i in rng.choice(len(rest), kill - 1, replace=False)]
    return sorted(picked)


def kill_spec(killed) -> str:
    return ";".join(f"cluster.health=down,match={n}" for n in killed)


def plane_deschedule_picks(rbs, live, n: int) -> list:
    """``n`` bindings picked with seed 11 among those placed on a live
    cluster, each with one of its live clusters (seed 11) and the replicas
    to mark unschedulable there, min(2, its replicas there): a list of
    (binding key, workload key, cluster, count)."""
    cands = [rb for rb in rbs
             if any(tc.name in live and tc.replicas > 0 for tc in rb.spec.clusters)]
    rng = np.random.default_rng(11)
    out = []
    for i in sorted(int(i) for i in rng.choice(len(cands), n, replace=False)):
        rb = cands[i]
        on = sorted(tc.name for tc in rb.spec.clusters if tc.name in live and tc.replicas > 0)
        c = on[int(rng.integers(len(on)))]
        reps = next(tc.replicas for tc in rb.spec.clusters if tc.name == c)
        out.append((rb.meta.namespaced_name, rb.spec.resource.namespaced_key, c, min(2, reps)))
    return out


def mark_unschedulable(cp, picks, since: float) -> None:
    """Pods of each pick's workload on its cluster, PodScheduled=False
    (Unschedulable) since ``since``: what the descheduler counts."""
    for _, wkey, cluster, count in picks:
        ns, _, name = wkey.partition("/")
        member = cp.members.get(cluster)
        for j in range(count):
            member.add_pod(ns, f"{name}-unsched-{j}", owner_key=wkey)
            member.mark_pod_unschedulable(ns, f"{name}-unsched-{j}", since=since)


def sorted_bindings(store) -> list:
    """The store's ResourceBindings by key."""
    return sorted(store.list("ResourceBinding"), key=lambda rb: rb.meta.namespaced_name)


def report_ready(cp, skip=()) -> int:
    """Every member not in ``skip`` reports each of its Deployments whose
    status is not ready at its replicas ready; returns how many."""
    n = 0
    for name in sorted(cp.members.names()):
        if name in skip:
            continue
        member = cp.members.get(name)
        for obj in member.list("apps/v1/Deployment"):
            reps = obj.spec["replicas"]
            if (obj.status or {}).get("readyReplicas") != reps:
                member.set_workload_status("apps/v1/Deployment", obj.meta.namespace,
                                           obj.meta.name, {"replicas": reps, "readyReplicas": reps,
                                                           "updatedReplicas": reps})
                n += 1
    return n


#: the plane's autoscaling, networking and resume cell (``run_plane`` after
#: its recovery wave): FederatedHPAs with a cpu utilization target of
#: ``HPA_TARGET`` % on templates the scale and delete waves did not pick
#: (seed 7): ``PLANE_AUTOSCALE`` = (at 80 %, inside the 0.1 tolerance, at
#: 400 %); ``PLANE_AUTOSCALE_DOWN`` more at 20 % behind a 300 s window;
#: ``PLANE_CRON`` CronFederatedHPAs at 09:00 UTC; ``PLANE_SERVICES``
#: exported services with a MultiClusterService each and
#: ``PLANE_INGRESSES`` MultiClusterIngresses over them (seed 13)
HPA_TARGET = 50
PLANE_AUTOSCALE, PLANE_AUTOSCALE_DOWN, PLANE_CRON = (600, 200, 200), 200, 500
PLANE_SERVICES, PLANE_INGRESSES, PLANE_CONSUMERS = 50, 20, 4


def autoscale_picks(templates: int, skip, up: tuple, down: int, cron: int,
                    seed: int = 7) -> tuple[dict, list, dict]:
    """The autoscaling waves' templates, drawn with ``seed`` among the
    indices not in ``skip`` (whose replicas are still ``(i % 40) + 1``),
    disjoint: ``up`` = (n80, ntol, n400) FederatedHPA targets with their
    utilization (80, an integer in [45, 50], 400: integers, so the
    pod-weighted mean the controller takes is exact); ``down`` templates of
    at least 2 replicas (their 20 % proposal lies below their size);
    ``cron`` templates of at least 2 replicas with a new size each, the
    first half up by 1-20, the second half down to a size in [1, replicas).
    Returns ({index: utilization}, [index], {index: new replicas})."""
    rng = np.random.default_rng(seed)
    free = [i for i in range(templates) if i not in skip]
    order = [free[int(k)] for k in rng.permutation(len(free))]
    n80, ntol, n400 = up
    ups = order[:n80 + ntol + n400]
    utils = [80] * n80 + [int(u) for u in rng.integers(45, 51, ntol)] + [400] * n400
    rest = [i for i in order[len(ups):] if i % 40 >= 1]
    downs, crons = sorted(rest[:down]), rest[down:down + cron]
    new = {}
    for k, i in enumerate(crons):
        reps = (i % 40) + 1
        new[i] = (reps + int(rng.integers(1, 21)) if k < len(crons) // 2
                  else int(rng.integers(1, reps)))
    return dict(zip(ups, utils)), downs, dict(sorted(new.items()))


def hpa_max(replicas: int) -> int:
    """A FederatedHPA's ``max_replicas`` for a template of ``replicas``: 4x,
    under the 400 % group's proposal of 8x."""
    return 4 * replicas


def hpa_rule(current: int, util: float, lo: int, hi: int, held: bool = True) -> int:
    """The kube HPA rule for an aggregate sample of ready pods at ``util`` %
    of ``HPA_TARGET``, as the FederatedHPA controller applies it
    (``controllers/autoscaling.py``, the aggregate path): ceil(current x
    util / target), clamped to [lo, hi]. That path applies no tolerance
    band: a proposal under the current size is a scale-down, which the
    stabilization window holds at the current size while the size it was
    seeded with (the current one, on a first evaluation) is inside the
    window (``held``)."""
    want = min(max(math.ceil(current * (util / HPA_TARGET)), lo), hi)
    return current if held and want < current else want


def hpa_objects(pkg, indices, replicas_of: dict, window: int) -> list:
    """One FederatedHPA ``d{i}-hpa`` a template: cpu at ``HPA_TARGET`` %,
    min 1, max ``hpa_max``, the scale-down window ``window`` s."""
    a = importlib.import_module(f"{pkg.__name__}.api.autoscaling")
    core = importlib.import_module(f"{pkg.__name__}.api.core")
    return [a.FederatedHPA(
        meta=core.ObjectMeta(name=f"d{i}-hpa", namespace="default"),
        spec=a.FederatedHPASpec(
            scale_target_ref=a.ScaleTargetRef(kind="Deployment", name=f"d{i}"),
            min_replicas=1, max_replicas=hpa_max(replicas_of[i]),
            metrics=[a.MetricSpec(resource_name="cpu", target_average_utilization=HPA_TARGET)],
            stabilization_window_seconds=window)) for i in indices]


def cron_objects(pkg, new: dict) -> list:
    """One CronFederatedHPA ``d{i}-cron`` a template, one rule ``0 9 * * *``
    setting its replicas to ``new[i]``."""
    a = importlib.import_module(f"{pkg.__name__}.api.autoscaling")
    core = importlib.import_module(f"{pkg.__name__}.api.core")
    return [a.CronFederatedHPA(
        meta=core.ObjectMeta(name=f"d{i}-cron", namespace="default"),
        spec=a.CronFederatedHPASpec(
            scale_target_ref=a.ScaleTargetRef(kind="Deployment", name=f"d{i}"),
            rules=[a.CronFederatedHPARule(name="morning", schedule="0 9 * * *",
                                          target_replicas=reps)]))
        for i, reps in new.items()]


def set_samples(cp, utils: dict) -> None:
    """Each member of each template's binding gets an aggregate sample
    (``pod_metrics``) for the replicas placed on it: every pod ready, at
    the template's utilization ``utils[i]``."""
    for i, util in utils.items():
        rb = cp.store.get("ResourceBinding", f"default/d{i}-deployment")
        for tc in rb.spec.clusters:
            cp.members.get(tc.name).pod_metrics[f"default/d{i}"] = {
                "pods": tc.replicas, "ready_pods": tc.replicas, "cpu_utilization": float(util)}


def next_utc(now: float, hour: int, minute: int, second: int) -> float:
    """The first time after ``now`` at ``hour:minute:second`` UTC."""
    t = now - now % 86400 + hour * 3600 + minute * 60 + second
    return t if t > now else t + 86400


SLICE_GVK, INGRESS_GVK = "discovery.k8s.io/v1/EndpointSlice", "networking.k8s.io/v1/Ingress"


def network_picks(rbs, names, services: int, ingresses: int, consumers: int,
                  seed: int = 13) -> tuple[dict, dict, dict]:
    """The networking wave's objects, drawn with ``seed``: ``services``
    bindings placed on at least 2 clusters, each exported from 2-4 of them
    (its providers) to ``consumers`` other clusters; ``ingresses`` ingresses
    over 1-3 of those services each. Returns ({template name: providers},
    {template name: consumers}, {ingress name: [template names]})."""
    rng = np.random.default_rng(seed)
    cands = [rb for rb in rbs if len(rb.spec.clusters) >= 2]
    picked = sorted(int(k) for k in rng.choice(len(cands), services, replace=False))
    providers, to = {}, {}
    for k in picked:
        rb = cands[k]
        on = sorted(tc.name for tc in rb.spec.clusters)
        n = int(rng.integers(2, min(4, len(on)) + 1))
        name = rb.spec.resource.name
        providers[name] = sorted(on[int(j)] for j in rng.choice(len(on), n, replace=False))
        others = [c for c in sorted(names) if c not in providers[name]]
        to[name] = sorted(others[int(j)] for j in rng.choice(len(others), consumers,
                                                             replace=False))
    svc = sorted(providers)
    ing = {f"ing{j}": sorted(svc[int(k)] for k in rng.choice(
        len(svc), int(rng.integers(1, min(3, len(svc)) + 1)), replace=False))
        for j in range(ingresses)}
    return providers, to, ing


def network_objects(pkg, cp, providers: dict, consumers: dict, ingresses: dict) -> None:
    """The networking wave's writes: each service's Service and one seeded
    EndpointSlice on each of its providers, its ServiceExport and its
    MultiClusterService (providers and consumers named) in the store; each
    ingress as a MultiClusterIngress, one Prefix path a backend."""
    core = importlib.import_module(f"{pkg.__name__}.api.core")
    n = importlib.import_module(f"{pkg.__name__}.api.networking")
    for name, provs in providers.items():
        for k, c in enumerate(provs):
            m = cp.members.get(c)
            m.apply(core.Resource(api_version="v1", kind="Service",
                                  meta=core.ObjectMeta(name=name, namespace="default"),
                                  spec={"ports": [{"port": 80}], "clusterIP": f"10.96.{k}.1"}))
            m.apply(core.Resource(
                api_version="discovery.k8s.io/v1", kind="EndpointSlice",
                meta=core.ObjectMeta(name=f"{name}-{c}", namespace="default",
                                     labels={"kubernetes.io/service-name": name}),
                spec={"endpoints": [{"addresses": [f"10.{k}.{len(name)}.{j}"]}
                                    for j in range(1 + k)]}))
        cp.store.apply(n.ServiceExport(meta=core.ObjectMeta(name=name, namespace="default")))
        cp.store.apply(n.MultiClusterService(
            meta=core.ObjectMeta(name=name, namespace="default"),
            spec=n.MultiClusterServiceSpec(
                provider_clusters=[n.ExposureRange(cluster_names=list(provs))],
                consumer_clusters=[n.ExposureRange(cluster_names=list(consumers[name]))])))
    for ing, backends in ingresses.items():
        cp.store.apply(n.MultiClusterIngress(
            meta=core.ObjectMeta(name=ing, namespace="default"),
            spec=n.MultiClusterIngressSpec(rules=[{
                "host": f"{ing}.example.com",
                "http": {"paths": [{"path": f"/{b}", "pathType": "Prefix",
                                    "backend": {"service": {"name": b}}} for b in backends]}}])))


def network_teardown(cp, providers: dict, ingresses: dict) -> None:
    """Delete the networking wave's objects: the ServiceExports,
    MultiClusterServices and MultiClusterIngresses, the Works their
    controllers dispatched (which own none of them), and the providers'
    Services and EndpointSlices."""
    for name in providers:
        cp.store.delete("ServiceExport", f"default/{name}")
        cp.store.delete("MultiClusterService", f"default/{name}")
    for ing in ingresses:
        cp.store.delete("MultiClusterIngress", f"default/{ing}")
    for w in cp.store.list("Work"):
        if w.meta.name.startswith(("mcs-", "mci-")):
            cp.store.delete("Work", w.meta.namespaced_name)
    for name, provs in providers.items():
        for c in provs:
            cp.members.get(c).delete("v1/Service", "default", name)
            cp.members.get(c).delete(SLICE_GVK, "default", f"{name}-{c}")


def network_check(cp, providers: dict, consumers: dict, ingresses: dict) -> tuple[int, int]:
    """(consumers missing the derived Service or a provider's slice, or
    holding their own back; ingresses whose status or members differ from
    the clusters that serve their backends: the providers and the
    consumers)."""
    bad_mcs = 0
    for name, provs in providers.items():
        for c in consumers[name]:
            m = cp.members.get(c)
            bad_mcs += m.get("v1/Service", "default", f"derived-{name}") is None
            bad_mcs += sum(m.get(SLICE_GVK, "default", f"{p}-{name}-{p}") is None
                           for p in provs if p != c)
    bad_mci = 0
    for ing, backends in ingresses.items():
        want = sorted({c for b in backends for c in providers[b] + consumers[b]})
        obj = cp.store.get("MultiClusterIngress", f"default/{ing}")
        have = sorted(n for n in cp.members.names()
                      if cp.members.get(n).get(INGRESS_GVK, "default", ing) is not None)
        bad_mci += obj.status.get("clusters") != want or have != want
    return bad_mcs, bad_mci


def member_state(cp) -> dict:
    """(member, gvk, namespace, name) -> (resource version, a copy of the
    spec) of every member object."""
    from karmada_tpu_torch.utils.clone import clone_json

    return {(name, f"{o.api_version}/{o.kind}", o.meta.namespace, o.meta.name):
            (o.meta.resource_version, clone_json(o.spec))
            for name in sorted(cp.members.names()) for o in cp.members.get(name).list()}


def resume_plane(pkg, cp, path: str, **plane_kw):
    """Checkpoint ``cp``'s store to ``path`` and resume it into a new
    ``ControlPlane(**plane_kw)``: the old plane's member watches dropped (a
    member event must not reach two planes), the checkpoint restored, then
    the same member states joined with their restored Clusters, in
    ``localup.py``'s order. Returns (the new plane, objects written,
    objects restored, the walls of the checkpoint, the new plane's
    construction, the restore and the joins)."""
    walls = {}
    t0 = time.perf_counter()
    written = cp.store.checkpoint(path)
    walls["checkpoint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp2 = importlib.import_module(f"{pkg.__name__}.controlplane").ControlPlane(**plane_kw)
    members = [cp.members.get(n) for n in sorted(cp.members.names())]
    for m in members:
        m._watchers.clear()
    walls["new plane"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = cp2.store.restore(path)
    walls["restore"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for m in members:
        cp2.join_cluster(cp2.store.get("Cluster", m.name), m)
    walls["join"] = time.perf_counter() - t0
    return cp2, written, restored, walls


def node_states(pkg, n: int, seed: int) -> list:
    """Seeded member nodes of ``pkg``'s estimator: 8-64 cores, 32-256 GiB
    and 110 pods each, 0-90% of cpu, memory and pods requested."""
    acc = importlib.import_module(f"{pkg.__name__}.estimator.accurate")
    rng = np.random.default_rng(seed)
    cores = rng.integers(8, 65, n) * 1000
    mem = rng.integers(32, 257, n) << 30
    frac = rng.uniform(0.0, 0.9, n)
    req_cpu = (cores * frac).astype(np.int64)
    req_mem = (mem * frac).astype(np.int64)
    pods = (110 * frac).astype(np.int64)
    return [
        acc.NodeState(name=f"n{i}",
                      allocatable={"cpu": int(cores[i]), "memory": int(mem[i]), "pods": 110},
                      requested={"cpu": int(req_cpu[i]), "memory": int(req_mem[i])},
                      num_pods=int(pods[i]))
        for i in range(n)
    ]


def estimator_workload(pkg, clusters: int = 128, nodes: int = 4000,
                       bindings: int = 10_000):
    """bench.py's estimator tier (``run_estimator_tier``: dynamic weight, 8
    request profiles, replicas 1-79, fleet seed 77) over ``clusters``
    members of ``nodes`` seeded nodes each. Each cluster's ResourceSummary
    is the sum of its nodes, as the cluster-status controller aggregates
    it. Returns (snapshot, {cluster name: nodes}, problems)."""
    b = importlib.import_module(f"{pkg.__name__}.utils.builders")
    q = importlib.import_module(f"{pkg.__name__}.utils.quantity")
    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    fleet = b.synthetic_fleet(clusters, seed=77)
    per_cluster = {}
    for ci, cl in enumerate(fleet):
        ns = node_states(pkg, nodes, 1000 + ci)
        per_cluster[cl.name] = ns
        rs = cl.status.resource_summary
        rs.allocatable = {d: sum(n.allocatable[d] for n in ns) for d in ("cpu", "memory", "pods")}
        rs.allocated = {d: sum(n.requested[d] for n in ns) for d in ("cpu", "memory")}
        rs.allocated["pods"] = sum(n.num_pods for n in ns)
    pl = b.dynamic_weight_placement()
    profiles = [
        q.parse_resource_list({"cpu": f"{250 * (p + 1)}m", "memory": f"{512 * (p + 1)}Mi"})
        for p in range(8)
    ]
    rng = np.random.default_rng(17)
    problems = [
        s.BindingProblem(key=f"e{i}", placement=pl, replicas=int(rng.integers(1, 80)),
                         requests=profiles[int(rng.integers(0, 8))],
                         gvk="apps/v1/Deployment")
        for i in range(bindings)
    ]
    return s.ClusterSnapshot(fleet), per_cluster, problems


#: the quota cell's namespaces (bench.py ``run_quota``: binding i goes to
#: namespace i % 32), of which the first CAP_NAMESPACES carry a static-
#: assignment cap on cluster 0 (bench.py:2513-2528)
QUOTA_NAMESPACES = tuple(f"nsq{k:02d}" for k in range(32))
CAP_NAMESPACES = 4
#: generous limits: a cold wave admits every row
GENEROUS = {"cpu": 1 << 40, "memory": 1 << 50}


def quota_workload(pkg, bindings: int | None = None, clusters: int | None = None):
    """Config 5 (``build_workload``) with binding i in namespace
    ``QUOTA_NAMESPACES[i % 32]``: the quota tier's recipe (bench.py
    ``run_quota``) driven at the engine."""
    snap, problems = build_workload(pkg, 5, bindings, clusters)
    for i, p in enumerate(problems):
        p.namespace = QUOTA_NAMESPACES[i % len(QUOTA_NAMESPACES)]
    return snap, problems


def quota_frqs(pkg, snap, limits: dict, used: dict | None = None,
               caps: dict | None = None) -> list:
    """One FederatedResourceQuota per namespace of ``limits`` (namespace ->
    spec.overall). ``used`` (namespace -> usage) gives each a status
    reconciled with its spec. ``caps`` (namespace -> {cluster: hard}) adds
    static assignments; by default the first ``CAP_NAMESPACES`` namespaces
    cap cluster 0 at 2 cpus (bench.py:2513-2528)."""
    pol = importlib.import_module(f"{pkg.__name__}.api.policy")
    core = importlib.import_module(f"{pkg.__name__}.api.core")
    if caps is None:
        caps = {ns: {snap.names[0]: {"cpu": 2000}}
                for ns in sorted(limits)[:CAP_NAMESPACES]}
    out = []
    for ns in sorted(limits):
        q = pol.FederatedResourceQuota(
            meta=core.ObjectMeta(name="quota", namespace=ns),
            spec=pol.FederatedResourceQuotaSpec(
                overall=dict(limits[ns]),
                static_assignments=[
                    pol.StaticClusterAssignment(cluster_name=c, hard=dict(h))
                    for c, h in caps.get(ns, {}).items()
                ],
            ),
        )
        if used is not None:
            q.status = pol.FederatedResourceQuotaStatus(
                overall=dict(limits[ns]), overall_used=dict(used[ns]))
        out.append(q)
    return out


def wave_demand(snap, problems, ns_index: dict) -> tuple[list, np.ndarray]:
    """(namespace id per row, int64[B, R] demand): each quota'd row's
    per-replica request over the snapshot's dims (a replica occupies one
    pod) times its replica delta over its previous placement, clamped at
    2^44 — the admission inputs, computed here without the engine."""
    dims = list(snap.dims)
    clamp = 2**44
    ns_ids = [ns_index.get(p.namespace, -1) for p in problems]
    demand = np.zeros((len(problems), len(dims)), np.int64)
    for i, p in enumerate(problems):
        delta = p.replicas - sum(p.prev.values())
        if ns_ids[i] < 0 or delta <= 0:
            continue
        for j, d in enumerate(dims):
            v = int(p.requests.get(d, 0))
            if d == "pods":
                v = max(v, 1)
            demand[i, j] = min(v * delta, clamp)
    return ns_ids, demand


def wide_quota_scene(pkg, bindings: int = 2000, clusters: int | None = 500,
                     extra_dims: int = 13, seed: int = 31):
    """A quota over 4 + ``extra_dims`` resource dims (17 by default):
    config 5's rows and fleet (``build_workload``) where every cluster also
    carries 10,000 of each extended resource ``example.com/rNN`` and every
    row asks 1-3 of each, in four namespaces. Each namespace's limits are
    twice its wave's demand on every dim but one, where they are half of
    it: the last dim (past the first 16) for even namespaces, the first
    extended one for odd. Returns (snapshot, problems, QuotaSnapshot)."""
    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    snap, problems = build_workload(pkg, 5, bindings, clusters)
    ext = [f"example.com/r{k:02d}" for k in range(extra_dims)]
    for cl in snap.clusters:
        for d in ext:
            cl.status.resource_summary.allocatable[d] = 10_000
    snap = s.ClusterSnapshot(snap.clusters)
    namespaces = tuple(f"wq{k}" for k in range(4))
    rng = np.random.default_rng(seed)
    for i, p in enumerate(problems):
        p.namespace = namespaces[i % len(namespaces)]
        p.requests = {**p.requests, **{d: int(rng.integers(1, 4)) for d in ext}}
    ns_index = {ns: k for k, ns in enumerate(namespaces)}
    ns_ids, demand = wave_demand(snap, problems, ns_index)
    ns_ids = np.asarray(ns_ids)
    dims = list(snap.dims)
    limits = {}
    for k, ns in enumerate(namespaces):
        tot = demand[ns_ids == k].sum(axis=0)
        lim = {d: int(v) * 2 + 1 for d, v in zip(dims, tot)}
        bind = dims[-1] if k % 2 == 0 else dims[len(dims) - extra_dims]
        lim[bind] = int(tot[dims.index(bind)]) // 2
        limits[ns] = lim
    quota = s.build_quota_snapshot(quota_frqs(pkg, snap, limits, caps={}), snap, 1)
    return snap, problems, quota


#: the ranked cell's three ClusterAffinities groups, by the config-5 fleet's
#: ``tier`` label (t0..t15): a small primary group and two fallbacks
RANKED_GROUPS = (("t0",), tuple(f"t{k}" for k in range(1, 8)),
                 tuple(f"t{k}" for k in range(8, 16)))
RANKED_NAMESPACES = tuple(f"rk{k}" for k in range(8))


def ranked_workload(pkg, bindings: int = 10_000, clusters: int | None = None,
                    seed: int = 23):
    """Ordered-failover rows over the config-5 fleet: every row's placement
    lists three ClusterAffinities terms, the tier groups of
    ``RANKED_GROUPS`` in order (dynamic weight, every fourth row
    Aggregated). Every third row asks 50-99 replicas of 2048 cpus each,
    more than the small primary group holds, so it falls back; the others
    ask config 5's profiles. A third of the rows carry previous sites, 5%
    are fresh. Row i is in namespace ``RANKED_NAMESPACES[i % 8]``; the
    first four namespaces cap the first 600 clusters at 16 cpus each
    (``ranked_caps``). Returns (snapshot, problems)."""
    api = importlib.import_module(f"{pkg.__name__}.api")
    b = importlib.import_module(f"{pkg.__name__}.utils.builders")
    q = importlib.import_module(f"{pkg.__name__}.utils.quantity")
    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    snap, _ = build_workload(pkg, 5, 1, clusters)
    names = snap.names

    def term(k):
        return api.ClusterAffinityTerm(
            affinity_name=f"tier-group-{k}",
            label_selector=api.LabelSelector(match_expressions=[
                api.LabelSelectorRequirement(key="tier", operator="In",
                                             values=RANKED_GROUPS[k])]),
        )

    terms = [term(k) for k in range(3)]
    pls = (b.dynamic_weight_placement(cluster_affinities=list(terms)),
           b.aggregated_placement(cluster_affinities=list(terms)))
    profiles = [
        q.parse_resource_list({"cpu": f"{250 * (p + 1)}m", "memory": f"{512 * (p + 1)}Mi"})
        for p in range(8)
    ]
    big = q.parse_resource_list({"cpu": "2048", "memory": "512Mi"})
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(bindings):
        heavy = i % 3 == 0
        prev = {}
        if rng.random() < 1 / 3:
            sites = rng.choice(len(names), int(rng.integers(1, 4)), replace=False)
            prev = {names[j]: int(rng.integers(1, 10)) for j in sites}
        problems.append(s.BindingProblem(
            key=f"r{i}", placement=pls[int(i % 4 == 3)],
            replicas=int(rng.integers(50, 100) if heavy else rng.integers(1, 100)),
            requests=big if heavy else profiles[int(rng.integers(0, 8))],
            gvk="apps/v1/Deployment", prev=prev, fresh=bool(rng.random() < 0.05),
            namespace=RANKED_NAMESPACES[i % len(RANKED_NAMESPACES)],
        ))
    return snap, problems


def ranked_caps(snap) -> dict:
    """The ranked cell's static assignments: the first four namespaces cap
    each of the first 600 clusters at 16 cpus."""
    return {ns: {c: {"cpu": 16_000} for c in snap.names[:600]}
            for ns in RANKED_NAMESPACES[:4]}


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


def divide_edge_batch(rng, b: int, c: int, kinds: tuple = tuple(range(8))) -> dict:
    """K2 inputs on which its selections must be exact, eight row kinds in
    turn: all-equal weights; equal (weight, last) at many indices (scale-up
    rows with tied previous counts); INT32_MIN weights and lasts; static
    rows whose remainder is one less than their positive weights (weight 1
    on n candidates, n - 1 replicas); Aggregated rows whose cut falls inside
    a group of equal weights (fresh and scale-up); Aggregated fresh rows
    whose avail + prev wraps negative (the literal count); scale-down rows
    of tied previous counts; and rows of random small weights. ``kinds``
    picks which, row i taking ``kinds[i % len(kinds)]``."""
    i32min, i32max = -(2**31), 2**31 - 1
    kind = np.asarray(kinds)[np.arange(b) % len(kinds)]
    strategy = np.full(b, 2, np.int32)
    replicas = rng.integers(1, 200, b).astype(np.int32)
    cand = rng.random((b, c)) < 0.9
    static_w = np.zeros((b, c), np.int32)
    avail = np.full((b, c), 7, np.int32)
    prev = np.zeros((b, c), np.int32)
    fresh = np.zeros(b, bool)
    tied = rng.random((b, c)) < min(1.0, 40.0 / max(c, 1))
    for i in range(b):
        k = kind[i]
        if k == 0:  # all-equal weights, fresh
            fresh[i] = True
            strategy[i] = 2 + (i // 8) % 2
        elif k == 1:  # scale-up with tied previous counts
            prev[i, tied[i]] = 3
            replicas[i] = 3 * int((tied[i] & cand[i]).sum()) + int(rng.integers(1, 50))
        elif k == 2:  # INT32_MIN weights and lasts, static then dynamic
            strategy[i] = 1 + (i // 8) % 2
            static_w[i] = np.where(rng.random(c) < 0.3, i32min, rng.integers(0, 5, c))
            avail[i] = np.where(rng.random(c) < 0.3, i32min, rng.integers(0, 5, c))
            prev[i, tied[i]] = i32min
            replicas[i] = int(rng.integers(1, 60))
        elif k == 3:  # static, remain = #positive weights - 1
            strategy[i] = 1
            static_w[i] = cand[i]
            replicas[i] = max(1, int(cand[i].sum()) - 1)
        elif k == 4:  # Aggregated, the cut inside an equal-weight group
            strategy[i] = 3
            fresh[i] = (i // 8) % 2 == 0
            avail[i] = np.where(rng.random(c) < 0.5, 7, 3)
            prev[i, tied[i]] = 2
            replicas[i] = int(rng.integers(1, 7 * max(1, c // 4)))
        elif k == 5:  # Aggregated fresh, avail + prev wraps negative
            strategy[i] = 3
            fresh[i] = True
            avail[i] = rng.integers(i32max - 50, i32max, c)
            prev[i, tied[i]] = 100
            replicas[i] = int(rng.integers(1, 99))
        elif k == 6:  # scale-down over tied previous counts
            prev[i, tied[i]] = 5
            replicas[i] = max(1, int(tied[i].sum()) - 2)
        else:  # random small weights
            strategy[i] = int(rng.integers(0, 4))
            avail[i] = rng.integers(0, 4, c)
            static_w[i] = rng.integers(0, 4, c)
            fresh[i] = bool(rng.random() < 0.3)
    return {"strategy": strategy, "replicas": replicas, "candidates": cand,
            "static_w": static_w, "avail": avail.astype(np.int32), "prev": prev,
            "fresh": fresh}


def to_device(arrays: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


#: device clock cycles of the spin queued before each timed batch (about 2
#: ms on an H100): the host enqueues the batch's calls while the device
#: spins, so a kernel shorter than its wrapper's host work is timed alone
SPIN_CYCLES = 4_000_000


def cuda_ms(fn, reps: int = 10, batches: int = 5) -> float:
    """Device milliseconds per call of ``fn()``: CUDA events around
    ``reps`` back-to-back calls, queued behind a device spin
    (``SPIN_CYCLES``) so that the host's launch work is hidden, divided
    by ``reps``; the median over ``batches`` such runs, after one warm
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        torch.cuda._sleep(SPIN_CYCLES)
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


K2_ARGS = ("strategy", "replicas", "candidates", "static_w", "avail", "prev", "fresh")
#: the five phases K2's phases entry point times, clock64 per block
K2_PHASES = ("cohort sums", "Aggregated cut", "weights/total/floors", "bonus selection",
             "dispense")


def k2_chunk_args(table) -> tuple[list, bool]:
    """K2's inputs on a fleet table's first chunk, as a pass makes them (K3
    over the chunk's rows), and whether the table holds Aggregated rows."""
    from karmada_tpu_torch.scheduler import fleet_kernels as fk
    from karmada_tpu_torch.scheduler.fleet import _pow2

    n = table.n_rows
    chunk = min(table.chunk, _pow2(max(n, 256)))
    m = fk.fleet_masks(*table._dev_tables, table._all_rows_dev[:chunk], *table._dev_state)
    args = [m.strategy, m.replicas, m.feasible, m.static_w, m.avail, m.prev, m.fresh]
    return args, bool((table._st["strategy"][:n] == 3).any())


def k2_phase_split(args, has_agg: bool, label: str, card: str, reps: int = 3) -> dict:
    """K2's phase split on ``args`` (its seven inputs on the card): the
    phases entry point of ``csrc/divide_replicas.cu`` (the same kernel
    body, a barrier and a clock64 read by thread 0 at each phase's end)
    writes each block's cycles per phase; summed over the blocks of
    ``reps`` launches. Its output must equal the plain version's. Prints
    each phase's share of the block cycles and its mean kilocycles a row."""
    import types

    import torch
    from karmada_tpu_torch import native, ops

    from karmada_tpu_torch.ops.divide import launch_buffers

    b, c = args[2].shape
    dev = args[2].device
    bufs = launch_buffers(b, c, dev)
    out, unsched = bufs[:2]
    cycles = torch.zeros((b, len(K2_PHASES)), dtype=torch.int64, device=dev)
    counter = types.SimpleNamespace(launches=0)  # not a path's launch
    total = np.zeros(len(K2_PHASES))
    for _ in range(reps):
        native.launch(counter, "divide_replicas", "divide_replicas_phases_launch", dev,
                      *args, b, c, int(has_agg), *bufs, cycles)
        torch.cuda.synchronize()
        total += cycles.sum(dim=0).cpu().numpy()
    want = ops.divide_replicas_ref(*args, has_agg)
    compare(f"divide_replicas phases {label}", (out, unsched),
            (want.assignment, want.unschedulable))
    share = total / max(total.sum(), 1)
    per_row = total / reps / b / 1e3
    print(f"# K2 phase split {label}: "
          + ", ".join(f"{n} {s:.1%} ({r:.2f} kcycles a row)"
                      for n, s, r in zip(K2_PHASES, share, per_row))
          + f"; card {card}", flush=True)
    return {n: {"share": float(s), "kcycles_per_row": float(r)}
            for n, s, r in zip(K2_PHASES, share, per_row)}


# --------------------------------------------------------------------------
# end-to-end phase
# --------------------------------------------------------------------------


def referent_caps(engine, problems, requests):
    """The rows' static-assignment caps computed here, from the quota
    snapshot's cap tensor and not through the port's cap body (which K13's
    plain version and the engine's host mirror share): int32[B, C] of
    floor(cap / request) minimised over the requested dims, MAX_INT32 where
    the namespace is uncapped, nothing is requested or the cap is
    UNLIMITED. None when the engine holds no caps. The answers merge into
    the numpy availability as an estimator's (``extras``), which ignores
    -1, so a negative answer raises: this script's caps are all positive."""
    from karmada_tpu_torch.ops.quota import MAX_INT32, UNLIMITED

    q = engine.quota
    if q is None or not q.has_caps:
        return None
    out = np.full((len(problems), q.cluster_caps.shape[1]), MAX_INT32, np.int64)
    for i, p in enumerate(problems):
        k = q.cap_index.get(p.namespace)
        dims = np.flatnonzero(requests[i] > 0)
        if k is None or not len(dims):
            continue
        cap = q.cluster_caps[k][:, dims]
        fit = np.where(cap >= UNLIMITED, MAX_INT32, cap // requests[i, dims])
        out[i] = np.minimum(fit.min(axis=1), MAX_INT32)
    if (out < 0).any():
        raise AssertionError("referent_caps: a negative cap answer cannot merge as an extra")
    return out.astype(np.int32)


#: worker processes that solve the numpy referent (``referent_mismatches``);
#: at most 1, the referent runs in this process. ``main`` sets it to the
#: host's cores
REFERENT_PROCESSES = 1
#: rows a referent worker solves at a time
REFERENT_PIECE = 1024
#: what the forked referent workers read: (engine, problems, compiled
#: placements, extra, view, got)
_REFERENT: tuple | None = None


def _referent_piece(start: int) -> int:
    """The rows of ``_REFERENT`` from ``start`` re-solved on the host: the
    engine's packing, the numpy estimate (the engine's tiny-batch mirror
    ``_availability_np``, merged with the rows' static-assignment quota caps
    from ``referent_caps`` when the engine has any and with ``extra``'s
    answer when given), the host spread selection and the numpy divider.
    Returns how many rows' ``view(problem, result)`` differ from ``got``."""
    from karmada_tpu_torch.refimpl import assign_batch_np
    from karmada_tpu_torch.scheduler.spread import select_clusters_batch

    engine, problems, compiled_all, extra, view, got = _REFERENT
    end = start + REFERENT_PIECE
    chunk, compiled = problems[start:end], compiled_all[start:end]
    feasible, strategy, replicas, static_w, requests, prev, fresh = (
        engine._pack_chunk(chunk, compiled, 0)
    )
    caps = referent_caps(engine, chunk, requests)
    extras = (() if caps is None else (caps,)) + (
        () if extra is None else (extra(requests, replicas),))
    avail = engine._availability_np(requests, replicas, extras=extras)
    cand = select_clusters_batch(engine.snapshot, chunk, compiled, 0, feasible, avail, prev)
    assignment, unsched = assign_batch_np(
        strategy, replicas, cand, static_w, avail, prev, fresh
    )
    want = engine._unpack(chunk, compiled, 0, cand, assignment, unsched)
    return sum(view(p, r) != g for p, r, g in zip(chunk, want, got[start:end]))


def referent_mismatches(engine, problems, got, view, extra=None) -> int:
    """Every row of ``problems`` re-solved by the numpy referent
    (``_referent_piece``), each result read through ``view(problem,
    result)`` and compared with the same row of ``got``. Returns the rows
    that differ. Rows are solved independently, so ``problems`` may be any
    sub-list of a wave. The placements are compiled first, in this process;
    with ``REFERENT_PROCESSES`` above 1 the pieces are solved by that many
    forked processes, which inherit the inputs and send back only their
    counts (none of them touches the card). The collector's generations are
    frozen across the fork, so that no child's collection copies the
    parent's heap."""
    import gc
    import multiprocessing

    global _REFERENT
    compiled_all = [engine._compiled(p.placement) for p in problems]
    starts = range(0, len(problems), REFERENT_PIECE)
    _REFERENT = (engine, problems, compiled_all, extra, view, got)
    try:
        workers = min(REFERENT_PROCESSES, len(starts))
        if workers <= 1:
            return sum(map(_referent_piece, starts))
        gc.freeze()
        pool = multiprocessing.get_context("fork").Pool(workers)
        try:
            return sum(pool.map(_referent_piece, starts, chunksize=1))
        finally:
            pool.terminate()
            pool.join()
            gc.unfreeze()
    finally:
        _REFERENT = None


def result_view(problem, r) -> tuple:
    """What ``oracle_check`` compares of a result."""
    return r.key, r.clusters, r.error, r.feasible


def oracle_check(engine, problems, results, extra=None) -> int:
    """Every row against the numpy referent (key, placements, error and
    feasible set); ``problems`` may be any sub-list of a wave with its
    results (a quota'd wave checks its admitted rows). Returns the number
    of rows that differ."""
    got = [result_view(p, r) for p, r in zip(problems, results)]
    return referent_mismatches(engine, problems, got, result_view, extra)


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
    """One config through the port's default route: a first pass, then
    ``passes`` timed passes of the same problem list, every row of the
    first pass checked against the numpy divider."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler

    t0 = time.perf_counter()
    snap, problems = build_workload(karmada_tpu_torch, config, bindings, clusters)
    build_s = time.perf_counter() - t0
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    reset_counts()
    t0 = time.perf_counter()
    results = engine.schedule(problems)
    sync(device)
    first_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    bad = oracle_check(engine, problems, results)
    check_s = time.perf_counter() - t0
    first = outcomes(results)
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        again = engine.schedule(problems)
        sync(device)
        walls.append(time.perf_counter() - t0)
    if outcomes(again) != first:
        raise AssertionError(f"config {config}: passes disagree")
    ok = sum(r.success for r in results)
    wall = statistics.median(walls)
    route = "fleet" if engine._fleet is not None else "general"
    print(
        f"# config {config}: {len(problems)} bindings x {snap.num_clusters} clusters "
        f"({route} route); {ok} scheduled; first pass {first_s:.3f} s; pass p50 "
        f"{wall:.4f} s (walls {[round(w, 4) for w in walls]}); "
        f"{len(problems) / wall:.0f} bindings/s; first-pass launches "
        f"{ {k: v for k, v in launches.items() if v} }; numpy-divider check "
        f"{len(problems) - bad} ok / {bad} bad ({check_s:.1f} s); build {build_s:.1f} s; "
        f"card {card}",
        flush=True,
    )
    if bad:
        raise AssertionError(f"config {config}: {bad} rows differ from the numpy divider")
    return {"config": config, "bindings": len(problems), "clusters": snap.num_clusters,
            "pass_s": wall, "walls": walls, "first_pass_s": first_s,
            "bindings_per_s": len(problems) / wall, "launches": launches,
            "route": route}


# --------------------------------------------------------------------------
# launch counters
# --------------------------------------------------------------------------

#: every kernel wrapper: name -> (route, source, the JAX program it replaces)
KERNELS = {
    "estimate_merge": ("cuda", "karmada_tpu_torch/csrc/estimate_merge.cu",
                       "karmada_tpu/ops/estimate.py:25"),
    "profile_table": ("cuda", "karmada_tpu_torch/csrc/estimate_merge.cu",
                      "karmada_tpu/scheduler/core.py:2256"),
    "divide_replicas": ("cuda", "karmada_tpu_torch/csrc/divide_replicas.cu",
                        "karmada_tpu/ops/divide.py:233"),
    "fleet_masks": ("cuda", "karmada_tpu_torch/csrc/fleet_masks.cu",
                    "karmada_tpu/scheduler/fleet.py:184"),
    "fleet_bits": ("cuda", "karmada_tpu_torch/csrc/fleet_masks.cu",
                   "karmada_tpu/scheduler/fleet.py:788"),
    "fleet_diff": ("cuda", "karmada_tpu_torch/csrc/fleet_diff.cu",
                   "karmada_tpu/scheduler/fleet.py:493"),
    "fleet_entry_rows": ("cuda", "karmada_tpu_torch/csrc/fleet_diff.cu",
                         "karmada_tpu/scheduler/fleet.py:718"),
    "fleet_wire": ("cuda", "karmada_tpu_torch/csrc/fleet_wire.cu",
                   "karmada_tpu/scheduler/fleet.py:652"),
    "entry_wire": ("cuda", "karmada_tpu_torch/csrc/fleet_wire.cu",
                   "karmada_tpu/scheduler/fleet.py:155"),
    "scatter_rows": ("cuda", "karmada_tpu_torch/csrc/scatter_rows.cu",
                     "karmada_tpu/scheduler/fleet.py:1120"),
    "gather_meta": ("cuda", "karmada_tpu_torch/csrc/scatter_rows.cu",
                    "karmada_tpu/scheduler/fleet.py:828"),
    "model_overlay": ("cuda", "karmada_tpu_torch/csrc/model_estimate.cu",
                      "karmada_tpu/scheduler/core.py:2263"),
    "estimate_merge_table": ("cuda", "karmada_tpu_torch/csrc/estimate_merge.cu",
                             "karmada_tpu/scheduler/core.py:2376"),
    "node_sum_estimate": ("cuda", "karmada_tpu_torch/csrc/node_sum.cu",
                          "karmada_tpu/estimator/accurate.py:255"),
    "quota_admit": ("cuda", "karmada_tpu_torch/csrc/quota_admit.cu",
                    "karmada_tpu/ops/quota.py:64"),
    "quota_cluster_caps": ("cuda", "karmada_tpu_torch/csrc/quota_caps.cu",
                           "karmada_tpu/ops/quota.py:150"),
    "quota_caps_fold": ("cuda", "karmada_tpu_torch/csrc/quota_caps.cu",
                        "karmada_tpu/scheduler/core.py:2295"),
    "explain_pass": ("cuda", "karmada_tpu_torch/csrc/explain_pass.cu",
                     "karmada_tpu/ops/explain.py:68"),
    "preempt_select": ("cuda", "karmada_tpu_torch/csrc/preempt_select.cu",
                       "karmada_tpu/ops/preempt.py:72"),
    "entry_diff": ("cuda", "karmada_tpu_torch/csrc/entry_diff.cu",
                   "karmada_tpu/scheduler/fleet.py:232"),
    "first_fit_group": ("cuda", "karmada_tpu_torch/csrc/first_fit_group.cu",
                        "karmada_tpu/ops/masks.py:100"),
}
#: the kernels each driven path must launch
PATH_KERNELS = {
    "config 5 fleet": ("profile_table", "divide_replicas", "fleet_masks",
                       "fleet_diff", "fleet_entry_rows", "fleet_wire",
                       "entry_wire", "gather_meta"),
    "mixed fleet": ("profile_table", "divide_replicas", "fleet_masks",
                    "fleet_bits", "fleet_diff", "fleet_wire", "scatter_rows"),
    "config 5 general": ("estimate_merge", "divide_replicas"),
    "config 5 models fleet": ("profile_table", "model_overlay", "divide_replicas",
                              "fleet_masks", "fleet_diff", "fleet_entry_rows",
                              "fleet_wire", "entry_wire"),
    "config 5 models general": ("profile_table", "model_overlay",
                                "estimate_merge_table", "divide_replicas"),
    "estimator": ("profile_table", "estimate_merge_table", "divide_replicas",
                  "node_sum_estimate"),
    "quota fleet": ("quota_admit", "quota_caps_fold", "profile_table", "divide_replicas",
                    "fleet_masks", "fleet_diff", "fleet_wire"),
    "quota general": ("quota_admit", "quota_cluster_caps", "profile_table",
                      "estimate_merge_table", "divide_replicas"),
    "ranked": ("quota_admit", "quota_cluster_caps", "profile_table",
               "estimate_merge_table", "first_fit_group", "divide_replicas"),
    "explain fleet": ("explain_pass", "divide_replicas"),
    "explain quota": ("explain_pass",),
    "preemption": ("preempt_select", "first_fit_group", "divide_replicas", "fleet_masks"),
    "config 5 legacy": ("profile_table", "divide_replicas", "fleet_masks",
                        "entry_diff", "scatter_rows", "entry_wire"),
    "mixed fleet legacy": ("profile_table", "divide_replicas", "fleet_masks",
                           "fleet_bits", "entry_diff", "scatter_rows", "entry_wire"),
    "wide fleet": ("profile_table", "divide_replicas", "fleet_masks", "fleet_diff",
                   "fleet_wire"),
    "wide quota": ("quota_admit", "profile_table", "divide_replicas"),
    "wide preemption": ("preempt_select",),
    "controller cold": ("profile_table", "divide_replicas", "fleet_masks", "fleet_diff",
                        "fleet_wire"),
    "controller quota": ("quota_admit", "quota_caps_fold", "profile_table",
                         "divide_replicas", "fleet_masks", "fleet_diff", "fleet_wire"),
    "controller preemption": ("preempt_select", "first_fit_group", "divide_replicas",
                              "fleet_masks"),
    "plane cold": ("profile_table", "divide_replicas", "fleet_masks", "fleet_diff",
                   "fleet_wire"),
    # a displaced binding whose surviving clusters all report Healthy loses
    # its eviction task before the scheduler's drain and rides the fleet
    # table; one that keeps its task takes the general route (eviction rows
    # are off the fleet, as in the JAX engine). estimate_merge is required
    # here only because the graceful-eviction worker drains BEFORE the
    # scheduler's worker in a settle: it reads the survivors' status as it
    # stood before the scheduler's drain, so some rows keep their tasks.
    # Were the scheduler to drain first, or the status fresher, every
    # displaced row would ride the fleet table and estimate_merge would not
    # launch, with no fault in the failover path (PERF.md §7). The
    # descheduler's 200 rows are under fleet_threshold
    "plane failover": ("profile_table", "estimate_merge", "divide_replicas", "fleet_masks",
                       "fleet_diff", "fleet_wire", "scatter_rows"),
    "plane deschedule": ("estimate_merge", "divide_replicas"),
    # the FederatedHPA scale-up (800 rows) and the cron (500 rows) passes
    # ride the fleet table like the scale wave: the changed rows upserted
    # (K6), phase A and the wire; K1's table form runs only when Cluster
    # updates since the last pass give the engine a new snapshot (the
    # recovery wave's reach the scale-up pass), which these waves do not
    # cause themselves. The 200-row scale-down is under fleet_threshold: the
    # general route. The resumed plane's first drift round dry-solves every
    # binding on the resumed scheduler's new engine: a cold fleet pass,
    # phase B over every row (the re-placement of its budget of 64 rows is a
    # chunk the numpy divider answers on the host)
    "plane autoscale up": ("divide_replicas", "fleet_masks", "fleet_diff", "fleet_wire",
                           "scatter_rows"),
    "plane autoscale down": ("estimate_merge", "divide_replicas"),
    "plane cron": ("divide_replicas", "fleet_masks", "fleet_diff", "fleet_wire",
                   "scatter_rows"),
    "plane resume drift round": ("profile_table", "divide_replicas", "fleet_masks",
                                 "fleet_diff", "fleet_entry_rows", "fleet_wire", "entry_wire"),
    # the solver sidecar's config-5 requests: the cold request's table, the
    # repeated and re-synced requests' diff route, the drift request's rebuild
    "sidecar": ("profile_table", "divide_replicas", "fleet_masks", "fleet_diff"),
    # the estimator-aware sidecar: the estimator servers' node sums (K8),
    # their answers folded by K1's merge form on the general route
    "sidecar estimator": ("profile_table", "estimate_merge_table", "divide_replicas",
                          "node_sum_estimate"),
    # SchedulerController(solver=...): the cold wave on the sidecar's engine,
    # the fallback wave on the controller's own engine, both on the card
    "sidecar controller": ("profile_table", "divide_replicas", "fleet_masks", "fleet_diff",
                           "fleet_wire"),
}


def wrappers() -> dict:
    from karmada_tpu_torch import ops
    from karmada_tpu_torch.estimator import accurate
    from karmada_tpu_torch.models import modeling
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    mods = (ops, fk, modeling, accurate)
    return {name: getattr(next(m for m in mods if hasattr(m, name)), name)
            for name in KERNELS}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


class uncounted:
    """Launches inside the block (kernel-vs-plain checks) leave every
    counter as it was."""

    def __enter__(self):
        self.saved = read_counts()

    def __exit__(self, *exc):
        for name, fn in wrappers().items():
            fn.launches = self.saved[name]


def require_launched(path: str, counts: dict) -> None:
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")


def outcomes(results) -> list:
    return [(r.key, dict(r.clusters), r.error, r.affinity_name, tuple(r.feasible))
            for r in results]


# --------------------------------------------------------------------------
# fleet kernels against their plain versions, on a live table's inputs
# --------------------------------------------------------------------------


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pass_wire_bytes(changed, dcount, deltas, out, d_cap: int) -> int:
    """What K5's phase-A wire must move on these inputs: every changed
    flag, the meta word, delta count and table row of each changed row,
    the d_slots delta words of each changed row with dcount <= 62 (with a
    delta section), and the wire and row buffer (``out``) written."""
    n_ch = int(changed.sum().item())
    n_ct = int((changed & (dcount <= 62)).sum().item()) if d_cap else 0
    return changed.numel() + 12 * n_ch + 4 * deltas.shape[1] * n_ct + _nbytes(*out)


def device_ops(fn) -> list:
    """The device operations (kernels, memsets, copies) one call of ``fn``
    runs, by name, as torch.profiler lists them; empty if the profiler
    sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def check_device_ops(label: str, fn, at_most: int | None = None,
                     banned=("CatArrayBatchedCopy", "Memcpy DtoD")) -> None:
    """Print the device operations of one call of ``fn``; fail if they
    are more than ``at_most`` or include a concatenation or a
    device-to-device copy."""
    ops = device_ops(fn) or device_ops(fn)  # a trace that caught nothing, once more
    if not ops:
        print(f"# device operations of {label}: not measured (the profiler saw none)",
              flush=True)
        return
    counts = {}
    for name in ops:
        counts[name[:40]] = counts.get(name[:40], 0) + 1
    print(f"# device operations of {label}: {len(ops)}: {counts}", flush=True)
    bad = [n for n in ops if any(b in n for b in banned)]
    if bad or (at_most is not None and len(ops) > at_most):
        raise AssertionError(f"{label}: {len(ops)} device operations (at most {at_most}), "
                             f"concatenations or copies {bad}")


def masked_select_line(label: str, values, flags, card: str) -> None:
    """``torch.masked_select``'s time on the same flags: the uncapped
    compaction alone, which synchronises with the host for its output
    size; a yardstick, not a library version of the wire."""
    import torch

    ms = cuda_ms(lambda: torch.masked_select(values, flags))
    print(f"# torch.masked_select on {label}'s flags (uncapped, no wire, "
          f"synchronises): {ms:.4f} ms; card {card}", flush=True)


def compare(name: str, got, want) -> int:
    """Max abs difference of two (tuples of) integer/bool tensors; raises
    unless exactly 0."""
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {tuple(g.shape)}/{g.dtype} vs "
                                 f"{tuple(w.shape)}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {err})")
    return err


def report(name, ms, plain_ms, nbytes, ops, card, lib_ms=None) -> dict:
    """Print a kernel's times beside its bound; the stats of its JSON entry."""
    bound_ms, bound_by = _bound(nbytes, ops)
    print(f"# kernel {name}: exact; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms by {bound_by}"
          + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
          + f"); card {card}", flush=True)
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def no_times() -> dict:
    """A CPU rehearsal's stats: nothing is timed."""
    return {"max_abs_err": 0, "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": None, "library_ms": None}


def timed(name, kern, plain, nbytes, ops, card, reps=10, library=None) -> dict:
    import torch

    if not torch.cuda.is_available():
        kern(), plain()
        return no_times()
    ms = cuda_ms(kern, reps)
    plain_ms = cuda_ms(plain, max(3, reps // 3), batches=3)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    return report(name, ms, plain_ms, nbytes, ops, card, lib_ms)


def check_fleet_kernels(table, card: str) -> dict:
    """K3-K6 against their plain versions on the table's live inputs, after
    a snapshot drift has rebuilt the tables but before the pass: K3 on the
    first chunk (also with the pairs widened to k_prev = 128), over every
    row in one launch, and (bits form) on every row, K2 -> K4 phase A on
    every chunk against cloned residents, K5's phase-A wire with the caps the
    table picks for this pass, K4 phase A again on a partial batch (a
    permuted subset padded with -1, as the engine runs one), K4 phase B and
    K5's entry wire over the changed rows, K6 on a dirty-row set padded as
    the table pads it. Exact equality.

    K4 phase A is timed inside the all-rows check, by CUDA events around
    each chunk's launch of each version: every chunk writes rows no earlier
    launch wrote, so the time is that of a real pass's diff, changes
    included."""
    import torch
    from karmada_tpu_torch.ops import divide_replicas, divide_replicas_ref
    from karmada_tpu_torch.scheduler import fleet_kernels as fk
    from karmada_tpu_torch.scheduler.fleet import _cap_round, _pow2

    stats = {}
    tables, state = table._dev_tables, table._dev_state
    n = table.n_rows
    chunk = min(table.chunk, _pow2(max(n, 256)))  # the table's adaptive chunk
    n_pad = -(-n // chunk) * chunk
    rows_all = table._all_rows_dev
    if rows_all is None or rows_all.shape[0] != n_pad:
        raise AssertionError("the table has no all-rows index of this pass's size")
    c = tables[1].shape[1]
    k_prev = state[6].shape[1]
    rows0 = rows_all[:chunk]

    # K3 masks on chunk 0
    got = fk.fleet_masks(*tables, rows0, *state)
    want = fk.fleet_masks_ref(*tables, rows0, *state)
    stats["fleet_masks"] = dict(timed(
        "fleet_masks", lambda: fk.fleet_masks(*tables, rows0, *state),
        lambda: fk.fleet_masks_ref(*tables, rows0, *state),
        _nbytes(rows0) + chunk * (5 * 4 + 1 + 2 * 4 * k_prev)
        + _nbytes(*[t for t in got]) + _nbytes(tables[4]),
        chunk * c * 10 + chunk * k_prev, card,
    ), max_abs_err=compare("fleet_masks", tuple(got), tuple(want)))
    # K3 at k_prev = 128 on chunk 0 (the table's pairs, each row's first
    # again, random ones), and over every row in one launch (past 65535)
    state128 = widen_prev(state, 128, c, SEED + 128)
    compare("fleet_masks k_prev=128", tuple(fk.fleet_masks(*tables, rows0, *state128)),
            tuple(fk.fleet_masks_ref(*tables, rows0, *state128)))
    timed("fleet_masks at k_prev=128 (config-5 chunk 0)",
          lambda: fk.fleet_masks(*tables, rows0, *state128),
          lambda: fk.fleet_masks_ref(*tables, rows0, *state128),
          _nbytes(rows0) + chunk * (5 * 4 + 1 + 2 * 4 * 128) + _nbytes(*got)
          + _nbytes(tables[4]), chunk * c * 10 + chunk * 128, card, reps=5)
    del state128
    whole = fk.fleet_masks(*tables, rows_all, *state)
    for i in range(n_pad // chunk):
        rc = rows_all[i * chunk:(i + 1) * chunk]
        compare("fleet_masks over every row", tuple(x[i * chunk:(i + 1) * chunk] for x in whole),
                tuple(fk.fleet_masks_ref(*tables, rc, *state)))
    print(f"# fleet_masks: k_prev=128 on chunk 0 exact; one launch over all {n_pad} rows "
          f"exact; card {card}", flush=True)
    del whole
    # K3 bits form over every row
    got_b = fk.fleet_bits(*tables, rows_all, *state)
    want_b = fk.fleet_bits_ref(*tables, rows_all, *state)
    stats["fleet_bits"] = dict(timed(
        "fleet_bits", lambda: fk.fleet_bits(*tables, rows_all, *state),
        lambda: fk.fleet_bits_ref(*tables, rows_all, *state),
        _nbytes(rows_all) + n * (2 * 4 + 2 * 4 * k_prev) + _nbytes(got_b),
        # a few word operations per 32 cells: the planes are bit-packed in
        # the words' own order; plus the prev pairs' bits
        n_pad * got_b.shape[1] * 6 + n * k_prev, card, reps=3,
    ), max_abs_err=compare("fleet_bits", got_b, want_b))
    del want_b

    # K2 on chunk 0's own inputs (K3's output), and its phase split
    on_card = torch.cuda.is_available()
    k2_args, has_agg = k2_chunk_args(table)
    got2 = divide_replicas(*k2_args, has_agg)
    want2 = divide_replicas_ref(*k2_args, has_agg)
    err = compare("divide_replicas config-5 chunk", (got2.assignment, got2.unschedulable),
                  (want2.assignment, want2.unschedulable))
    del got2, want2
    timed(f"divide_replicas on config-5 chunk 0 ({chunk}x{c}, max abs err {err})",
          lambda: divide_replicas(*k2_args, has_agg),
          lambda: divide_replicas_ref(*k2_args, has_agg),
          _nbytes(*k2_args) + chunk * c * 4 + chunk,
          chunk * c * OPS_PER_ELEM["divide_replicas"], card)
    if on_card:
        k2_phase_split(k2_args, has_agg, "config-5 chunk 0", card)
    del k2_args

    # K2 -> K4 phase A over every chunk, against two clones of the residents

    def phase_a(rows_b, all_rows: bool, times=None, base=None):
        """K3 -> K2 -> K4 and K4's plain version over the chunks of
        ``rows_b``, each on its own clone of the residents (the table's,
        or ``base``): the chunks' outputs and both clones, equal;
        per-chunk device ms in ``times``."""
        base = base or (table._res_dense, table._res_meta)
        st_k = (base[0].clone(), base[1].clone())
        st_r = (base[0].clone(), base[1].clone())
        parts = []
        for i in range(rows_b.shape[0] // chunk):
            rows_c = rows_b[i * chunk : (i + 1) * chunk]
            m = fk.fleet_masks(*tables, rows_c, *state)
            a, u = divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w,
                                   m.avail, m.prev, m.fresh, has_agg)
            kw = dict(all_rows=all_rows, offset=i * chunk, d_slots=min(64, c))
            args = (a, u, m.feasible, m.strategy, rows_c)
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                torch.cuda._sleep(SPIN_CYCLES // 10)  # hides the wrapper's host work
                ev[0].record()
            g = fk.fleet_diff(*args, *st_k, **kw)
            if on_card:
                ev[1].record()
                ev[2].record()
            w = fk.fleet_diff_ref(*args, *st_r, **kw)
            if on_card:
                ev[3].record()
                ev[3].synchronize()
                if times is not None:
                    times.append((ev[0].elapsed_time(ev[1]),
                                  ev[2].elapsed_time(ev[3])))
            compare("fleet_diff", tuple(g), tuple(w))
            parts.append(g)
        err = compare(f"fleet_diff residents (all_rows={all_rows})", st_k, st_r)
        del st_r
        return parts, st_k, err

    k4_times = []
    parts, st_k, err = phase_a(rows_all, True, k4_times)
    k4_bytes = (chunk * c * (4 + 1 + 1 + 1) + chunk * (1 + 4 + 4 + 4 * 2)
                + _nbytes(*parts[0]))
    stats["fleet_diff"] = dict(report(
        "fleet_diff (per chunk, mean over a phase-A pass)",
        statistics.mean(t[0] for t in k4_times),
        statistics.mean(t[1] for t in k4_times),
        k4_bytes, chunk * c * 6, card,
    ) if on_card else no_times(), max_abs_err=err)
    # the partial-batch branch: a permuted subset padded with -1 to whole
    # chunks, results written back by row index (padding rows write nothing)
    sub = np.random.default_rng(SEED + 4).permutation(n)[: 2 * chunk + chunk // 3]
    rows_p = torch.full((-(-sub.size // chunk) * chunk,), -1, dtype=torch.int32,
                        device=rows_all.device)
    rows_p[: sub.size] = torch.from_numpy(sub.astype(np.int32)).to(rows_all.device)
    _, st_p, _ = phase_a(rows_p, False)
    print(f"# fleet_diff partial batch: {sub.size} permuted rows padded to "
          f"{rows_p.numel()}, exact", flush=True)
    del st_p

    # K5 phase-A wire with the caps this pass picks (the table's own rule:
    # this pass follows steady passes, so the table keeps its caps), on
    # this churn pass's phase-A outputs and on a steady pass's (phase A
    # again over the residents the first run wrote: no row changes)
    m_cap, d_cap = table._m_cap_cur, table._d_cap_cur or 0
    steady_parts, st_s, _ = phase_a(rows_all, True, base=st_k)
    del st_s
    churn_changed = torch.cat([p.changed for p in parts])
    for kind, wparts in (("churn", parts), ("steady", steady_parts)):
        changed = torch.cat([p.changed for p in wparts])
        dcount = torch.cat([p.dcount for p in wparts])
        wire_in = (changed, torch.cat([p.meta for p in wparts]), dcount, rows_all,
                   torch.cat([p.deltas for p in wparts]))
        kw = dict(m_cap=m_cap, d_cap=d_cap)
        got_w = fk.fleet_wire(*wire_in, **kw)
        err = compare(f"fleet_wire {kind}", tuple(got_w),
                      tuple(fk.fleet_wire_ref(*wire_in, **kw)))
        total = int(changed.sum().item())
        if (total == 0) != (kind == "steady"):
            raise AssertionError(f"fleet_wire {kind} inputs: {total} changed rows")
        n_ct = int((changed & (dcount <= 62)).sum().item())
        st = timed(f"fleet_wire ({kind} phase-A inputs: {total} changed rows of {n}, "
                   f"{n_ct} with dcount <= 62, m_cap {m_cap}, d_cap {d_cap})",
                   lambda: fk.fleet_wire(*wire_in, **kw),
                   lambda: fk.fleet_wire_ref(*wire_in, **kw),
                   pass_wire_bytes(changed, dcount, wire_in[4], got_w, d_cap),
                   n_pad * 4 + n_ct * wire_in[4].shape[1] * 4, card)
        if kind == "churn":
            stats["fleet_wire"] = dict(st, max_abs_err=err)
        if on_card:
            old_bound, _ = _bound(_nbytes(*wire_in) + _nbytes(*got_w), 0)
            print(f"# fleet_wire {kind}: the bound counting every delta word (the "
                  f"parent's): {old_bound:.6f} ms; card {card}", flush=True)
            masked_select_line(f"fleet_wire {kind}", wire_in[1], changed, card)
            check_device_ops(f"fleet_wire ({kind})", lambda: fk.fleet_wire(*wire_in, **kw),
                             at_most=4)
    del steady_parts, wire_in
    if on_card:
        pi = pass_inputs(table)
        res_p = (table._res_dense.clone(), table._res_meta.clone())
        check_device_ops("fleet_pass (the whole dense phase A)", lambda: fk.fleet_pass(
            *tables, rows_all, *state, *res_p, chunk=chunk, n_chunks=n_pad // chunk, wide=pi["wide"], fast=pi["fast"],
            has_aggregated=pi["has_agg"], all_rows=True, m_cap=m_cap, d_cap=d_cap))
        del res_p

    # K4 phase B + K5 entry wire over the churn pass's changed rows, as the
    # exact fetch
    ch_rows = torch.nonzero(churn_changed).flatten().to(torch.int32)
    m_pad = max(2048, _pow2(max(int(ch_rows.numel()), 1)))
    rows_b = torch.full((m_pad,), -1, dtype=torch.int32, device=ch_rows.device)
    rows_b[: ch_rows.numel()] = ch_rows
    k_out = min(c, _pow2(int(table._st["replicas"][:n].max())))
    res_d = st_k[0]
    got_e = fk.fleet_entry_rows(res_d, rows_b, k_out)
    want_e = fk.fleet_entry_rows_ref(res_d, rows_b, k_out)
    valid_b = int(ch_rows.numel())
    stats["fleet_entry_rows"] = dict(timed(
        "fleet_entry_rows", lambda: fk.fleet_entry_rows(res_d, rows_b, k_out),
        lambda: fk.fleet_entry_rows_ref(res_d, rows_b, k_out),
        _nbytes(rows_b) + valid_b * c + _nbytes(got_e), valid_b * c * 3, card, reps=3,
    ), max_abs_err=compare("fleet_entry_rows", got_e, want_e))
    e_cap = _cap_round(max(int((got_e > 0).sum().item()), 1))
    for pack21 in (True, False):
        kw = dict(e_cap=e_cap, byte_wire=True, pack21=pack21)
        got_x = fk.entry_wire(got_e, **kw)
        want_x = fk.entry_wire_ref(got_e, **kw)
        err = compare(f"entry_wire pack21={pack21}", got_x, want_x)
        if pack21 == (c <= 1 << 13):
            stats["entry_wire"] = dict(timed(
                f"entry_wire (phase B: {tuple(got_e.shape)} words, e_cap {e_cap}, "
                f"pack21 {pack21})", lambda: fk.entry_wire(got_e, **kw),
                lambda: fk.entry_wire_ref(got_e, **kw),
                _nbytes(got_e) + _nbytes(got_x), got_e.numel() * 3, card,
            ), max_abs_err=err)
            if on_card:
                masked_select_line("entry_wire phase B", got_e, got_e > 0, card)
                check_device_ops("entry_wire (phase B)",
                                 lambda: fk.entry_wire(got_e, **kw), at_most=3)
    compare("entry_wire int32 form",
            fk.entry_wire(got_e, e_cap=e_cap, byte_wire=False),
            fk.entry_wire_ref(got_e, e_cap=e_cap, byte_wire=False))
    del want_e, got_e

    # K6 on a dirty set of 300 random rows, pow2-padded to 512 by repeating
    # the first row and its values as the table's _sync_device pads it, and
    # the meta gather
    rng = np.random.default_rng(SEED + 6)
    k_u, k = 300, 512
    pick = rng.choice(n, k_u, replace=False)
    src = rng.permutation(n)[:k_u]
    pick = np.concatenate([pick, np.full(k - k_u, pick[0])])
    src = np.concatenate([src, np.full(k - k_u, src[0])])
    rows6 = torch.from_numpy(pick.astype(np.int64)).to(rows_all.device)
    vals = tuple(
        torch.from_numpy(np.ascontiguousarray(table._st[f][src])).to(rows_all.device)
        for f in ("cp_idx", "gvk_idx", "prof_idx", "replicas", "strategy", "fresh",
                  "prev_sites", "prev_counts")
    )
    s_k = tuple(t.clone() for t in state)
    s_r = tuple(t.clone() for t in state)
    fk.scatter_rows(s_k, rows6, vals)
    fk.scatter_rows_ref(s_r, rows6, vals)
    err = compare("scatter_rows", s_k, s_r)
    s_l = tuple(t.clone() for t in state)

    def library():
        for a_, v_ in zip(s_l, vals):
            a_.index_copy_(0, rows6, v_)

    stats["scatter_rows"] = dict(timed(
        "scatter_rows", lambda: fk.scatter_rows(s_k, rows6, vals),
        lambda: fk.scatter_rows_ref(s_r, rows6, vals),
        # every value read once, each distinct row written once
        _nbytes(rows6) + _nbytes(*vals) * (k + k_u) // k, k * 8, card,
        library=library,
    ), max_abs_err=err)
    # the overflow gather's rows, padded as the table pads them
    rows_g = torch.full((max(4096, _pow2(max(valid_b, 1))),), -1, dtype=torch.int32,
                        device=rows_b.device)
    rows_g[:valid_b] = ch_rows
    got_g = fk.gather_meta(st_k[1], rows_g)
    want_g = fk.gather_meta_ref(st_k[1], rows_g)
    stats["gather_meta"] = dict(timed(
        "gather_meta", lambda: fk.gather_meta(st_k[1], rows_g),
        lambda: fk.gather_meta_ref(st_k[1], rows_g),
        _nbytes(rows_g) * 2 + _nbytes(got_g), rows_g.numel() * 3, card,
    ), max_abs_err=compare("gather_meta", got_g, want_g))
    if torch.cuda.is_available():
        import launch_floors

        run = launch_floors.floor_entry("scatter_rows", rows_all.device)
        widest = launch_floors.scatter_floor_arg([v[0].numel() * v.element_size() for v in vals])
        for name, a, b in (("scatter_rows", k, len(vals)), ("gather_meta", rows_g.numel(), 0)):
            fl = cuda_ms(lambda: run(a, b, widest))
            print(f"# launch floor at K6's {name} grid ({a} rows"
                  + (f" x {b} fields" if b else "") + f"): {fl:.4f} ms (an empty kernel at its "
                  f"grid; K6 {stats[name]['ms']:.4f} ms, {stats[name]['ms'] / fl:.2f}x the "
                  f"floor); card {card}", flush=True)
    del st_k, s_k, s_r, s_l
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return stats


#: the edge batches' cluster counts (words, 16-B vectors and tiles ending
#: part-way) and previous-site widths
FLEET_EDGE_C = (1, 31, 33, 255, 257, 1000, 5000)
FLEET_EDGE_K_PREV = (1, 32, 128)


def fleet_edge_tables(rng, c: int, k_prev: int, n: int = 512, cap: int = 640,
                      out_of_range: bool = False) -> dict:
    """K3/K4 inputs on which the kernels must stay exact. Table row r takes
    the previous-site kind r % 8: distinct sites; duplicate sites whose
    counts add; a site whose int32 sum wraps negative; sums that wrap to
    exactly 0 (and counts that cancel); negative counts; every one of the
    k_prev pairs real; a real pair at site 0 after padding pairs (0, 0); no
    pair at all. The slot planes carry set bits past C in their last byte
    (never a cluster). ``rows`` (n entries) names table rows in permuted
    order, every 7th entry and the last eighth -1 (padding). With
    ``out_of_range``, kind-0 rows also name sites outside [0, C), which the
    kernels drop as the plain version does (the JAX scatter wraps negative
    ones, so the CPU tests leave them out). Returns numpy ``tables``
    (cp_bits, cp_static, gvk_bits, prof_table, incomplete_en), ``state``
    (cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh, prev_sites,
    prev_counts) and ``rows``."""
    i32min, i32max = -(2**31), 2**31 - 1
    u, g, p = 5, 3, 4

    def pack(m):
        b = np.packbits(m, axis=1, bitorder="little")
        if c % 8:
            b[::2, -1] |= np.uint8((0xFF << (c % 8)) & 0xFF)
        return b

    cp_bits = np.concatenate([pack(rng.random((u, c)) < 0.75),
                              pack(rng.random((u, c)) < 0.8)], axis=1)
    cp_static = rng.integers(-3, 50, (u, c)).astype(np.int32)
    gvk_bits = pack(rng.random((g, c)) < 0.7)
    prof = rng.integers(-1, 300, (p, c)).astype(np.int32)
    prof[0] = i32max  # a profile requesting nothing
    prof[1, rng.random(c) < 0.3] = -1
    incomplete = rng.random(c) < 0.5
    replicas = rng.integers(0, 100, cap).astype(np.int32)
    replicas[rng.random(cap) < 0.1] = 0
    sites = np.zeros((cap, k_prev), np.int32)
    counts = np.zeros((cap, k_prev), np.int32)
    k = k_prev
    for r in range(cap):
        kind = r % 8
        s0, s1 = (int(x) for x in rng.integers(0, c, 2))
        if kind == 0:  # distinct sites
            m = min(k, c, int(rng.integers(1, 9)))
            sites[r, :m] = rng.choice(c, m, replace=False)
            counts[r, :m] = rng.integers(1, 30, m)
            if out_of_range and r % 16 == 0:
                sites[r, 0] = c + int(rng.integers(0, 5)) if r % 32 else -1 - int(rng.integers(0, 5))
        elif kind == 1:  # duplicate sites: their counts add
            m = min(k, 6)
            sites[r, :m] = np.array([s0, s1])[rng.integers(0, 2, m)]
            counts[r, :m] = rng.integers(1, 30, m)
        elif kind == 2:  # the int32 sum wraps negative
            sites[r, :2] = s0
            counts[r, :2] = [i32max, int(rng.integers(1, 100))][:k]
            if k == 1:
                counts[r, 0] = i32min
        elif kind == 3:  # sums wrapping to exactly 0, counts cancelling
            if k >= 4:
                sites[r, :4] = s0
                counts[r, :4] = 2**30
            else:
                sites[r, :2] = s0
                counts[r, :2] = i32min if k >= 2 else 0
            if k >= 6:
                sites[r, 4:6] = s1
                counts[r, 4:6] = [7, -7]
        elif kind == 4:  # negative counts; one site back above 0
            m = min(k, c, 3)
            sites[r, :m] = rng.choice(c, m, replace=False)
            counts[r, :m] = rng.integers(-50, 0, m)
            if k >= 5:
                sites[r, 3:5] = s1
                counts[r, 3:5] = [-3, 5]
        elif kind == 5:  # every pair real
            sites[r] = rng.integers(0, c, k)
            counts[r] = rng.integers(-5, 20, k)
        elif kind == 6:  # a real pair at site 0 behind the padding pairs
            sites[r, -1] = 0
            counts[r, -1] = int(rng.integers(1, 9))
    state = (
        rng.integers(0, u, cap).astype(np.int32),
        rng.integers(0, g, cap).astype(np.int32),
        rng.integers(0, p, cap).astype(np.int32),
        replicas,
        rng.integers(0, 4, cap).astype(np.int32),
        rng.random(cap) < 0.2,
        sites,
        counts,
    )
    rows = rng.permutation(cap)[:n].astype(np.int32)
    rows[::7] = -1
    rows[n - n // 8:] = -1
    return {"tables": (cp_bits, cp_static, gvk_bits, prof, incomplete),
            "state": state, "rows": rows}


def perturb_residents(rng, res_dense: np.ndarray, res_meta: np.ndarray,
                      rows: np.ndarray) -> tuple:
    """A churn against the residents a pass wrote (copies): a few cells of
    some of ``rows``' rows, every cell of one row (more changed cells than
    the 64 delta slots when C > 64) and one row's meta word only."""
    rd, rm = res_dense.copy(), res_meta.copy()
    live = np.unique(rows[rows >= 0])
    c = rd.shape[1]
    for r in rng.choice(live[2:], min(40, live.size - 2), replace=False):
        cells = rng.choice(c, min(3, c), replace=False)
        rd[r, cells] = rng.integers(0, 9, cells.size)
    rd[live[0]] = rd[live[0]] + 77  # uint8 wrap-around: every cell differs
    rm[live[1]] ^= 1 << 8  # meta-only change
    return rd, rm


def check_fleet_edges(device, card: str) -> None:
    """K3 (both forms) and K4 phase A against their plain versions on every
    edge batch (``fleet_edge_tables``, sites outside [0, C) included): for
    each C and k_prev, K3 masks chunk by chunk (256 rows), K3 bits over
    every row, and K3 -> K2 -> K4 phase A on all-rows and partial batches
    three times: from zero residents, again with no change (steady: no
    row may change), and against ``perturb_residents`` (churn: a row past
    the delta slots, a meta-only change). Exact. Then K3 masks on a
    seeded 4096 x 5000 batch, timed."""
    import torch
    from karmada_tpu_torch.ops import divide_replicas
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    rng = np.random.default_rng(SEED + 8)
    chunk = 256
    with uncounted():
        for c in FLEET_EDGE_C:
            for k_prev in FLEET_EDGE_K_PREV:
                t = fleet_edge_tables(rng, c, k_prev, out_of_range=True)
                tables = tuple(torch.from_numpy(a).to(device) for a in t["tables"])
                state = tuple(torch.from_numpy(a).to(device) for a in t["state"])
                rows = torch.from_numpy(t["rows"]).to(device)
                tag = f"C={c} k_prev={k_prev}"
                for i in range(rows.shape[0] // chunk):
                    rc = rows[i * chunk:(i + 1) * chunk]
                    compare(f"fleet_masks edges {tag}", tuple(fk.fleet_masks(*tables, rc, *state)),
                            tuple(fk.fleet_masks_ref(*tables, rc, *state)))
                compare(f"fleet_bits edges {tag}", fk.fleet_bits(*tables, rows, *state),
                        fk.fleet_bits_ref(*tables, rows, *state))
                cap = state[0].shape[0]
                d_slots = min(64, c)
                for all_rows in (True, False):
                    rows_b = rows if not all_rows else torch.where(
                        rows >= 0, torch.arange(rows.shape[0], dtype=torch.int32,
                                                device=device), -1)
                    res_k = (torch.zeros((cap, c), dtype=torch.uint8, device=device),
                             torch.zeros((cap,), dtype=torch.int32, device=device))
                    res_r = tuple(x.clone() for x in res_k)
                    for step in ("cold", "steady", "churn"):
                        if step == "churn":
                            rd, rm = perturb_residents(rng, res_k[0].cpu().numpy(),
                                                       res_k[1].cpu().numpy(),
                                                       rows_b.cpu().numpy())
                            for res in (res_k, res_r):
                                res[0].copy_(torch.from_numpy(rd))
                                res[1].copy_(torch.from_numpy(rm))
                        parts = []
                        for i in range(rows_b.shape[0] // chunk):
                            rc = rows_b[i * chunk:(i + 1) * chunk]
                            m = fk.fleet_masks(*tables, rc, *state)
                            a, u = divide_replicas(m.strategy, m.replicas, m.feasible,
                                                   m.static_w, m.avail, m.prev, m.fresh,
                                                   True)
                            kw = dict(all_rows=all_rows, offset=i * chunk, d_slots=d_slots)
                            args = (a, u, m.feasible, m.strategy, rc)
                            g = fk.fleet_diff(*args, *res_k, **kw)
                            compare(f"fleet_diff edges {tag} {step} all_rows={all_rows}",
                                    tuple(g), tuple(fk.fleet_diff_ref(*args, *res_r, **kw)))
                            parts.append(g)
                        compare(f"fleet_diff edges residents {tag} {step}", res_k, res_r)
                        changed = torch.cat([q.changed for q in parts])
                        dcount = torch.cat([q.dcount for q in parts])
                        if step == "steady" and bool(changed.any()):
                            raise AssertionError(f"fleet_diff edges {tag}: a steady pass "
                                                 f"changed rows")
                        if step == "churn" and not (
                                bool((changed & (dcount == 0)).any())
                                and (c <= 64 or int(dcount.max()) > d_slots)):
                            raise AssertionError(f"fleet_diff edges {tag}: the churn lacks "
                                                 f"a meta-only change or a row past the "
                                                 f"delta slots")
                check_entry_edges(tables, state, rows, res_k[0], tag, chunk)
        print(f"# K3 (both forms), K4 phase A, K16 (both forms) and K4's entry rows on "
              f"the edge batches (C in {FLEET_EDGE_C}, k_prev in {FLEET_EDGE_K_PREV}; "
              f"cold, steady and churn, all-rows and partial; K16 at k_out "
              f"{ENTRY_EDGE_K_OUT} with k_res = k_out + 8, entry rows at k_out "
              f"{ENTRY_EDGE_K_OUT} and C): exact; card {card}", flush=True)
        t = fleet_edge_tables(rng, 5000, 32, n=4096, cap=4096)
        tables = tuple(torch.from_numpy(a).to(device) for a in t["tables"])
        state = tuple(torch.from_numpy(a).to(device) for a in t["state"])
        rows = torch.from_numpy(t["rows"]).to(device)
        got = fk.fleet_masks(*tables, rows, *state)
        err = compare("fleet_masks seeded", tuple(got),
                      tuple(fk.fleet_masks_ref(*tables, rows, *state)))
        timed(f"fleet_masks seeded 4096x5000 edge batch (max abs err {err})",
              lambda: fk.fleet_masks(*tables, rows, *state),
              lambda: fk.fleet_masks_ref(*tables, rows, *state),
              _nbytes(rows) + 4096 * (5 * 4 + 1 + 2 * 4 * 32) + _nbytes(*got)
              + _nbytes(tables[4]), 4096 * 5000 * 10 + 4096 * 32, card)
    torch.cuda.empty_cache()


#: the edge checks' k_out values (each capped at C): one word (every row
#: with two placed cells truncates) and the fleet's widest
ENTRY_EDGE_K_OUT = (1, 128)


def entry_edge_dense(rng, res_dense: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Entry-row input from a churned dense resident (a copy): one row of
    the batch with counts 1-255 in every cell, one with 255 in every other
    cell (more nonzero cells than any k_out below C)."""
    rd = res_dense.copy()
    live = np.unique(rows[rows >= 0])
    rd[live[2]] = rng.integers(1, 256, rd.shape[1])
    rd[live[3], ::2] = 255
    return rd


def entry_edge_resident(rng, resident, rows, k_out: int) -> None:
    """A churn of a committed entry resident, in place: some of ``rows``'
    first words bumped, one word past k_out set, one row zeroed."""
    import torch

    live = np.unique(rows[rows >= 0])
    pick = torch.from_numpy(rng.choice(live[3:], min(30, live.size - 3), replace=False))
    resident[pick.to(resident.device), 0] += 1
    resident[int(live[0]), k_out] = 5
    resident[int(live[1])] = 0


def check_entry_edges(tables, state, rows, res_dense, tag: str, chunk: int) -> None:
    """K16 and K4's entry rows against their plain versions on one edge
    batch, exactly. K16: K3 -> K2 per chunk in the all-rows form and the
    gathered form (the batch's permuted rows, padding included, with one
    row named twice), at each ``ENTRY_EDGE_K_OUT`` against a
    resident 8 words wider: from a zero resident (cold), again after
    committing that pass (K6; steady: no row may change), and after
    ``entry_edge_resident`` (churn: rows must change). Entry rows: the
    batch's rows (odd and even indices, padding) over
    ``entry_edge_dense(res_dense)`` at each k_out and at C, and over the
    same table less its first row (a base pointer C bytes in)."""
    import torch
    from karmada_tpu_torch.ops import divide_replicas
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    device = rows.device
    cap, c = res_dense.shape
    n = rows.shape[0]
    rng = np.random.default_rng(c)
    rows_np = rows.cpu().numpy()
    for all_rows in (True, False):
        if all_rows:
            rows_b = torch.where(rows >= 0, torch.arange(n, dtype=torch.int32,
                                                          device=device), -1)
        else:
            rows_b = rows.clone()
            rows_b[2] = rows_b[1]  # one row named twice (rows[0] is padding)
        form = "all-rows" if all_rows else "gathered"
        divided = []
        for i in range(n // chunk):
            rc = rows_b[i * chunk:(i + 1) * chunk]
            m = fk.fleet_masks(*tables, rc, *state)
            a, u = divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w,
                                   m.avail, m.prev, m.fresh, True)
            divided.append((a, u, m.feasible, m.strategy, rc))
        for k_out in sorted({min(k, c) for k in ENTRY_EDGE_K_OUT}):
            resident = torch.zeros((cap, k_out + 8), dtype=torch.int32, device=device)
            for step in ("cold", "steady", "churn"):
                if step == "churn":
                    entry_edge_resident(rng, resident, rows_b.cpu().numpy(), k_out)
                parts = []
                for i, args in enumerate(divided):
                    kw = dict(k_out=k_out, all_rows=all_rows, offset=i * chunk)
                    got = fk.entry_diff(*args, resident, **kw)
                    compare(f"entry_diff edges {tag} {form} k_out={k_out} {step}",
                            tuple(got), tuple(fk.entry_diff_ref(*args, resident, **kw)))
                    parts.append(got)
                changed = int(torch.cat([(p.meta >> 10) & 1 for p in parts]).sum())
                if (changed > 0) != (step != "steady"):
                    raise AssertionError(f"entry_diff edges {tag} {form} k_out={k_out}: "
                                         f"{changed} changed rows on the {step} pass")
                fk.scatter_rows((resident,), torch.cat([p.commit for p in parts]),
                                (torch.cat([p.entries for p in parts]),))
    rd = torch.from_numpy(entry_edge_dense(rng, res_dense.cpu().numpy(), rows_np)).to(device)
    for k_out in sorted({min(k, c) for k in ENTRY_EDGE_K_OUT} | {c}):
        for label, dense, rows_e in (("", rd, rows),
                                     (" past row 0", rd[1:], torch.clamp(rows, max=cap - 2))):
            compare(f"fleet_entry_rows edges {tag} k_out={k_out}{label}",
                    fk.fleet_entry_rows(dense, rows_e, k_out),
                    fk.fleet_entry_rows_ref(dense, rows_e, k_out))


#: the wire edge cases (``wire_edge_batch``): phase-A wires ("pass-*")
#: and entry wires ("entry-*": standalone; "solve-*": with the metas in
#: place, as the entry-resident pass writes them)
WIRE_EDGE_CASES = (
    "pass-total0", "pass-all", "pass-cap", "pass-cap-1", "pass-cap+1", "pass-cap1",
    "pass-small", "pass-ragged", "pass-many", "pass-dcount", "pass-nodelta",
    "entry-total0", "entry-all", "entry-cap", "entry-cap-1", "entry-cap+1", "entry-cap1",
    "entry-small", "entry-ragged", "entry-many", "entry-bytes3", "entry-int32",
    *(f"entry-pack21-mod{r}" for r in range(8)),
    "solve-pack21", "solve-bytes3", "solve-int32",
)


def wire_edge_batch(rng, case: str) -> dict:
    """K5 inputs on which the wire kernels must stay exact, by the tiles of
    ``fleet_kernels.WIRE_ROW_TILE`` rows and ``WIRE_ENTRY_TILE`` words.

    Phase A ("pass-*": ``changed``, ``meta``, ``dcount``, ``rows``,
    ``deltas``, ``m_cap``, ``d_cap``): no row changed; every row changed;
    the changed-row total at m_cap, m_cap - 1 and m_cap + 1 (with the
    delta total likewise against d_cap); caps of 1; n below one tile, n
    not a multiple of the tile, n over 2000 tiles; dcount 62 and 63 at
    the contributing boundary with rows whose delta words are all zero
    and zeros between nonzero words; no delta section. Entry wires
    ("entry-*", "solve-*": ``entries``, ``e_cap``, ``byte_wire``,
    ``pack21``, ``meta``): no word positive; every word positive; the
    total at e_cap, e_cap - 1 and e_cap + 1; e_cap 1; under one tile, a
    ragged last tile, over 2000 tiles; the 21-bit form at every
    ``21 e_cap mod 8`` with runs of empty tiles (a tile's run starts
    mid-byte and its first byte draws on a value tiles back); the
    3-byte and int32 forms, negative words; the metas in place (2 bytes
    each, or int32 words)."""
    kind, _, rest = case.partition("-")
    if kind == "pass":
        n = {"pass-small": 8, "pass-ragged": 3 * 256 + 40,
             "pass-many": 2048 * 256}.get(case, 4 * 256)
        d_slots = 4 if case == "pass-many" else 64
        p_ch = {"pass-total0": 0.0, "pass-all": 1.0, "pass-many": 0.02}.get(case, 0.4)
        changed = rng.random(n) < p_ch
        meta = rng.integers(0, 1 << 10, n).astype(np.int32)
        dcount = rng.integers(0, 70, n).astype(np.int32)
        if case == "pass-dcount":
            dcount[::4] = 62
            dcount[1::4] = 63
        rows = rng.permutation(n).astype(np.int32)
        rows[rng.random(n) < 0.1] = -1
        deltas = ((rng.integers(0, 5000, (n, d_slots)) << 9)
                  | rng.integers(1, 256, (n, d_slots))).astype(np.int32)
        deltas[rng.random((n, d_slots)) < 0.3] = 0  # zeros between nonzero words
        deltas[np.arange(n) % 5 == 0] = 0  # rows whose words are all zero
        contrib = changed & (dcount <= 62)
        total = int(changed.sum())
        dtotal = int((deltas[contrib] != 0).sum())
        m_cap, d_cap = max(total, 1), max(dtotal, 1)
        if case == "pass-cap-1":
            m_cap, d_cap = max(total - 1, 1), max(dtotal - 1, 1)
        elif case == "pass-cap+1":
            m_cap, d_cap = total + 1, dtotal + 1
        elif case == "pass-cap1":
            m_cap, d_cap = 1, 1
        elif case == "pass-total0":
            m_cap, d_cap = 16, 64
        if case == "pass-nodelta":
            d_cap, deltas = 0, deltas[:, :0].copy()
        return dict(kind="pass", changed=changed, meta=meta, dcount=dcount, rows=rows,
                    deltas=deltas, m_cap=m_cap, d_cap=d_cap)
    from karmada_tpu_torch.scheduler.fleet_kernels import WIRE_ENTRY_TILE as tile

    k = 136 if kind == "solve" else 128
    byte_wire = case not in ("entry-int32", "solve-int32")
    pack21 = byte_wire and case not in ("entry-bytes3", "solve-bytes3")
    m = {"entry-small": 1, "entry-ragged": 100, "entry-many": 131_072}.get(
        case, 400 if pack21 else 200)
    site_bits = 13 if pack21 else (16 if byte_wire else 23)
    p_pos = {"entry-total0": 0.0, "entry-all": 1.0, "entry-many": 0.02}.get(case, 0.1)
    entries = ((rng.integers(0, 1 << site_bits, (m, k), dtype=np.int32) << 8)
               | rng.integers(1, 256, (m, k), dtype=np.int32))
    entries[rng.random((m, k), dtype=np.float32) >= p_pos] = 0
    if case.startswith("entry-pack21") or case == "solve-pack21":
        # runs of empty tiles between sparse ones
        flat = entries.reshape(-1)
        for t in range(-(-flat.size // tile)):
            if t % 3:
                flat[t * tile:(t + 1) * tile] = 0
            else:
                flat[t * tile + tile // 2:(t + 1) * tile] = 0  # a run of 1/2 tile
    if not byte_wire:
        entries[rng.random((m, k)) < 0.01] = -7  # negative words are not entries
    total = int((entries > 0).sum())
    e_cap = max(total, 1)
    if rest.startswith("pack21-mod"):
        r = int(rest[-1])
        # 21 e_cap = r (mod 8): the cap rounded down to it from the total
        # on even r (the last tile caps), up on odd r (the fill writes
        # the stream's last byte)
        e_cap = total + (5 * r - total) % 8 if r % 2 else total - (total - 5 * r) % 8
        e_cap += 8 if e_cap < 1 else 0
    elif case.endswith("cap-1"):
        e_cap = max(total - 1, 1)
    elif case.endswith("cap+1"):
        e_cap = total + 1
    elif case.endswith("cap1"):
        e_cap = 1
    elif case == "entry-total0":
        e_cap = 5
    meta = (rng.integers(0, 1 << 11, m).astype(np.int32) if kind == "solve" else None)
    return dict(kind="entry", entries=entries, e_cap=e_cap, byte_wire=byte_wire,
                pack21=pack21, meta=meta)


def check_wire_edges(device, card: str) -> None:
    """K5's two entry points against their plain versions on every
    ``wire_edge_batch`` case, byte for byte (the wire, the row buffer)."""
    import torch
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    rng = np.random.default_rng(SEED + 5)
    with uncounted():
        for case in WIRE_EDGE_CASES:
            b = wire_edge_batch(rng, case)
            if b["kind"] == "pass":
                args = tuple(torch.from_numpy(b[k]).to(device)
                             for k in ("changed", "meta", "dcount", "rows", "deltas"))
                kw = dict(m_cap=b["m_cap"], d_cap=b["d_cap"])
                compare(f"fleet_wire edges {case}", tuple(fk.fleet_wire(*args, **kw)),
                        tuple(fk.fleet_wire_ref(*args, **kw)))
            else:
                ents = torch.from_numpy(b["entries"]).to(device)
                meta = None if b["meta"] is None else torch.from_numpy(b["meta"]).to(device)
                kw = dict(e_cap=b["e_cap"], byte_wire=b["byte_wire"], pack21=b["pack21"],
                          meta=meta)
                compare(f"entry_wire edges {case}", fk.entry_wire(ents, **kw),
                        fk.entry_wire_ref(ents, **kw))
    print(f"# fleet_wire and entry_wire on the {len(WIRE_EDGE_CASES)} wire edge cases "
          f"({', '.join(WIRE_EDGE_CASES)}): exact; card {card}", flush=True)
    torch.cuda.empty_cache()


def widen_prev(state: tuple, k_prev: int, c: int, seed: int) -> tuple:
    """The table state with prev_sites / prev_counts widened to ``k_prev``
    pairs: the table's own pairs, then each row's first real pair again
    (a duplicate site), then random sites with small counts."""
    import torch

    sites, counts = state[6], state[7]
    n, k0 = sites.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    extra_s = torch.randint(0, c, (n, k_prev - k0 - 1), generator=g,
                            dtype=torch.int32).to(sites.device)
    extra_c = torch.randint(-2, 6, (n, k_prev - k0 - 1), generator=g,
                            dtype=torch.int32).to(sites.device)
    wide_s = torch.cat([sites, sites[:, :1], extra_s], dim=1).contiguous()
    wide_c = torch.cat([counts, counts[:, :1], extra_c], dim=1).contiguous()
    return (*state[:6], wide_s, wide_c)


def check_profile_table(device, card: str, rng) -> dict:
    """K1's table form at U = 8 profiles x 5000 clusters; on the card also
    its launch floor (an empty kernel at its grid, ``launch_floors.FLOORS``),
    printed on its own line."""
    import torch
    from karmada_tpu_torch import ops

    arrays = estimate_batch(rng, 1, 5000, u=8)
    t = to_device({k: arrays[k] for k in ("available_cap", "profiles", "has_summary")}, device)
    args = (t["available_cap"], t["profiles"], t["has_summary"])
    err = compare("profile_table", ops.profile_table(*args), ops.profile_table_ref(*args))
    u, c = t["profiles"].shape[0], t["available_cap"].shape[0]
    r = t["profiles"].shape[1]
    stats = dict(timed(
        "profile_table (K1 table form) 8x5000", lambda: ops.profile_table(*args),
        lambda: ops.profile_table_ref(*args),
        _nbytes(*args) + u * c * 4, u * c * r * 2, card,
    ), max_abs_err=err)
    if torch.cuda.is_available():
        import launch_floors

        run = launch_floors.floor_entry("estimate_merge", device)
        stats["floor_ms"] = cuda_ms(lambda: run(u, c, r))
        print(f"# launch floor at K1's table-form {u}x{c} grid: {stats['floor_ms']:.4f} ms (an "
              f"empty kernel at its grid; the table form {stats['ms']:.4f} ms, "
              f"{stats['ms'] / stats['floor_ms']:.2f}x the floor); card {card}", flush=True)
    return stats


def model_batch(rng, u: int, c: int, g: int = 9, r: int = 4) -> dict:
    """K7 inputs over every branch at the engine's widths: grades sorted by
    their bounds with undefined (-1) entries and padding grades, uncovered
    dims, requests of nothing, of 1 (per-node answers near the 2^62
    sentinel) and beyond every grade, and clusters whose count x per-node
    products and grade sums wrap int64."""
    mb = np.sort(rng.integers(0, 64_000, (c, g, r)), axis=1).astype(np.int64)
    mb[rng.random((c, g, r)) < 0.1] = -1
    pad = rng.random(c) < 0.3
    mb[pad, -1] = -1
    counts = rng.integers(0, 50, (c, g)).astype(np.int32)
    counts[pad, -1] = 0
    mb[:64, :, 0] = rng.integers(2**61, 2**62 - 1, (64, g), dtype=np.int64)
    counts[:64] = rng.integers(2**30, 2**31 - 1, (64, g))
    req = rng.integers(0, 70_000, (u, r)).astype(np.int64)
    req[rng.random((u, r)) < 0.35] = 0
    req[0] = 0
    req[1] = [1] + [0] * (r - 1)
    req[2] = 10**9
    cap = rng.integers(-50, 1 << 40, (c, r)).astype(np.int64)
    return {"min_bounds": mb, "counts": counts, "covered": rng.random((c, r)) < 0.85,
            "requests": req, "has_models": rng.random(c) < 0.8,
            "has_summary": rng.random(c) < 0.9, "available_cap": cap}


def _model_ops(u: int, c: int, g: int, r: int) -> int:
    """K7's operations in its plain definition: per (profile, cluster,
    grade) a compliance compare and a division per dim, a multiply-add."""
    return u * c * g * (2 * r + 2)


def check_model_forms(t: dict, pods_dim: int, card: str, label: str) -> dict:
    """K7 against its plain version on the device tensors ``t``; exact.
    Returns its stats."""
    from karmada_tpu_torch import ops
    from karmada_tpu_torch.models import modeling as mm

    pack = (t["min_bounds"], t["counts"], t["covered"], t["requests"])
    c, g, r = t["min_bounds"].shape
    u = t["requests"].shape[0]
    stats = {}
    base = ops.profile_table(t["available_cap"], t["requests"], t["has_summary"])
    rest = (t["has_models"], t["has_summary"], t["available_cap"])
    t_k, t_r = base.clone(), base.clone()
    mm.model_overlay(t_k, *pack, *rest, pods_dim)
    mm.model_overlay_ref(t_r, *pack, *rest, pods_dim)
    err = compare("model_overlay", t_k, t_r)
    changed = int((t_k != base).sum().item())
    # the overlay is idempotent on its table, so repeated launches time it;
    # its bound counts the table once, written (the kernel never reads it)
    stats["model_overlay"] = dict(timed(
        f"model_overlay (K7) {label}",
        lambda: mm.model_overlay(t_k, *pack, *rest, pods_dim),
        lambda: mm.model_overlay_ref(t_r, *pack, *rest, pods_dim),
        _nbytes(*pack, *rest) + _nbytes(base), _model_ops(u, c, g, r), card,
    ), max_abs_err=err)
    print(f"# K7 {label}: {u} profiles x {c} clusters x {g} grades; overlay changed "
          f"{changed} of {u * c} cells", flush=True)
    return stats


def check_model_kernels(engine, card: str, rng) -> dict:
    """K7 on the config-5 table's own inputs (its padded interned profiles
    x 5000 clusters x 9 grades), then on a seeded U = 64 batch at C = 5000."""
    import torch

    cap, has_summary = engine._device_state()
    min_bounds, counts, covered, has_models = engine._device_models()
    profs = np.stack(engine._fleet._profiles)
    from karmada_tpu_torch.scheduler.fleet import _pow2

    padded = np.zeros((_pow2(max(len(profs), 4)), profs.shape[1]), np.int64)
    padded[: len(profs)] = profs
    t = {"min_bounds": min_bounds, "counts": counts, "covered": covered,
         "requests": torch.from_numpy(padded).to(cap.device), "has_models": has_models,
         "has_summary": has_summary, "available_cap": cap}
    pods = engine.snapshot.dim_index("pods")
    stats = check_model_forms(t, -1 if pods is None else pods, card, "config-5 table")
    if torch.cuda.is_available():
        import launch_floors

        u, (c, g, r) = padded.shape[0], min_bounds.shape
        run = launch_floors.floor_entry("model_estimate", cap.device)
        st = stats["model_overlay"]
        st["floor_ms"] = cuda_ms(lambda: run(u, c, launch_floors.model_floor_arg(g, r)))
        print(f"# launch floor at K7's {u}x{c}x{g} grid: {st['floor_ms']:.4f} ms (an empty "
              f"kernel at its grid; K7 {st['ms']:.4f} ms, {st['ms'] / st['floor_ms']:.2f}x the "
              f"floor); card {card}", flush=True)
    check_model_forms(to_device(model_batch(rng, 64, 5000), cap.device), 2, card,
                      "seeded U=64")
    return stats


# --------------------------------------------------------------------------
# K6 and K7 edge batches
# --------------------------------------------------------------------------

#: K6 edge batches (``scatter_edge_batch``): the dirty-row form with rows
#: repeated (the pow2 padding and more), at 0 and cap - 1 with rows past cap
#: and below 0 dropped, k = 1, one field and eight, row widths 1, 2, 4, 8,
#: 128 and 544 B, cap = 1, and every input a view one element past a fresh
#: allocation (on the card); the commit form with no row committed, every
#: row, about half (the all-rows branch) and a gathered batch
COMMIT_EDGE_CASES = ("commit_none", "commit_all", "commit_churn", "commit_gathered")
SCATTER_EDGE_CASES = ("repeated", "ends", "k1", "one_field", "eight_fields", "widths",
                      "cap1", "misaligned", *COMMIT_EDGE_CASES)
#: the fleet table's state fields (fleet.py:1113): dtype and row shape
STATE_FIELD_KINDS = ((np.int32, ()), (np.int32, ()), (np.int32, ()), (np.int32, ()),
                     (np.int8, ()), (np.bool_, ()), (np.int32, (32,)), (np.int32, (32,)))
#: the entry-resident row: k_res = 136 int32 (544 B), config 5's width
K_RES = 136


def _field(rng, dtype, shape) -> np.ndarray:
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def scatter_edge_batch(case: str) -> dict:
    """K6 inputs for ``case`` (``SCATTER_EDGE_CASES``), seeded from ``SEED``:
    ``state`` (arrays of ``cap`` rows), ``rows`` (int64) and ``vals``, as
    the wrapper takes them; ``meta`` and ``gather_rows`` (int32, -1 where no
    row, 0 and cap - 1 among them) for the gather. A value row depends only
    on the row it names, so rows named twice carry identical values. The
    commit cases also hold the JAX commit's inputs (fleet.py:355-371):
    ``resident`` (= state[0]), ``entries`` (= vals[0]), ``resident_rows``
    (``r``), ``valid`` and ``all_rows``; ``rows`` is then the commit index,
    r where valid and changed, -1 elsewhere. In the all-rows branch the
    padding rows (not valid) carry their resident row, as JAX writes every
    row there."""
    rng = np.random.default_rng(SEED + 1800 + SCATTER_EDGE_CASES.index(case))
    cap = 1 if case == "cap1" else 640
    if case in COMMIT_EDGE_CASES:
        cap = 1000
        resident = rng.integers(0, 1 << 20, (cap, K_RES)).astype(np.int32)
        all_rows = case != "commit_gathered"
        n = 960 if all_rows else 512
        if all_rows:
            r = np.arange(n, dtype=np.int32)
            valid = r < n - 37  # the pass's padding rows
        else:
            r = rng.permutation(cap)[:n].astype(np.int32)
            valid = rng.random(n) < 0.8
            r[~valid] = -1
        entries = resident[np.maximum(r, 0)].copy()
        share = {"commit_none": 0.0, "commit_all": 1.0}.get(case, 0.5)
        change = (rng.random(n) < share) & (valid if all_rows else True)
        entries[change, rng.integers(0, K_RES, int(change.sum()))] += 1
        if not all_rows:
            entries[~valid] = rng.integers(0, 1 << 20, (int((~valid).sum()), K_RES))
        changed = (entries != resident[np.maximum(r, 0)]).any(axis=1) & valid
        state, vals = [resident], [entries]
        rows = np.where(changed, r, -1).astype(np.int64)
        out = {"resident": resident, "entries": entries, "resident_rows": r,
               "valid": valid, "all_rows": all_rows}
    else:
        kinds = {"k1": ((np.int32, (32,)),), "one_field": ((np.int32, (K_RES,)),),
                 "widths": ((np.uint8, ()), (np.int16, ()), (np.int32, ()), (np.int64, ()),
                            (np.int32, (32,)), (np.int32, (K_RES,)))}.get(case, STATE_FIELD_KINDS)
        if case == "k1":
            rows = np.array([cap - 1], np.int64)
        elif case == "cap1":
            rows = np.array([0, -1, 1, 0, 7, 0, -(2**40), 0], np.int64)
        elif case == "ends":
            rows = rng.permutation(cap)[:200].astype(np.int64)
            rows[:8] = 0, cap - 1, cap, cap + 5, -1, 2**40, -(2**40), 2**31
        else:
            k_u = 300 if case == "repeated" else 200
            rows = rng.choice(cap, k_u, replace=False).astype(np.int64)
            if case == "repeated":  # pow2 padding, and rows named twice within
                rows[10:20] = rows[:10]
                rows = np.concatenate([rows, np.full(512 - k_u, rows[0])])
        donor = [_field(rng, d, (cap, *sh)) for d, sh in kinds]
        state = [_field(rng, d, (cap, *sh)) for d, sh in kinds]
        ok = (rows >= 0) & (rows < cap)
        vals = []
        for (d, sh), a in zip(kinds, donor):
            v = _field(rng, d, (rows.size, *sh))  # dropped rows: any values
            v[ok] = a[rows[ok]]
            vals.append(v)
        out = {}
    m = {"k1": 1, "cap1": 33}.get(case, 4096)
    grows = np.full(m, -1, np.int32)
    take = rng.random(m) < 0.7
    grows[take] = rng.integers(0, cap, int(take.sum()))
    grows[: min(m, 2)] = [0, cap - 1][: min(m, 2)]
    meta = rng.integers(-(2**31), 2**31, cap, dtype=np.int64).astype(np.int32)
    return dict(out, state=state, rows=rows, vals=vals, meta=meta, gather_rows=grows)


def check_scatter_edges(device, card: str) -> None:
    """K6 (both entry points) against its plain versions on every
    ``SCATTER_EDGE_CASES`` batch; exact. In the misaligned case every
    input is a view one element past a fresh allocation (each version
    writing its own state)."""
    import torch
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    t0 = time.perf_counter()
    for case in SCATTER_EDGE_CASES:
        b = scatter_edge_batch(case)

        def place(arrays):
            t = to_device(dict(enumerate(arrays)), device)
            return list((misaligned(t) if case == "misaligned" else t).values())

        rows = place([b["rows"]])[0]

        vals = tuple(place(b["vals"]))
        s_k, s_r = tuple(place(b["state"])), tuple(place(b["state"]))
        fk.scatter_rows(s_k, rows, vals)
        fk.scatter_rows_ref(s_r, rows, vals)
        compare(f"scatter_rows edge case {case}", s_k, s_r)
        meta, grows = place([b["meta"], b["gather_rows"]])
        compare(f"gather_meta edge case {case}", fk.gather_meta(meta, grows),
                fk.gather_meta_ref(meta, grows))
    print(f"# K6 edge cases: {len(SCATTER_EDGE_CASES)} exact in both entry points "
          f"({', '.join(SCATTER_EDGE_CASES)}; {time.perf_counter() - t0:.1f} s); card {card}",
          flush=True)


#: K7 edge batches (U, C, G, R, pods_dim, kind): G = 1, 9, 16; R = 1, 4, 17;
#: pods_dim -1, 0 and the last dim; C = 1, 127, 129, 5000, 16,385; U = 1, 8,
#: 1024; kind "mixed" (grades sorted by bound), "unsorted" or "extreme"
#: (every request row 0, 1, 2 or 2^63 - 1 in its dims; bounds at and past
#: 2^62 and negative; counts near 2^31); the last two past the kernel's
#: shared-memory stage (G x R > 380: bounds read from global memory), at
#: R = 41 and at R = 4 with 100 grades
MODEL_EDGE_CASES = (
    (8, 5000, 9, 4, 2, "unsorted"), (1, 1, 1, 1, -1, "mixed"), (8, 127, 16, 17, 16, "mixed"),
    (1024, 129, 9, 4, 0, "mixed"), (8, 16_385, 9, 4, -1, "mixed"),
    (1, 5000, 16, 1, 0, "unsorted"), (1024, 127, 1, 17, 3, "extreme"),
    (8, 5000, 9, 4, 3, "extreme"), (64, 129, 16, 4, -1, "unsorted"),
    (8, 129, 16, 41, 40, "mixed"), (8, 127, 100, 4, 2, "unsorted"),
)


def model_edge_batch(rng, u: int, c: int, g: int, r: int, kind: str) -> dict:
    """K7 inputs on which it must stay exact (``model_batch``'s keys plus
    ``table``, the general table it overlays, -1 on no-summary clusters).
    Bounds sorted by grade unless ``kind`` is "unsorted", with undefined (-1)
    and padding grades, bounds past 2^62 (per-node answers at the sentinel
    for a request of 1) and just under it with counts near 2^31 (int64 sums
    that wrap); from U = 4 on, request rows 0, 1 and 2^63 - 1 in every dim
    and 1 in dim 0 alone first; clusters with models and no summary (cluster 0 among
    them where C > 1)."""
    mb = rng.integers(0, 64_000, (c, g, r)).astype(np.int64)
    if kind != "unsorted":
        mb = np.sort(mb, axis=1)
    roll = rng.random((c, g, r))
    hi = 0.3 if kind == "extreme" else 0.1
    mb[roll < 0.08] = -1
    big = (roll >= 0.08) & (roll < 0.08 + hi / 2)
    mb[big] = rng.integers(2**62, 2**63 - 1, int(big.sum()), dtype=np.int64)
    near = (roll >= 0.08 + hi / 2) & (roll < 0.08 + hi)
    mb[near] = rng.integers(2**61, 2**62, int(near.sum()), dtype=np.int64)
    if kind == "extreme":
        low = roll >= 0.95
        mb[low] = rng.integers(-(2**63), 0, int(low.sum()), dtype=np.int64)
    pad = rng.random(c) < 0.3
    mb[pad, -1] = -1
    counts = rng.integers(0, 50, (c, g)).astype(np.int32)
    wide = rng.random((c, g)) < (0.4 if kind == "extreme" else 0.1)
    counts[wide] = rng.integers(2**30, 2**31 - 1, int(wide.sum()))
    counts[pad, -1] = 0
    req = rng.integers(0, 70_000, (u, r)).astype(np.int64)
    req[rng.random((u, r)) < 0.35] = 0
    if kind == "extreme":
        req = rng.choice(np.array([0, 1, 2, 2**63 - 1], np.int64), (u, r))
    if u >= 4:
        req[1:4] = 0
        req[1], req[2], req[3, 0] = 1, 2**63 - 1, 1
        req[0] = 0
    has_models = rng.random(c) < 0.8
    has_summary = rng.random(c) < 0.85
    if c > 1:
        has_models[0], has_summary[0] = True, False
    cap = rng.integers(-50, 1 << 40, (c, r)).astype(np.int64)
    small = rng.random((c, r)) < 0.2
    cap[small] = rng.integers(-5, 100, int(small.sum()))
    table = rng.integers(0, 500, (u, c)).astype(np.int32)
    table[:, ~has_summary] = -1
    return {"min_bounds": mb, "counts": counts, "covered": rng.random((c, r)) < 0.85,
            "requests": req, "has_models": has_models, "has_summary": has_summary,
            "available_cap": cap, "table": table}


def model_edge_case(k: int) -> dict:
    """``model_edge_batch`` of ``MODEL_EDGE_CASES[k]``, seeded from ``SEED``."""
    u, c, g, r, _, kind = MODEL_EDGE_CASES[k]
    return model_edge_batch(np.random.default_rng(SEED + 1900 + k), u, c, g, r, kind)


def check_model_edges(device, card: str) -> None:
    """K7 against its plain version on every ``MODEL_EDGE_CASES`` batch;
    exact."""
    from karmada_tpu_torch.models import modeling as mm

    t0 = time.perf_counter()
    for k, (u, c, g, r, pods_dim, kind) in enumerate(MODEL_EDGE_CASES):
        t = to_device(model_edge_case(k), device)
        args = tuple(t[n] for n in ("min_bounds", "counts", "covered", "requests", "has_models",
                                    "has_summary", "available_cap"))
        t_k, t_r = t["table"].clone(), t["table"].clone()
        mm.model_overlay(t_k, *args, pods_dim)
        mm.model_overlay_ref(t_r, *args, pods_dim)
        compare(f"model_overlay edge case {u}x{c} G={g} R={r} pods {pods_dim} {kind}", t_k, t_r)
    print(f"# K7 edge cases: {len(MODEL_EDGE_CASES)} exact (U x C x G x R, pods dim: "
          + ", ".join(f"{u}x{c}x{g}x{r} {p}{'' if kind == 'mixed' else ' ' + kind}"
                      for u, c, g, r, p, kind in MODEL_EDGE_CASES)
          + f"; {time.perf_counter() - t0:.1f} s); card {card}", flush=True)


def node_batch(rng, b: int, n: int, r: int = 4) -> dict:
    """K8 inputs: node headroom with negative and near-2^62 entries,
    requests of nothing and of 1 (sums that wrap int64), and a prefilter
    mask that drops a fifth of the nodes per row."""
    avail = rng.integers(-2000, 200_000, (n, r)).astype(np.int64)
    big = rng.random((n, r)) < 0.01
    avail[big] = rng.integers(2**61, 2**62 - 1, int(big.sum()), dtype=np.int64)
    req = rng.integers(0, 5000, (b, r)).astype(np.int64)
    req[rng.random((b, r)) < 0.3] = 0
    req[0] = 0
    req[1] = [1] + [0] * (r - 1)
    return {"node_avail": avail, "node_ok": rng.random((b, n)) < 0.8, "requests": req}


def node_sum_bound(t: dict, out) -> tuple[int, int]:
    """(bytes, operations) K8 must move and do on the device tensors ``t``:
    the node table, the prefilter mask and the requests read once, the
    answers written once; per cell, per dim the row requests, a clamp, a
    division and a min (64-bit, each counted as one operation), and per
    cell the sentinel's compare and select, the mask's select and the add."""
    b, n = t["node_ok"].shape
    requested = int((t["requests"] > 0).sum().item())
    nbytes = _nbytes(t["node_avail"], t["node_ok"], t["requests"], out)
    return nbytes, n * (3 * requested + 4 * b)


def launch_floor(n: int, r: int, b: int, device):
    """A function that launches an empty kernel at K8's grid and cluster
    shape for B = ``b``, N = ``n``, R = ``r``: K8's launch floor there. The
    empty kernel is appended to ``node_sum.cu``'s text and built on first
    use (``launch_floors.floor_entry``)."""
    import launch_floors

    run = launch_floors.floor_entry("node_sum", device)
    return lambda: run(n, r, b)


def check_node_sum(arrays: dict, device, card: str, label: str) -> dict:
    """K8 against its plain version on the card; exact. On the card also the
    launch floor at its shape (an empty kernel at K8's grid and cluster
    shape, timed the same way), printed on its own line."""
    import torch
    from karmada_tpu_torch.estimator import accurate as acc

    t = to_device(arrays, device)
    args = (t["node_avail"], t["node_ok"], t["requests"])
    b, n = t["node_ok"].shape
    r = t["requests"].shape[1]
    got, want = acc.node_sum_estimate(*args), acc.node_sum_estimate_ref(*args)
    err = compare("node_sum_estimate", got, want)
    stats = dict(timed(f"node_sum_estimate (K8) {label}", lambda: acc.node_sum_estimate(*args),
                       lambda: acc.node_sum_estimate_ref(*args), *node_sum_bound(t, got), card),
                 max_abs_err=err)
    if torch.cuda.is_available():
        stats["floor_ms"] = cuda_ms(launch_floor(n, r, b, device))
        print(f"# launch floor at K8's {label} shape: {stats['floor_ms']:.4f} ms (an empty "
              f"kernel at its grid and cluster shape; K8 {stats['ms']:.4f} ms, "
              f"{stats['ms'] / stats['floor_ms']:.2f}x the floor); SM clock now "
              f"{sm_clock()}; card {card}", flush=True)
    return stats


def sm_clock() -> str:
    """The card's SM clock and power draw as nvidia-smi reads them now (K8
    is bound by issue, so its times move with the clock)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


#: K8 edge batches (B, N, R): every node count about a warp, a 256-node
#: cluster step and a block of 4096 rows, one row to 4096, one dim to one
#: group's 40, and 41, 81 and 100 dims (two and three groups of dims)
NODE_EDGE_CASES = (
    (1, 1, 1), (1, 16_385, 4), (1, 4000, 17), (8, 1, 4), (8, 31, 4), (8, 32, 17),
    (8, 33, 1), (8, 255, 4), (8, 256, 4), (8, 257, 17), (8, 4000, 4), (8, 4000, 17),
    (8, 16_385, 1), (8, 4000, 40), (8, 300, 41), (100, 4000, 4), (999, 257, 4),
    (4096, 1, 1), (4096, 33, 4), (4096, 256, 17), (4096, 257, 4), (4096, 1000, 4),
    (64, 1000, 81), (8, 300, 100),
)
#: divisors K8's multiplier and shift must divide by exactly
NODE_EDGE_DIVISORS = (1, 2, 3, 7, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32, 2**32 + 1,
                      2**62 - 1, 2**62, 2**62 + 1, 1_000_000_007, 2**61 - 1,
                      9_223_372_036_854_775_783, 2**63 - 1)


def node_edge_batch(rng, b: int, n: int, r: int) -> dict:
    """K8 inputs on which it must stay exact. Requests: the divisors of
    ``NODE_EDGE_DIVISORS`` (1, 2, 3, 7, 2^k and 2^k +- 1 for k = 31, 32 and
    62, large primes, 2^63 - 1), small ones and zeros. Node headroom: 0,
    multiples q d - 1, q d and q d + 1 of a divisor some row asks for (up to
    2^63 - 1), 2^62 - 1, 2^62, 2^63 - 1, small values and negatives down to
    INT64_MIN (clamped to 0). Row roles, rotated by the seed: one requests
    nothing, one requests 1 of dim 0 with every node passing while a third
    of the nodes hold 2^62 - 1 there (per-node answers just under the
    sentinel: the int64 sum wraps), one has every node filtered out, one
    asks dim 1 what it asks dim 0 while half the nodes hold the same in
    both (ratios tied across dims), the rest mixed (a batch of fewer than 5
    rows: mixed)."""
    hi = 2**63 - 1
    div = np.array(NODE_EDGE_DIVISORS, dtype=np.int64)
    req = rng.integers(1, 5000, (b, r)).astype(np.int64)
    pick = rng.random((b, r))
    req[pick < 0.5] = rng.choice(div, int((pick < 0.5).sum()))
    req[pick > 0.85] = 0
    ok = rng.random((b, n)) < rng.uniform(0.2, 1.0, (b, 1))
    roles = (np.arange(b) + (rng.integers(0, 5) if b >= 5 else 4)) % 5
    if r >= 2:
        req[roles == 3, 1] = req[roles == 3, 0] = rng.integers(1, 5000, int((roles == 3).sum()))
    req[roles == 0] = 0
    req[roles == 1] = 0
    req[roles == 1, 0] = 1
    ok[roles == 1] = True
    ok[roles == 2] = False
    avail = rng.integers(0, 200_000, (n, r)).astype(np.int64)
    kind = rng.integers(0, 8, (n, r))
    avail[kind == 3] = 0
    avail[kind == 4] = rng.choice(np.array([-1, -(2**40), -(2**63)]), int((kind == 4).sum()))
    avail[kind == 5] = rng.choice(np.array([2**62 - 1, 2**62, hi]), int((kind == 5).sum()))
    # a multiple q d of a divisor some row asks for of that dim (q up to
    # (2^63 - 1) // d, or small), and its neighbours q d - 1 and q d + 1
    cells, dims = np.nonzero(kind >= 6)
    d = req[rng.integers(0, b, len(cells)), dims]
    d = np.where(d > 0, d, rng.choice(div, len(cells)))
    qmax = hi // d
    q = np.where(rng.random(len(cells)) < 0.7,
                 np.minimum((rng.random(len(cells)) * qmax.astype(float)).astype(np.int64), qmax),
                 np.minimum(rng.integers(0, 1000, len(cells)), qmax))
    v = q * d
    step = rng.integers(-1, 2, len(cells))
    avail[cells, dims] = np.where((step == 1) & (v == hi), v, v + step)
    if r >= 2:
        half = rng.random(n) < 0.5
        avail[half, 1] = avail[half, 0]
    if (roles == 1).any():
        avail[rng.random(n) < 1 / 3, 0] = 2**62 - 1
    return {"node_avail": avail, "node_ok": ok, "requests": req}


def check_node_edges(device, card: str) -> None:
    """K8 against its plain version on every ``NODE_EDGE_CASES`` batch;
    exact."""
    from karmada_tpu_torch.estimator import accurate as acc

    t0 = time.perf_counter()
    for k, (b, n, r) in enumerate(NODE_EDGE_CASES):
        t = to_device(node_edge_batch(np.random.default_rng(SEED + 800 + k), b, n, r), device)
        args = (t["node_avail"], t["node_ok"], t["requests"])
        compare(f"node_sum_estimate edge case {b}x{n}x{r}", acc.node_sum_estimate(*args),
                acc.node_sum_estimate_ref(*args))
    print(f"# K8 edge cases: {len(NODE_EDGE_CASES)} exact (B x N x R: "
          + ", ".join(f"{b}x{n}x{r}" for b, n, r in NODE_EDGE_CASES)
          + f"; {time.perf_counter() - t0:.1f} s); card {card}", flush=True)


GROUP_ARGS = ("base", "terms", "cp_idx", "term_len", "avail", "replicas", "prev",
              "dynamic", "fresh")


def group_batch(rng, b: int = 4096, t: int = 3, c: int = 5000, u: int = 2) -> dict:
    """K17 inputs shaped as a ranked chunk: u placements of t nested-looking
    term masks (a small first group, larger later ones), base masks 80%
    true, merged availability in [0, 400) with 2% MAX_INT32 cells, a third
    of the rows with 1-3 previous sites, 75% dynamic rows, 5% fresh."""
    terms = np.zeros((u, t, c), bool)
    for k in range(t):
        terms[:, k] = rng.random((u, c)) < min(0.02 * 8**k, 0.9)
    prev = np.zeros((b, c), np.int32)
    for i in np.flatnonzero(rng.random(b) < 1 / 3):
        prev[i, rng.choice(c, int(rng.integers(1, 4)), replace=False)] = rng.integers(1, 10)
    avail = rng.integers(0, 400, (b, c)).astype(np.int32)
    avail[rng.random((b, c)) < 0.02] = 2**31 - 1
    return {"base": rng.random((b, c)) < 0.8, "terms": terms,
            "cp_idx": rng.integers(0, u, b).astype(np.int32),
            "term_len": np.full(u, t, np.int32), "avail": avail,
            "replicas": rng.integers(1, 100, b).astype(np.int32), "prev": prev,
            "dynamic": rng.random(b) < 0.75, "fresh": rng.random(b) < 0.05}


def group_edge_batch(rng, b: int, t: int, c: int, u: int = 6) -> dict:
    """K17 inputs on which it must stay exact: placement 0 with every term
    live, 1 all-false terms, 2 all-true terms (the ClusterAffinity plugin
    disabled: dead terms true too), 3 one live term, 4 a one-cluster first
    term and every term live (rows fall back), 5 up to T live terms;
    MAX_INT32 answers (a twentieth of the rows all of them, so the int64
    sums pass 2^31 from 2 clusters on), previous counts of 2^30 and
    replicas of 2^31 - 1, zero-replica rows, steady rows (replicas equal to
    the first term's previous sum), fresh and non-dynamic rows; the last
    eighth of the rows padding as the engine pads (no base, placement 0, no
    replicas, no previous sites, not dynamic)."""
    hi = 2**31 - 1
    terms = rng.random((u, t, c)) < rng.uniform(0.05, 0.9, (u, t, 1))
    terms[1], terms[2] = False, True
    terms[4, 0] = np.arange(c) == 0
    term_len = rng.integers(1, t + 1, u).astype(np.int32)
    term_len[:5] = (t, t, max(t - 1, 1), 1, t)
    cp_idx = rng.integers(0, u, b).astype(np.int32)
    base = rng.random((b, c)) < rng.uniform(0.3, 1.0, (b, 1))
    avail = rng.integers(0, 60, (b, c)).astype(np.int32)
    avail[rng.random((b, c)) < 0.05] = hi
    avail[rng.random(b) < 0.05] = hi
    prev = np.where(rng.random((b, c)) < 0.15, rng.integers(1, 30, (b, c)), 0).astype(np.int32)
    huge = rng.random(b) < 0.05
    prev[huge] = np.where(rng.random((int(huge.sum()), c)) < 0.5, 1 << 30, 0)
    replicas = rng.integers(0, 150, b).astype(np.int32)
    replicas[rng.random(b) < 0.1] = 0
    replicas[rng.random(b) < 0.05] = hi
    steady = rng.random(b) < 0.15
    first = (base & terms[cp_idx, 0]) * prev.astype(np.int64)
    replicas[steady] = np.minimum(first.sum(axis=1), hi)[steady]
    dynamic, fresh = rng.random(b) < 0.75, rng.random(b) < 0.2
    pad = b - b // 8
    base[pad:], cp_idx[pad:], replicas[pad:], prev[pad:], avail[pad:] = False, 0, 0, 0, 0
    dynamic[pad:], fresh[pad:] = False, False
    return {"base": base, "terms": terms, "cp_idx": cp_idx, "term_len": term_len,
            "avail": avail, "replicas": replicas, "prev": prev, "dynamic": dynamic,
            "fresh": fresh}


def group_bound(t: dict) -> tuple[int, int]:
    """(bytes, operations) K17 must move and do on the device tensors ``t``:
    every row's base and scalars, the dynamic rows' avail and prev, the
    term masks once, the rank, fit and selected written; a compare and two
    int64 adds per term and cell of a dynamic row."""
    b, c = t["base"].shape
    n_dyn = int(t["dynamic"].sum().item())
    nbytes = (_nbytes(t["base"], t["terms"], t["cp_idx"], t["term_len"], t["replicas"],
                      t["dynamic"], t["fresh"]) + n_dyn * c * 8 + b * (4 + 1 + c))
    return nbytes, 3 * n_dyn * t["terms"].shape[1] * c


def check_first_fit_group(t: dict, card: str, label: str, with_base: bool = True,
                          time_it: bool = True) -> dict:
    """K17 against its plain version on the device tensors ``t``
    (``GROUP_ARGS``); exact. Times both when ``time_it``."""
    from karmada_tpu_torch import ops

    args = [t[k] for k in GROUP_ARGS]
    kern = lambda: ops.first_fit_group(*args, with_base=with_base)  # noqa: E731
    plain = lambda: ops.first_fit_group_ref(*args, with_base=with_base)  # noqa: E731
    err = compare(f"first_fit_group {label}", kern(), plain())
    if not time_it:
        print(f"# kernel first_fit_group (K17) {label}: exact", flush=True)
        return dict(no_times(), max_abs_err=err)
    nbytes, ops_n = group_bound(t)
    return dict(timed(f"first_fit_group (K17) {label}", kern, plain, nbytes, ops_n, card),
                max_abs_err=err)


def check_group_kernels(rng, device, card: str) -> dict:
    """K17 on a seeded ranked chunk (4096 x 3 x 5000; also with_base off)
    and on ``group_edge_batch`` at T = 1, 4 and 9 and C from 1 to 16,385.
    Returns the seeded batch's stats."""
    t = to_device(group_batch(rng), device)
    stats = check_first_fit_group(t, card, "4096x3x5000 seeded")
    check_first_fit_group(t, card, "4096x3x5000 seeded, with_base off", with_base=False)
    del t
    for b, tn, c in ((512, 9, 16_385), (512, 9, 5000), (512, 4, 5000), (512, 1, 5000),
                     (256, 9, 37), (256, 4, 1), (64, 1, 1)):
        t = to_device(group_edge_batch(rng, b, tn, c), device)
        check_first_fit_group(t, card, f"{b}x{tn}x{c} edge cases", time_it=False)
        check_first_fit_group(t, card, f"{b}x{tn}x{c} edge cases, with_base off",
                              with_base=False, time_it=False)
    return stats


def check_merge_table(rng, device, card: str, b: int = 4096, c: int = 5000,
                      u: int = 9) -> dict:
    """K1's merge form at b x c with E = 0, 1, 2, 5 and 9 extra estimates
    holding -1 and MAX_INT32 cells, against its plain version; exact.
    Returns the stats at E = 1 (an estimator registered, the estimator
    phase's shape)."""
    import torch
    from karmada_tpu_torch import ops

    hi = 2**31 - 1
    table = rng.integers(-1, 400, (u, c)).astype(np.int32)
    table[rng.random((u, c)) < 0.05] = hi
    t = to_device({"table": table, "prof_inv": rng.integers(0, u, b).astype(np.int32),
                   "replicas": np.where(rng.random(b) < 0.1, 0,
                                        rng.integers(1, 100, b)).astype(np.int32)}, device)
    stats = {}
    for e_n in (0, 1, 2, 5, 9):
        extras = []
        for _ in range(e_n):
            e = rng.integers(-1, 300, (b, c)).astype(np.int32)
            e[rng.random((b, c)) < 0.05] = hi
            extras.append(torch.from_numpy(e).to(device))
        extras = tuple(extras)
        args = (t["table"], t["prof_inv"], extras, t["replicas"])
        got = ops.estimate_merge_table(*args)
        st = dict(timed(
            f"estimate_merge_table (K1 merge form) {b}x{c}, E={e_n}",
            lambda: ops.estimate_merge_table(*args),
            lambda: ops.estimate_merge_table_ref(*args),
            _nbytes(t["table"], t["prof_inv"], t["replicas"], *extras, got),
            b * c * (2 * (e_n + 1) + 3), card,
        ), max_abs_err=compare(f"estimate_merge_table E={e_n}", got,
                               ops.estimate_merge_table_ref(*args)))
        if e_n == 1:
            stats = st
        del extras, got
    return stats


# --------------------------------------------------------------------------
# the fleet storm (config 5), the mixed phase and the general path
# --------------------------------------------------------------------------


def outcome_digest(results) -> np.ndarray:
    """int64[B]: a hash of each result's outcome (key, placements, error,
    affinity name, feasible set), so two storms compare pass for pass, row
    by row, without holding 100k outcome tuples per pass."""
    return np.fromiter(
        (hash((r.key, tuple(sorted(r.clusters.items())), r.error, r.affinity_name,
               tuple(r.feasible))) for r in results),
        np.int64, len(results))


@contextlib.contextmanager
def dense_budget(nbytes):
    """Set ``KARMADA_TPU_DENSE_BUDGET`` (bytes) inside the block, where a
    fleet table built reads it; None leaves the environment as it is."""
    saved = os.environ.get("KARMADA_TPU_DENSE_BUDGET")
    if nbytes is not None:
        os.environ["KARMADA_TPU_DENSE_BUDGET"] = str(nbytes)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("KARMADA_TPU_DENSE_BUDGET", None)
        else:
            os.environ["KARMADA_TPU_DENSE_BUDGET"] = saved


def pass_inputs(table) -> dict:
    """What a fleet table's next all-rows pass runs with: the device
    tables and state, the adaptive chunk, the all-rows index, the pass's
    k_out and K2 variant."""
    from karmada_tpu_torch.scheduler.core import kernel_variant
    from karmada_tpu_torch.scheduler.fleet import _pow2

    n = table.n_rows
    chunk = min(table.chunk, _pow2(max(n, 256)))  # the table's adaptive chunk
    c = table._dev_tables[1].shape[1]
    reps = table._st["replicas"][:n]
    strat = table._st["strategy"][:n]
    max_n = int(reps.max())
    wide, fast = kernel_variant(max(table._avail_max, max_n), table._static_max,
                                int(table._st["prev_counts"][:n].max()), max_n, c)
    return dict(tables=table._dev_tables, state=table._dev_state, n=n, chunk=chunk,
                n_pad=-(-n // chunk) * chunk, rows_all=table._all_rows_dev, c=c,
                reps=reps, strat=strat, k_out=min(c, _pow2(max(max_n, 1))),
                has_agg=bool((strat == 3).any()), wide=wide, fast=fast)


def legacy_inputs(table) -> dict:
    """``pass_inputs`` of a legacy table, with its resident and the
    resident widened by 8 zero columns past k_out (``res_w``, k_res =
    k_out + 8 on config 5), against which K16 is checked."""
    import torch

    resident = table._resident_entries
    return dict(pass_inputs(table), resident=resident,
                res_w=torch.cat([resident, resident.new_zeros((resident.shape[0], 8))], 1))


def legacy_pass_entries(li: dict):
    """K3 -> K2 -> K16 over every chunk of a legacy table's all-rows pass
    (``legacy_inputs``) against its resident, each chunk writing its rows
    of pass-wide buffers, as ``fleet_solve`` runs them: the pass's
    EntryDiff (n_pad metas, n_pad x k_res entry words, commit rows)."""
    import torch
    from karmada_tpu_torch.ops import divide_replicas
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    n_pad, chunk, res = li["n_pad"], li["chunk"], li["resident"]
    diff = fk.EntryDiff(*(torch.empty(sh, dtype=d, device=res.device) for d, sh in (
        (torch.int32, (n_pad,)), (torch.int32, (n_pad, res.shape[1])),
        (torch.int64, (n_pad,)))))
    for i in range(n_pad // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        rc = li["rows_all"][sl]
        m = fk.fleet_masks(*li["tables"], rc, *li["state"])
        a, u = divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w, m.avail,
                               m.prev, m.fresh, li["has_agg"], li["wide"], li["fast"])
        fk.entry_diff(a, u, m.feasible, m.strategy, rc, res, k_out=li["k_out"],
                      all_rows=True, offset=i * chunk, out=fk.EntryDiff(*(t[sl] for t in diff)))
    return diff


def entry_diff_args(li: dict, rows_c) -> tuple:
    """K3 -> K2 on ``rows_c`` of a legacy table (``legacy_inputs``): K16's
    positional inputs against the widened resident, and the masks."""
    from karmada_tpu_torch.ops import divide_replicas
    from karmada_tpu_torch.scheduler import fleet_kernels as fk

    m = fk.fleet_masks(*li["tables"], rows_c, *li["state"])
    a, u = divide_replicas(m.strategy, m.replicas, m.feasible, m.static_w, m.avail,
                           m.prev, m.fresh, li["has_agg"], li["wide"], li["fast"])
    return (a, u, m.feasible, m.strategy, rows_c, li["res_w"]), m


def check_legacy_kernels(table, problems, card: str) -> dict:
    """K16 against its plain version on a legacy table's live inputs, after
    a snapshot drift has rebuilt the tables but before the pass: K3 -> K2
    on the first chunk, then K16 and ``entry_diff_ref`` in the all-rows
    form against the table's resident widened past k_out (some rows
    changed by the drift, most not), and in the gathered form on a
    permuted subset padded with -1 that names one row twice; the meta
    words, the entry rows, the commit rows and the resident each version's
    commit writes (K6, or its plain version) must be equal. Then the whole
    single-dispatch pass, ``fleet_solve`` against ``fleet_solve_ref``, on
    clones of the table's resident: the wire byte for byte and the
    resident. Exact equality; K16 is timed on the first chunk."""
    import torch
    from karmada_tpu_torch.scheduler import fleet_kernels as fk
    from karmada_tpu_torch.scheduler.fleet import _cap_round

    li = legacy_inputs(table)
    tables, state, n, chunk, n_pad, rows_all, c = (
        li[k] for k in ("tables", "state", "n", "chunk", "n_pad", "rows_all", "c"))
    if rows_all is None or rows_all.shape[0] != n_pad or len(problems) != n:
        raise AssertionError("the legacy table has no all-rows index of this pass's size")
    reps, strat, k_out, has_agg, wide, fast, resident, res_w = (
        li[k] for k in ("reps", "strat", "k_out", "has_agg", "wide", "fast", "resident",
                        "res_w"))
    k_res = res_w.shape[1]
    stats = {}
    rng = np.random.default_rng(SEED + 16)
    sub = rng.permutation(n)[: chunk - chunk // 5].astype(np.int32)
    sub[1] = sub[0]  # one row named twice
    rows_p = torch.full((chunk,), -1, dtype=torch.int32, device=rows_all.device)
    rows_p[: sub.size] = torch.from_numpy(sub).to(rows_all.device)
    for form, rows_c in (("all-rows", rows_all[:chunk]), ("gathered", rows_p)):
        args, m = entry_diff_args(li, rows_c)
        a, u = args[:2]
        kw = dict(k_out=k_out, all_rows=form == "all-rows", offset=0)
        got, want = fk.entry_diff(*args, **kw), fk.entry_diff_ref(*args, **kw)
        err = compare(f"entry_diff ({form})", tuple(got), tuple(want))
        r_k, r_r = res_w.clone(), res_w.clone()
        fk.scatter_rows((r_k,), got.commit, (got.entries,))
        fk.scatter_rows_ref((r_r,), want.commit, (want.entries,))
        compare(f"entry_diff ({form}) committed resident", r_k, r_r)
        changed = int(((got.meta >> 10) & 1).sum().item())
        print(f"# entry_diff {form} chunk: {chunk} rows x {c} clusters, k_out {k_out}, "
              f"k_res {k_res}: {changed} changed rows, exact", flush=True)
        if form == "all-rows":
            if not 0 < changed < chunk:
                raise AssertionError(f"entry_diff: {changed} changed rows of {chunk}; "
                                     "the check needs both kinds")
            # read: the assignment once, the feasible bytes, the row
            # scalars and the resident rows; written: the entry rows, meta
            # and commit rows, and (by the commit) the changed resident rows
            nbytes = (_nbytes(a, m.feasible, u, m.strategy, rows_c)
                      + chunk * k_res * 4 + _nbytes(*got) + changed * k_res * 4)
            stats["entry_diff"] = dict(timed(
                "entry_diff (K16, per 4096-row chunk)",
                lambda: fk.entry_diff(*args, **kw), lambda: fk.entry_diff_ref(*args, **kw),
                nbytes, chunk * c * 4 + chunk * k_res, card,
            ), max_abs_err=err)
        del got, want, r_k, r_r, m, a

    # the whole pass on clones of the resident
    safe = int(np.minimum(np.where(strat == 0, 0, reps), k_out).sum())
    skw = dict(chunk=chunk, n_chunks=n_pad // chunk, k_out=k_out, k_res=resident.shape[1],
               e_cap=_cap_round(safe), wide=wide, fast=fast, has_aggregated=has_agg,
               all_rows=True, pack21=c <= 1 << 13)
    res_k, res_r = resident.clone(), resident.clone()
    flat_k, _ = fk.fleet_solve(*tables, rows_all, *state, res_k, **skw)
    flat_r, _ = fk.fleet_solve_ref(*tables, rows_all, *state, res_r, **skw)
    compare("fleet_solve wire", flat_k, flat_r)
    compare("fleet_solve resident", res_k, res_r)
    total = int(flat_k[:4].cpu().numpy().view("<i4")[0])
    print(f"# fleet_solve (K3 -> K2 -> K16 x {n_pad // chunk}, K6, K5) against "
          f"fleet_solve_ref on the pass's inputs: {flat_k.numel()} wire bytes equal, "
          f"{total} changed entries, resident equal", flush=True)
    if torch.cuda.is_available():
        res_k.copy_(resident)  # a copy of the resident, made outside the profile
        check_device_ops("fleet_solve (the whole entry-resident pass)",
                         lambda: fk.fleet_solve(*tables, rows_all, *state, res_k, **skw))
    del res_k, res_r, res_w
    # K5's entry wire on the pass's own entries, the metas in place, as
    # fleet_solve runs it
    diff = legacy_pass_entries(li)
    # K6's commit form on the pass's own commit rows and entries, as
    # fleet_solve runs it; index_copy_ of the committed rows alone (their
    # indices compacted outside the timed window) is the yardstick
    r_k, r_r, r_l = resident.clone(), resident.clone(), resident.clone()
    commit_args = (diff.commit, (diff.entries,))
    fk.scatter_rows((r_k,), *commit_args)
    fk.scatter_rows_ref((r_r,), *commit_args)
    err = compare("scatter_rows commit form on the legacy pass", r_k, r_r)
    done = diff.commit >= 0
    idx_c, ent_c = diff.commit[done], diff.entries[done]
    n_c = int(idx_c.numel())
    w_c = diff.entries.shape[1]
    timed(f"scatter_rows commit form on the legacy pass ({diff.commit.numel()} rows, {n_c} "
          f"committed, k_res {w_c}; max abs err {err})",
          lambda: fk.scatter_rows((r_k,), *commit_args),
          lambda: fk.scatter_rows_ref((r_r,), *commit_args),
          _nbytes(diff.commit) + 2 * n_c * w_c * 4, diff.commit.numel(), card,
          library=lambda: r_l.index_copy_(0, idx_c, ent_c))
    del r_k, r_r, r_l, idx_c, ent_c
    kw = dict(e_cap=skw["e_cap"], byte_wire=True, pack21=skw["pack21"], meta=diff.meta)
    got = fk.entry_wire(diff.entries, **kw)
    err = compare("entry_wire on the legacy pass's entries", got,
                  fk.entry_wire_ref(diff.entries, **kw))
    n_ent = int((diff.entries > 0).sum().item())
    timed(f"entry_wire on the legacy pass's entries ({tuple(diff.entries.shape)} words, "
          f"{n_ent} entries, e_cap {kw['e_cap']}, pack21 {kw['pack21']}, metas in place; "
          f"max abs err {err})",
          lambda: fk.entry_wire(diff.entries, **kw),
          lambda: fk.entry_wire_ref(diff.entries, **kw),
          _nbytes(diff.entries, diff.meta, got), diff.entries.numel() * 3, card)
    if torch.cuda.is_available():
        masked_select_line("entry_wire legacy", diff.entries, diff.entries > 0, card)
        check_device_ops("entry_wire (legacy pass)",
                         lambda: fk.entry_wire(diff.entries, **kw), at_most=3)
    del diff, got, li
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return stats


def by_name(pkg, snap):
    """``snap``'s clusters in name order, the order a scheduler process and
    a solver sidecar build their snapshots in (``_sorted_clusters``,
    ``SolverService.sync_clusters``). Cluster order is part of a pass's
    input: ties in the division break by column, so the phases that hold
    one another's rows run in this order."""
    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    return s.ClusterSnapshot(sorted(snap.clusters, key=lambda c: c.name))


def drift_snapshots(pkg, snap, count: int, seed: int = 99, order=None) -> list:
    """bench.py's churn recipe (bench.py:942-980): every cluster's
    allocation drifts by a few 1/200ths of its allocatable per pass.
    ``order`` (default ``snap``'s) is the cluster order of the draws
    (bench.py draws in its build order); each snapshot keeps ``snap``'s
    order."""
    import importlib

    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    clusters = snap.clusters
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        for cl in (clusters if order is None else order):
            rs = cl.status.resource_summary
            for dim, q in list(rs.allocated.items()):
                alloc = rs.allocatable.get(dim, 0)
                rs.allocated[dim] = int(
                    min(max(0, q + int(rng.integers(-3, 4)) * max(1, alloc // 200)), alloc)
                )
        out.append(s.ClusterSnapshot(clusters))
    return out


def breakdown_line(engine) -> str:
    keys = ("compile", "upsert", "sync", "prep", "dispatch", "device", "fetch",
            "post", "changed_rows", "fetch_mb", "upload_mb")
    bd = engine.last_breakdown
    return ", ".join(
        f"{k} {bd[k]:.4f}" if k not in ("changed_rows",) else f"{k} {int(bd[k])}"
        for k in keys if k in bd
    )


def device_profile(fn, device, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of every
    kernel and copy it ran (they run on one stream, so the sum is the busy
    time), the wall of the profiled call, and the largest names."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall = time.perf_counter() - t0
    per_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            per_name[e.key] = per_name.get(e.key, 0.0) + us / 1e6
    busy = sum(per_name.values())
    names = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall, "busy_s": busy, "top": names, "by_name": per_name}


#: device operations whose time every traced pass line names, by a
#: substring of their profiler names: the fleet route's ordered
#: compactions (K16, K4's entry rows, K5's two wires), the memsets (K5's
#: look-back state among them), and the concatenations and device copies
#: that the pass glue no longer makes
TRACED_KERNELS = {"K16": "entry_diff_kernel", "K4 entry rows": "fleet_entry_rows_kernel",
                  "K5 fleet_wire": "pass_wire_kernel", "K5 entry_wire": "entry_wire_kernel",
                  "memsets": "Memset", "cat": "CatArrayBatchedCopy",
                  "DtoD copies": "Memcpy DtoD"}


def traced_kernels(prof: dict) -> str:
    return ", ".join(
        f"{label} {sum(v for k, v in prof['by_name'].items() if name in k) * 1e3:.3f} ms"
        for label, name in TRACED_KERNELS.items())


def model_share(engine) -> tuple[float, int]:
    """Share of the fleet table's (profile, cluster) cells where the model
    answer is used and differs from the summary answer (host mirrors), and
    the number of cells."""
    from karmada_tpu_torch.scheduler import host_profile_table

    profs = np.stack(engine._fleet._profiles)
    with_m = host_profile_table(engine.snapshot, profs, models_active=True)
    without = host_profile_table(engine.snapshot, profs, models_active=False)
    return float((with_m != without).mean()), with_m.size


def run_fleet_storm(device, card: str, bindings=None, clusters=None,
                    steady: int = 3, churn: int = 3, models: bool = False,
                    legacy: bool = False, reference: dict | None = None) -> dict:
    """Config 5 through the fleet table: cold, steady and churn passes, the
    oracle after the cold and the last churn pass, and (on the card) the
    fleet kernels' checks before the first churn pass. With ``models``,
    every cluster carries the nine default grades (K7's overlay form runs
    in each table rebuild) and K7 is checked on the table's inputs
    instead. With ``legacy``, the table is built with a dense budget of 0
    (``KARMADA_TPU_DENSE_BUDGET``), so every pass takes the entry-resident
    route, and K16 and the whole single-dispatch pass are checked instead;
    the first churn pass, after the steady passes shrank the entry cap,
    must overflow and rerun. With ``reference`` (the digests another storm
    on the same problems returned), the passes run over that storm's drift
    sequence and every pass must give its outcomes row by row; a pass equal
    to one that the reference storm held to the numpy divider (its cold
    pass and its last pass) is not solved by the divider a second time.
    Returns the per-pass outcome digests."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler

    tag = ("config 5 legacy" if legacy else "config 5 fleet") + (
        " (default models)" if models else "")
    table_kernels = ("profile_table", "model_overlay") if models else ("profile_table",)
    snap, problems = build_workload(karmada_tpu_torch, 5, bindings, clusters, models)
    # the clusters in name order (a sidecar's and a scheduler process's
    # order, so the sidecar phase holds its rows to this storm's), drifted
    # in bench.py's build order
    build_order = list(snap.clusters)
    snap = by_name(karmada_tpu_torch, snap)
    traced = device.type == "cuda"  # torch.profiler traces the card only
    # a reference storm's drift sequence, so that the last pass here is the
    # one that storm checked
    n_drift = churn + traced if reference is None else reference["drift"]
    drift = drift_snapshots(karmada_tpu_torch, snap, n_drift, order=build_order)
    last = n_drift - 1 if traced else churn - 1  # the index of the last pass
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    digests = {"steady": [], "churn": [], "drift": n_drift, "checked": last}

    def same_as_reference(kind: str, i: int, res) -> None:
        d = outcome_digest(res)
        if kind == "cold":
            digests["cold"] = d
        else:
            digests[kind].append(d)
        if reference is None:
            return
        want = reference["cold"] if kind in ("cold", "steady") else reference["churn"][i]
        bad = int((d != want).sum())
        if bad:
            raise AssertionError(f"{tag} {kind} pass {i}: {bad} rows differ from the "
                                 f"reference storm's")

    reset_counts()
    t0 = time.perf_counter()
    with dense_budget(0 if legacy else None):
        cold = engine.schedule(problems)
    sync(device)
    cold_s = time.perf_counter() - t0
    if engine._fleet is None:
        raise AssertionError(f"{tag} did not ride the fleet table")
    on_legacy = engine._fleet._resident_entries is not None
    if on_legacy != legacy or (legacy and engine._fleet._res_dense is not None):
        raise AssertionError(f"{tag}: the table took the wrong route "
                             f"(dense budget {engine._fleet.dense_budget})")
    same_as_reference("cold", 0, cold)
    on_card = device.type == "cuda"
    if on_card and any(read_counts()[k] < 1 for k in table_kernels):
        raise AssertionError(f"{tag}: the cold pass did not launch {table_kernels}")
    if models:
        share, cells = model_share(engine)
        print(f"# {tag}: the model answer is used and differs from the summary "
              f"answer in {share:.4f} of the table's {cells} (profile, cluster) "
              f"cells", flush=True)
        if not share > 0.05:
            raise AssertionError(f"{tag}: the models barely bind ({share})")
    cold_bd = breakdown_line(engine)
    t0 = time.perf_counter()
    if reference is None:
        bad = oracle_check(engine, problems, cold)
        how = "numpy-divider check"
    else:  # same_as_reference held every row to the reference's checked pass
        bad, how = 0, "equal to the reference storm's numpy-checked cold pass"
    check_s = time.perf_counter() - t0
    cold_out = outcomes(cold)
    print(f"# {tag} cold pass {cold_s:.4f} s [{cold_bd}]; {how} "
          f"{len(problems) - bad} ok / {bad} bad ({check_s:.1f} s); card {card}",
          flush=True)
    if bad:
        raise AssertionError(f"{tag} cold pass: {bad} rows differ")
    steady_s = []
    for i in range(steady):
        # the checks built the last pass's result objects: free them before
        # the timer starts, not when the next pass's results replace them
        res = None
        t0 = time.perf_counter()
        res = engine.schedule(problems)
        sync(device)
        steady_s.append(time.perf_counter() - t0)
        print(f"# {tag} steady pass {steady_s[-1]:.4f} s "
              f"[{breakdown_line(engine)}]", flush=True)
        same_as_reference("steady", i, res)
    if outcomes(res) != cold_out:
        raise AssertionError(f"{tag}: steady pass disagrees with the cold pass")
    profiles = {}
    if device.type == "cuda":  # one more steady pass, traced
        out = []
        profiles["steady"] = device_profile(
            lambda: out.append(engine.schedule(problems)), device)
        same_as_reference("steady", steady, out[0])
    churn_s, stats = [], {}
    reruns = []  # overflow reruns of each churn pass (legacy route)
    for i, snap_i in enumerate(drift[:churn]):
        res = None  # freed before the timer, as in the steady passes
        reruns_before = engine._fleet.overflow_reruns
        k1_before = {k: read_counts()[k] for k in table_kernels}
        t0 = time.perf_counter()
        if not engine.update_snapshot(snap_i):
            raise AssertionError("drifted snapshot refused")
        before = 0.0
        if i == 0:
            # the pass's own table rebuild (K1's table form, counted), then
            # the kernel checks on its inputs (not counted, not timed)
            engine._fleet._sync_device()
            sync(device)
            before = time.perf_counter() - t0
            with uncounted():
                if models:
                    stats = check_model_kernels(engine, card, np.random.default_rng(SEED + 7))
                elif legacy:
                    stats = check_legacy_kernels(engine._fleet, problems, card)
                else:
                    stats = check_fleet_kernels(engine._fleet, card)
            t0 = time.perf_counter()
        res = engine.schedule(problems)
        sync(device)
        churn_s.append(before + time.perf_counter() - t0)
        reruns.append(engine._fleet.overflow_reruns - reruns_before)
        if on_card and any(read_counts()[k] <= k1_before[k] for k in table_kernels):
            raise AssertionError(f"{tag}: churn pass {i} did not launch {table_kernels}")
        print(f"# {tag} churn pass {churn_s[-1]:.4f} s "
              f"[{breakdown_line(engine)}]"
              + (f"; overflow reruns {reruns[-1]}" if legacy else ""), flush=True)
        same_as_reference("churn", i, res)
    if legacy and not reruns[0]:
        raise AssertionError(f"{tag}: the first churn pass did not overflow its entry "
                             f"cap (e_cap {engine._fleet._e_cap_cur})")
    if traced:  # one more churn pass, traced: the last churn pass checked
        def traced_churn():
            if not engine.update_snapshot(drift[-1]):
                raise AssertionError("drifted snapshot refused")
            return engine.schedule(problems)

        out = []
        profiles["churn"] = device_profile(lambda: out.append(traced_churn()), device)
        res = out[0]
        same_as_reference("churn", last, res)
        if not (legacy or models):
            # a cold pass traced on a new engine over the same snapshot: the
            # pass that runs phase B (K4's entry rows) over every row; it
            # must give the last churn pass's outcomes
            out = []
            profiles["cold"] = device_profile(lambda: out.append(TensorScheduler(
                engine.snapshot, chunk_size=4096, device=device).schedule(problems)), device)
            if outcomes(out[0]) != outcomes(res):
                raise AssertionError(f"{tag}: a cold pass on the last snapshot differs "
                                     f"from the last churn pass")
            del out
    for kind, prof in profiles.items():
        print(f"# {tag} traced {kind} pass: wall {prof['wall_s']:.4f} s under "
              f"the profiler; device busy {prof['busy_s']:.4f} s; largest: "
              + ", ".join(f"{k[:48]} {v * 1e3:.2f} ms" for k, v in prof["top"])
              + f"; {traced_kernels(prof)}; card {card}", flush=True)
    launches = read_counts()
    t0 = time.perf_counter()
    if reference is None or last != reference["checked"]:
        bad = oracle_check(engine, problems, res)
        how = "numpy-divider check"
    else:  # same_as_reference held every row to the reference's checked pass
        bad, how = 0, "equal to the reference storm's numpy-checked last pass"
    check_s = time.perf_counter() - t0
    n = len(problems)
    p50 = {k: statistics.median(v) for k, v in
           (("cold", [cold_s]), ("steady", steady_s), ("churn", churn_s))}
    for kind, prof in profiles.items():
        share = (f"idle share {1 - prof['busy_s'] / p50[kind]:.3f}" if prof["busy_s"]
                 else "the profiler saw no device time: idle share not measured")
        print(f"# {tag} {kind}: device busy {prof['busy_s']:.4f} s of a "
              f"{p50[kind]:.4f} s p50 pass: {share}; card {card}", flush=True)
    print(f"# {tag}: {n} bindings x {snap.num_clusters} clusters; cold "
          f"{cold_s:.4f} s; steady p50 {p50['steady']:.4f} s ({n / p50['steady']:.0f} "
          f"bindings/s, walls {[round(w, 4) for w in steady_s]}); churn p50 "
          f"{p50['churn']:.4f} s ({n / p50['churn']:.0f} bindings/s, walls "
          f"{[round(w, 4) for w in churn_s]}); launches "
          f"{ {k: v for k, v in launches.items() if v} }; last churn pass "
          f"{how} {n - bad} ok / {bad} bad ({check_s:.1f} s); card {card}",
          flush=True)
    if bad:
        raise AssertionError(f"{tag} last churn pass: {bad} rows differ")
    return {"launches": launches, "stats": stats, "cold_out": cold_out,
            "cold_s": cold_s, "steady_s": steady_s, "churn_s": churn_s, "p50": p50,
            "profiles": profiles, "engine": engine, "problems": problems,
            "digests": digests, "reruns": reruns,
            "reruns_total": engine._fleet.overflow_reruns,
            "passes": 1 + steady + churn + 2 * traced,
            "chunks": -(-n // engine._fleet.chunk),
            "breakdown": dict(engine.last_breakdown)}


def mixed_problems(pkg, clusters, n: int, seed: int) -> list:
    """tests/test_fleet_engine.py's mix: Dynamic, Duplicated, Static and
    Aggregated placements in turn, replicas 0..39 (zero-replica rows
    included), up to 4 previous sites, 20% fresh."""
    import importlib

    b = importlib.import_module(f"{pkg.__name__}.utils.builders")
    q = importlib.import_module(f"{pkg.__name__}.utils.quantity")
    s = importlib.import_module(f"{pkg.__name__}.scheduler")
    req = q.parse_resource_list({"cpu": "250m", "memory": "512Mi"})
    rng = np.random.default_rng(seed)
    pls = [
        b.dynamic_weight_placement(),
        b.duplicated_placement(),
        b.static_weight_placement({c.name: (i % 3) + 1 for i, c in enumerate(clusters[:10])}),
        b.aggregated_placement(),
    ]
    out = []
    for i in range(n):
        prev_idx = rng.choice(len(clusters), int(rng.integers(0, 5)), replace=False)
        out.append(s.BindingProblem(
            key=f"m{i}", placement=pls[i % 4], replicas=int(rng.integers(0, 40)),
            requests=req, gvk="apps/v1/Deployment",
            prev={clusters[j].name: int(rng.integers(1, 9)) for j in prev_idx},
            fresh=bool(rng.random() < 0.2),
        ))
    return out


def run_mixed(device, card: str, bindings: int = 10_000, clusters: int = 1000,
              changed: int = 300, legacy: bool = False,
              reference: list | None = None) -> dict:
    """Mixed strategies through the fleet, two passes (the second replaces
    ``changed`` problems: dirty rows for K6), every row equal to the port's
    general path on the same device. With ``legacy`` the table is built at
    a dense budget of 0 (the entry-resident route, where the second pass
    is a gathered batch); with ``reference`` (the digests of another mixed
    phase) every row must equal that phase's instead of the general
    path's. Returns the passes' outcome digests."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import BindingProblem, ClusterSnapshot, TensorScheduler
    import karmada_tpu_torch.utils.builders as tb

    fleet = tb.synthetic_fleet(clusters, seed=11)
    snap = ClusterSnapshot(fleet)
    problems = mixed_problems(karmada_tpu_torch, fleet, bindings, 5)
    rng = np.random.default_rng(12)
    second = list(problems)
    for i in rng.choice(bindings, changed, replace=False):
        p = problems[i]
        second[i] = BindingProblem(
            key=p.key, placement=p.placement, replicas=(p.replicas + 3) % 40,
            requests=p.requests, gvk=p.gvk, prev=p.prev, fresh=not p.fresh,
        )
    # the legacy route's all-rows form serves both passes (the same keys in
    # the same order); a third pass, a permuted half of the second batch,
    # runs its gathered form, each row equal to its row of the second pass
    sub = np.random.default_rng(13).permutation(bindings)[: bindings // 2]
    passes = [(problems, None), (second, None)]
    if legacy:
        passes.append(([second[i] for i in sub], sub))
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    general = TensorScheduler(snap, chunk_size=4096, device=device)
    general.fleet_threshold = bindings + 1
    tag = "mixed fleet legacy phase" if legacy else "mixed fleet phase"
    reset_counts()
    walls, bad, digests = [], 0, []
    for k, (batch, idx) in enumerate(passes):
        t0 = time.perf_counter()
        with dense_budget(0 if legacy else None):
            res = engine.schedule(batch)
        sync(device)
        walls.append(time.perf_counter() - t0)
        digests.append(outcome_digest(res))
        if reference is not None:
            want = reference[1][idx] if idx is not None else reference[k]
            bad += int((digests[-1] != want).sum())
            continue
        got = outcomes(res)
        with uncounted():
            want = outcomes(general.schedule(batch))
        bad += sum(g != w for g, w in zip(got, want))
    launches = read_counts()
    if engine._fleet is None:
        raise AssertionError(f"the {tag} did not ride the fleet table")
    if (engine._fleet._resident_entries is not None) != legacy:
        raise AssertionError(f"the {tag} took the wrong route")
    against = "the dense mixed phase" if reference is not None else "the general path"
    n_rows = sum(len(b) for b, _ in passes)
    print(f"# {tag}: {bindings} bindings x {clusters} clusters, {len(passes)} passes "
          f"(second: {changed} replaced problems"
          + (f"; third: {sub.size} of them permuted, the gathered form" if legacy else "")
          + f") {[round(w, 4) for w in walls]} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; equal to "
          f"{against}: {n_rows - bad} ok / {bad} bad; card {card}", flush=True)
    if bad:
        raise AssertionError(f"{tag}: {bad} rows differ from {against}")
    return {"launches": launches, "walls": walls, "digests": digests}


def run_general(device, card: str, reference: list, bindings=None, clusters=None,
                rows: int | None = None) -> dict:
    """Config 5 on the general path (K1 + K2 per chunk), cut to its first
    ``rows`` bindings when given (rows are solved independently, so a
    prefix of the storm's problems is a smaller storm): one untimed warm
    pass over the first chunk's rows, then one timed pass, every row equal
    to the same row of the fleet's cold pass, which the numpy divider has
    checked."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler

    snap, problems = build_workload(karmada_tpu_torch, 5, bindings, clusters)
    snap = by_name(karmada_tpu_torch, snap)  # the storm's cluster order
    problems = problems[:rows]
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    engine.fleet_threshold = len(problems) + 1
    engine.schedule(problems[: engine.chunk_size])
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    first = engine.schedule(problems)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    bad = sum(g != w for g, w in zip(outcomes(first), reference))
    stages = chunk_breakdown(engine, problems, device)
    print(f"# config 5 general path stages of one 4096-row chunk (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()) + f"; card {card}",
          flush=True)
    print(f"# config 5 general path (the first {len(problems)} rows, one timed pass "
          f"after a warm pass over the first {engine.chunk_size}, checked "
          f"row by row against the fleet's oracle-checked cold pass): {wall:.4f} s "
          f"({len(problems) / wall:.0f} bindings/s); launches "
          f"{ {k: v for k, v in launches.items() if v} }; equal to the checked fleet "
          f"cold pass: {len(problems) - bad} ok / {bad} bad; card {card}", flush=True)
    if bad:
        raise AssertionError(f"config 5 general path: {bad} rows differ from the fleet")
    return {"launches": launches, "pass_s": wall}


def run_general_models(device, card: str, bindings: int = 20_000,
                       clusters: int | None = None) -> dict:
    """Config 5 under default models on the general path at reduced depth
    (``bindings`` rows x 5000 clusters): per chunk K1's table form, K7's
    overlay form, K1's merge form and K2. One pass, every row checked
    against the numpy divider over the model-aware host table."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler

    snap, problems = build_workload(karmada_tpu_torch, 5, bindings, clusters, models=True)
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    engine.fleet_threshold = len(problems) + 1
    reset_counts()
    t0 = time.perf_counter()
    res = engine.schedule(problems)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    bad = oracle_check(engine, problems, res)
    check_s = time.perf_counter() - t0
    print(f"# config 5 general path (default models): {len(problems)} bindings x "
          f"{snap.num_clusters} clusters, one pass {wall:.4f} s "
          f"({len(problems) / wall:.0f} bindings/s); launches "
          f"{ {k: v for k, v in launches.items() if v} }; numpy-divider check "
          f"{len(problems) - bad} ok / {bad} bad ({check_s:.1f} s); card {card}",
          flush=True)
    if bad:
        raise AssertionError(f"config 5 general path (models): {bad} rows differ")
    return {"launches": launches, "pass_s": wall}


def node_sum_referent(snap, caches):
    """extra(requests, replicas) -> int32[B, C]: the node-sum numpy mirror
    over each cluster's live node arrays, -1 for zero-replica rows (the
    registry asks nothing for them) — the registry's answer, computed
    without it."""
    from karmada_tpu_torch.estimator.accurate import _node_sum_estimate_np

    def extra(requests, replicas):
        out = np.full((len(requests), snap.num_clusters), -1, np.int32)
        live = replicas > 0
        if not live.any():
            return out
        uniq, inv = np.unique(requests[live], axis=0, return_inverse=True)
        table = np.empty((len(uniq), snap.num_clusters), np.int32)
        for ci, name in enumerate(snap.names):
            cache = caches[name]
            n = len(cache.nodes)
            table[:, ci] = _node_sum_estimate_np(
                cache.available[:n], np.ones((len(uniq), n), bool), uniq)
        out[live] = table[inv.reshape(-1)]
        return out

    return extra


def run_estimator(device, card: str, clusters: int = 128, nodes: int = 4000,
                  bindings: int = 10_000) -> dict:
    """The in-process accurate estimator at bench.py's estimator-tier shape:
    ``clusters`` members of ``nodes`` seeded nodes behind an
    EstimatorRegistry, fed to the engine through ``extra_estimators``.
    Passes: cold (a fan-out: one K8 launch per cluster), steady (the
    batch-identity replay: none), hard refresh (``invalidate(drop=True)``:
    one per cluster) and pod events on 4 clusters then ``invalidate()``
    (4). Every row after the cold pass and after the pod events equals the
    numpy divider over merge(general, node-sum numpy mirror); no
    registered cluster may go unanswered or unmemoized (a fetch that
    raises answers -1 for its cluster, as in the JAX registry). The clusters
    are in name order (a solver sidecar's). Returns, for the sidecar
    estimator phase, the node caches, snapshot, problems, pod events and
    the cold and pod-event passes' outcome digests."""
    import karmada_tpu_torch
    from karmada_tpu_torch.estimator import AccurateEstimator, EstimatorRegistry, NodeCache
    from karmada_tpu_torch.scheduler import TensorScheduler

    t0 = time.perf_counter()
    snap, per_cluster, problems = estimator_workload(karmada_tpu_torch, clusters, nodes,
                                                     bindings)
    snap = by_name(karmada_tpu_torch, snap)
    caches = {name: NodeCache(snap.dims, per_cluster[name]) for name in snap.names}
    registry = EstimatorRegistry()
    for name in snap.names:
        registry.register(AccurateEstimator(name, caches[name], device=device))
    batch = registry.make_batch_estimator(snap.names)
    engine = TensorScheduler(snap, chunk_size=4096, extra_estimators=[batch], device=device)
    build_s = time.perf_counter() - t0
    referent = node_sum_referent(snap, caches)
    on_card = device.type == "cuda"
    want_k8 = {"cold": clusters, "steady": 0, "hard refresh": clusters, "pod events": 4}
    events = [(name, f"n{k}", {"cpu": 2000, "memory": 4 << 30})
              for name in snap.names[:: clusters // 4][:4] for k in range(3)]
    out = {"walls": {}, "k8": {}, "digests": {}, "caches": caches, "snap": snap,
           "problems": problems, "pod_events": events}
    first = None
    for kind in ("cold", "steady", "hard refresh", "pod events"):
        if kind == "hard refresh":
            registry.invalidate(drop=True)
        elif kind == "pod events":
            for name, node, req in events:
                caches[name].add_pod(node, req)
            registry.invalidate()
        reset_counts()
        t0 = time.perf_counter()
        res = engine.schedule(problems)
        sync(device)
        out["walls"][kind] = time.perf_counter() - t0
        counts = read_counts()
        out["k8"][kind] = counts["node_sum_estimate"]
        if kind == "cold":
            out["launches"] = counts
            first = outcomes(res)
        if kind in ("cold", "pod events"):
            out["digests"][kind] = outcome_digest(res)
        # a fetch that raises (a kernel that fails to build or launch)
        # answers -1 for its cluster, unmemoized: every cluster must have
        # answered and be memoized
        memoized = {name for name, _ in registry._memo}
        if batch.unanswered or memoized != set(snap.names):
            raise AssertionError(f"estimator {kind} pass: unanswered clusters "
                                 f"{sorted(batch.unanswered)[:5]}, memoized "
                                 f"{len(memoized)} of {len(snap.names)}")
        if on_card and out["k8"][kind] != want_k8[kind]:
            raise AssertionError(f"estimator {kind} pass: {out['k8'][kind]} K8 launches, "
                                 f"expected {want_k8[kind]}")
        if kind in ("steady", "hard refresh") and outcomes(res) != first:
            raise AssertionError(f"estimator {kind} pass disagrees with the cold pass")
        check = ""
        if kind in ("cold", "pod events"):
            t1 = time.perf_counter()
            bad = oracle_check(engine, problems, res, extra=referent)
            check = (f"; numpy-divider check over merge(general, node sums) "
                     f"{len(problems) - bad} ok / {bad} bad ({time.perf_counter() - t1:.1f} s)")
            if bad:
                raise AssertionError(f"estimator {kind} pass: {bad} rows differ")
        print(f"# estimator {kind} pass {out['walls'][kind]:.4f} s; K8 launches "
              f"{out['k8'][kind]}{check}; card {card}", flush=True)
    general = TensorScheduler(snap, chunk_size=4096, device=device)
    general.fleet_threshold = len(problems) + 1
    with uncounted():
        moved = sum(a != b for a, b in zip(outcomes(general.schedule(problems)), first))
    print(f"# estimator phase: {clusters} clusters x {nodes} nodes, {len(problems)} "
          f"bindings; build {build_s:.1f} s; rows the node sums move off the "
          f"summary-only answer: {moved}; fan-out seconds "
          f"{registry.fanout_seconds_total:.4f}; card {card}", flush=True)
    # K8 at this phase's shape: one cluster's nodes x the 8 profiles
    name0 = snap.names[0]
    cache0 = caches[name0]
    profiles = np.unique(engine._pack_chunk(problems[:4096], [
        engine._compiled(p.placement) for p in problems[:4096]], 0)[4], axis=0)
    n0 = len(cache0.nodes)
    with uncounted():
        out["k8_stats"] = check_node_sum(
            {"node_avail": cache0.available[:n0].copy(),
             "node_ok": np.ones((len(profiles), n0), bool), "requests": profiles},
            device, card, f"{len(profiles)}x{n0} (estimator phase)")
    return out


# --------------------------------------------------------------------------
# the quota plane and the ranked multi-term path
# --------------------------------------------------------------------------


def admit_batch(rng, b: int = 131_072, n: int = 32, r: int = 4) -> dict:
    """K12 inputs at the admission bound (B = 2^17 rows): ids interleaved
    over -1..N+1 (unquota'd rows and ids at or above N), demand up to
    2^20 with zero rows and rows at DEMAND_CLAMP, remaining that denies
    about half of each namespace's rows, and unlimited dims."""
    ns = (np.arange(b) % (n + 3) - 1).astype(np.int32)
    demand = rng.integers(0, 1 << 20, (b, r)).astype(np.int64)
    demand[rng.random((b, r)) < 0.1] = 0
    demand[rng.random(b) < 0.001] = 2**44
    per_ns = b // (n + 3)
    remaining = rng.integers(0, per_ns << 20, (n, r)).astype(np.int64)
    remaining[rng.random((n, r)) < 0.2] = 2**62
    return {"ns_ids": ns, "demand": demand, "remaining": remaining}


def caps_batch(rng, b: int = 4096, c: int = 5000, n: int = 8, r: int = 4) -> dict:
    """K13 inputs: caps with unlimited cells, negative hard limits and
    near-2^62 values; rows uncapped (-1), capped, and at or above N;
    requests of nothing, of 1 and beyond every cap."""
    caps = rng.integers(-5000, 1 << 24, (n, c, r)).astype(np.int64)
    caps[rng.random((n, c, r)) < 0.5] = 2**62
    caps[rng.random((n, c, r)) < 0.01] = 2**62 - 1
    req = rng.integers(0, 1 << 12, (b, r)).astype(np.int64)
    req[rng.random((b, r)) < 0.3] = 0
    req[0] = 0
    req[1] = [1] + [0] * (r - 1)
    req[2] = 1 << 40
    return {"caps": caps, "ns_rows": rng.integers(-1, n + 2, b).astype(np.int32),
            "requests": req}


#: divisors the multiplier-and-shift divisions of K13 and K1 must divide by
#: exactly: 1, 2, 3, 7, 2^k and 2^k +- 1 (k = 31, 32, 62), 2^40, 2^63 - 1
DIVISOR_EDGES = (1, 2, 3, 7, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32, 2**32 + 1,
                 2**40, 2**62 - 1, 2**62, 2**62 + 1, 2**63 - 1)
#: caps and capacities at the edges: INT64_MIN, -1, 0, UNLIMITED - 1,
#: UNLIMITED, INT64_MAX
CAP_EDGES = (-(2**63), -1, 0, 2**62 - 1, 2**62, 2**63 - 1)
#: K13 edge batches (B, C, N, R, kind): C about the 4-cell and 512-cell
#: steps and past 16,384; R = 1, 4, 17, 41; kind "mixed" (ids over
#: -1..N+1), "one" (every row in one namespace) or "misaligned" (mixed, and
#: on the card every input a view one element past a fresh allocation)
CAPS_EDGE_CASES = (
    (37, 1, 3, 4, "mixed"), (37, 3, 3, 1, "mixed"), (37, 4, 2, 4, "one"),
    (37, 5, 3, 17, "mixed"), (64, 127, 3, 4, "mixed"), (64, 128, 4, 41, "mixed"),
    (130, 129, 3, 4, "mixed"), (300, 512, 5, 4, "one"), (130, 513, 3, 1, "mixed"),
    (64, 5000, 4, 4, "mixed"), (33, 5001, 3, 4, "mixed"), (9, 16_385, 2, 4, "mixed"),
    (37, 5001, 3, 4, "misaligned"), (257, 1000, 6, 17, "mixed"),
)


def edge_multiples(rng, divisors: np.ndarray, count: int, negative: bool) -> np.ndarray:
    """``count`` dividends q d - 1, q d and q d + 1 of the given divisors
    (one each), q drawn over the whole int64 range of d's multiples (with
    ``negative``, negative q too) or small; kept inside int64."""
    lo, hi = -(2**63), 2**63 - 1
    qmax = hi // divisors
    qmin = lo // divisors if negative else np.zeros_like(divisors)
    # over the range in floats, a little inside it, so that no cast overflows
    up = (rng.random(count) * qmax.astype(float) * 0.999).astype(np.int64)
    down = -(rng.random(count) * -qmin.astype(float) * 0.999).astype(np.int64)
    wide = np.where(rng.random(count) < 0.5, up, down)
    q = np.where(rng.random(count) < 0.7, wide,
                 np.clip(rng.integers(-1000 if negative else 0, 1000, count), qmin, qmax))
    v = q * divisors
    step = rng.integers(-1, 2, count)
    return np.where(((step == 1) & (v == hi)) | ((step == -1) & (v == lo)), v, v + step)


def caps_edge_batch(rng, b: int, c: int, n: int, r: int, kind: str) -> dict:
    """K13 inputs on which it must stay exact. Requests: the divisors of
    ``DIVISOR_EDGES``, small ones and zeros; row 0 asks nothing, row 1 asks 1
    of every dim. Caps: ``CAP_EDGES`` (INT64_MIN, -1, 0, UNLIMITED - 1,
    UNLIMITED, INT64_MAX), UNLIMITED, multiples q d - 1, q d, q d + 1 of a
    divisor some row asks of that dim (negative q too), caps down to -2^62
    (with small divisors the quotient falls below -2^31: the int32 wrap) and
    small values. ns_rows over -1..N+1 (rows 2 and 3 uncapped and past N),
    or one namespace for every row."""
    div = np.array(DIVISOR_EDGES, np.int64)
    req = rng.integers(1, 5000, (b, r)).astype(np.int64)
    pick = rng.random((b, r))
    req[pick < 0.5] = rng.choice(div, int((pick < 0.5).sum()))
    req[pick > 0.85] = 0
    req[0] = 0
    if b > 1:
        req[1] = 1
    caps = rng.integers(-5000, 1 << 24, (n, c, r)).astype(np.int64)
    kind_of = rng.integers(0, 8, (n, c, r))
    caps[kind_of == 0] = 2**62
    caps[kind_of == 1] = rng.choice(np.array(CAP_EDGES, np.int64), int((kind_of == 1).sum()))
    caps[kind_of == 2] = rng.integers(-(2**62), -(2**40), int((kind_of == 2).sum()))
    cells = np.nonzero(kind_of >= 6)
    d = req[rng.integers(0, b, len(cells[0])), cells[2]]
    d = np.where(d > 0, d, rng.choice(div, len(cells[0])))
    caps[cells] = edge_multiples(rng, d, len(cells[0]), negative=True)
    if kind == "one":
        ns = np.full(b, int(rng.integers(0, n)), np.int32)
    else:
        ns = rng.integers(-1, n + 2, b).astype(np.int32)
        ns[2:4] = -1, n + 1  # an uncapped row and one past N in every batch
    return {"caps": caps, "ns_rows": ns, "requests": req}


#: K1 edge batches (B, C, U, R, E, kind): C as K13's; U = 1, 64 and 65
#: (about U_SHARED); E = 0, 1, 4, 5, 32 and 33 extra estimates (about the
#: merge form's group); kind "mixed", "zero_reps" (every row asks 0
#: replicas) or "misaligned" (on the card every input a view one element
#: past a fresh allocation)
ESTIMATE_EDGE_CASES = (
    (37, 1, 1, 4, 0, "mixed"), (37, 3, 64, 1, 1, "mixed"), (37, 4, 65, 4, 4, "mixed"),
    (37, 5, 9, 17, 5, "mixed"), (64, 127, 9, 4, 32, "mixed"), (64, 128, 64, 41, 33, "mixed"),
    (130, 129, 65, 4, 1, "mixed"), (300, 512, 8, 4, 2, "zero_reps"),
    (130, 513, 1, 1, 0, "mixed"), (64, 5000, 9, 4, 1, "mixed"), (33, 5001, 64, 4, 5, "mixed"),
    (9, 16_385, 65, 4, 1, "mixed"), (37, 5001, 9, 4, 4, "misaligned"),
    (257, 1000, 3, 17, 0, "mixed"),
)


def estimate_edge_batch(rng, b: int, c: int, u: int, r: int, e: int, kind: str) -> dict:
    """K1 inputs on which its three forms must stay exact. Profiles: the
    divisors of ``DIVISOR_EDGES``, small ones and zeros; profile 0 asks
    nothing (when U > 1). Capacities: ``CAP_EDGES``, multiples q d - 1, q d,
    q d + 1 of a divisor some profile asks of that dim, negatives and small
    values. prof_idx over -U-2..U+1 (negative indices wrap, then clamp;
    rows 0-2 take -1, -U-2 and U+1);
    has_summary 80% true; replicas 0 in a tenth of the rows (every row with
    ``zero_reps``), MAX_INT32 in some; ``e`` extra estimates over -1..300
    with MAX_INT32, INT32_MIN and -2 cells; ``table`` is the table form's
    answer (the merge form's input)."""
    hi32 = 2**31 - 1
    div = np.array(DIVISOR_EDGES, np.int64)
    prof = rng.integers(1, 5000, (u, r)).astype(np.int64)
    pick = rng.random((u, r))
    prof[pick < 0.5] = rng.choice(div, int((pick < 0.5).sum()))
    prof[pick > 0.85] = 0
    if u > 1:
        prof[0] = 0
    cap = rng.integers(-5000, 1 << 40, (c, r)).astype(np.int64)
    kind_of = rng.integers(0, 8, (c, r))
    cap[kind_of == 1] = rng.choice(np.array(CAP_EDGES, np.int64), int((kind_of == 1).sum()))
    cap[kind_of == 2] = rng.integers(0, 64, int((kind_of == 2).sum()))
    cells = np.nonzero(kind_of >= 6)
    d = prof[rng.integers(0, u, len(cells[0])), cells[1]]
    d = np.where(d > 0, d, rng.choice(div, len(cells[0])))
    cap[cells] = edge_multiples(rng, d, len(cells[0]), negative=False)
    reps = np.where(rng.random(b) < 0.1, 0, rng.integers(1, 100, b)).astype(np.int32)
    reps[rng.random(b) < 0.03] = hi32
    if kind == "zero_reps":
        reps[:] = 0
    extras = []
    for _ in range(e):
        x = rng.integers(-1, 300, (b, c)).astype(np.int32)
        roll = rng.random((b, c))
        x[roll < 0.05] = hi32
        x[(roll >= 0.05) & (roll < 0.07)] = -(2**31)
        x[(roll >= 0.07) & (roll < 0.09)] = -2
        extras.append(x)
    idx = rng.integers(-u - 2, u + 2, b).astype(np.int32)
    idx[:3] = -1, -u - 2, u + 1  # wraps; clamps to 0; clamps to U - 1
    return {"available_cap": cap, "profiles": prof, "prof_idx": idx,
            "has_summary": rng.random(c) < 0.8, "replicas": reps, "extras": extras}


def check_caps_edges(device, card: str) -> None:
    """K13's per-row form against its plain version on every
    ``CAPS_EDGE_CASES`` batch; exact."""
    from karmada_tpu_torch import ops

    t0 = time.perf_counter()
    for k, (b, c, n, r, kind) in enumerate(CAPS_EDGE_CASES):
        t = to_device(caps_edge_batch(np.random.default_rng(SEED + 1600 + k), b, c, n, r, kind),
                      device)
        if kind == "misaligned":
            t = misaligned(t)
        args = (t["caps"], t["ns_rows"], t["requests"])
        compare(f"quota_cluster_caps edge case {b}x{c} N={n} R={r} {kind}",
                ops.quota_cluster_caps(*args), ops.cluster_caps_ref(*args))
    print(f"# K13 per-row edge cases: {len(CAPS_EDGE_CASES)} exact (B x C x N x R: "
          + ", ".join(f"{b}x{c}x{n}x{r}{'' if kind == 'mixed' else ' ' + kind}"
                      for b, c, n, r, kind in CAPS_EDGE_CASES)
          + f"; {time.perf_counter() - t0:.1f} s); card {card}", flush=True)


def check_estimate_edges(device, card: str) -> None:
    """K1's three forms against their plain versions on every
    ``ESTIMATE_EDGE_CASES`` batch; exact."""
    import torch
    from karmada_tpu_torch import ops

    t0 = time.perf_counter()
    for k, (b, c, u, r, e, kind) in enumerate(ESTIMATE_EDGE_CASES):
        a = estimate_edge_batch(np.random.default_rng(SEED + 1700 + k), b, c, u, r, e, kind)
        extras = a.pop("extras")
        t = to_device(a, device)
        ex = [torch.from_numpy(x).to(device) for x in extras]
        if kind == "misaligned":
            t = misaligned(t)
            ex = list(misaligned({i: x for i, x in enumerate(ex)}).values())
        tag = f"{b}x{c} U={u} R={r} E={e} {kind}"
        args = [t[k2] for k2 in ("available_cap", "profiles", "prof_idx", "has_summary",
                                 "replicas")]
        compare(f"estimate_merge edge case {tag}", ops.estimate_merge(*args),
                ops.estimate_merge_ref(*args))
        targs = (t["available_cap"], t["profiles"], t["has_summary"])
        table = ops.profile_table(*targs)
        compare(f"profile_table edge case {tag}", table, ops.profile_table_ref(*targs))
        if kind == "misaligned":
            table = misaligned({"t": table})["t"]
        margs = (table, t["prof_idx"], tuple(ex), t["replicas"])
        compare(f"estimate_merge_table edge case {tag}", ops.estimate_merge_table(*margs),
                ops.estimate_merge_table_ref(*margs))
    print(f"# K1 edge cases: {len(ESTIMATE_EDGE_CASES)} exact in its three forms (B x C, U, "
          "R, E: " + ", ".join(f"{b}x{c} U={u} R={r} E={e}{'' if kind == 'mixed' else ' ' + kind}"
                               for b, c, u, r, e, kind in ESTIMATE_EDGE_CASES)
          + f"; {time.perf_counter() - t0:.1f} s); card {card}", flush=True)


#: K12's edge batches (``admit_edge_batch``)
ADMIT_EDGE_CASES = ("b1", "ragged", "n0", "n1", "unquotad", "past_n", "runs", "tile_runs",
                    "clamp", "remaining0", "unlimited", "head_of_line", "r1", "r16", "r17",
                    "r40")


def admit_edge_batch(case: str) -> dict:
    """K12 inputs on which it must stay exact, by ``case`` (each drawn from
    its own seed, so the CPU tests pose the same batches): B = 1; a ragged
    wave (6921 rows: three sort tiles and part of a fourth) with ids over
    -1..N+1; N = 0 and N = 1; every row unquota'd; every id at or above
    N; namespaces in runs of 1500 rows across the tile edges, and runs of
    exactly one tile; 2^17 rows of one namespace at DEMAND_CLAMP (the sum
    reaches 2^61; a dim limited at 2^61 - 2^44 denies the last row alone);
    remaining 0 (the first half of the wave asks nothing and is admitted)
    and remaining
    UNLIMITED; a denied row followed by smaller rows that would fit, which
    it keeps out (its place in line); R = 1, 16, 17 and 40, each namespace
    bound on one dim (the last for even namespaces, the first for odd)."""
    rng = np.random.default_rng(1200 + ADMIT_EDGE_CASES.index(case))
    b, n, r = 6921, 32, 4
    if case == "b1":
        b = 1
    elif case in ("n0", "n1"):
        n = int(case[1])
    elif case[0] == "r" and case[1:].isdigit():
        n, r = 5, int(case[1:])
    ns = rng.integers(-1, n + 2, b).astype(np.int32)
    demand = rng.integers(0, 1 << 20, (b, r)).astype(np.int64)
    demand[rng.random((b, r)) < 0.1] = 0
    if case == "unquotad":
        ns[:] = -1
    elif case == "past_n":
        ns = rng.integers(n, n + 5, b).astype(np.int32)
    elif case == "runs":
        n = 5
        ns = np.minimum(np.arange(b) // 1500, n - 1).astype(np.int32)
        ns[::97] = -1
    elif case == "tile_runs":
        n, b = 4, 4 * 2048 + 100
        ns = (np.arange(b) // 2048).astype(np.int32)  # the last 100 rows: id N
        demand = rng.integers(0, 1 << 20, (b, r)).astype(np.int64)
    elif case == "clamp":
        b, n, r = 1 << 17, 1, 2
        ns, demand = np.zeros(b, np.int32), np.full((b, r), 2**44, np.int64)
        return {"ns_ids": ns, "demand": demand,
                "remaining": np.array([[2**62, 2**61 - 2**44]], np.int64)}
    elif case == "head_of_line":
        b, n, r = 5000, 2, 1
        ns = (np.arange(b) % 2).astype(np.int32)
        demand = np.ones((b, r), np.int64)
        demand[200], demand[b - 1] = 10**6, 10**6  # namespace 0 early, 1 last
        return {"ns_ids": ns, "demand": demand, "remaining": np.array([[1500], [3000]])}
    remaining = np.zeros((n, r), np.int64)
    for k in range(n):
        remaining[k] = demand[ns == k].sum(axis=0) // 2
    remaining[rng.random((n, r)) < 0.2] = 2**62
    if case[0] == "r" and case[1:].isdigit():
        remaining[:] = 2**62
        for k in range(n):
            dim = r - 1 if k % 2 == 0 else 0
            remaining[k, dim] = demand[ns == k, dim].sum() // 2
    elif case == "remaining0":  # the first half asks nothing: admitted
        remaining[:] = 0
        demand[: b // 2] = 0
    elif case == "unlimited":
        remaining[:] = 2**62
    return {"ns_ids": ns, "demand": demand, "remaining": remaining}


def check_admit_edges(device, card: str) -> None:
    """K12 against its plain version on every ``admit_edge_batch`` case;
    exact."""
    from karmada_tpu_torch import ops

    for case in ADMIT_EDGE_CASES:
        t = to_device(admit_edge_batch(case), device)
        args = (t["ns_ids"], t["demand"], t["remaining"])
        got = ops.quota_admit(*args)
        compare(f"quota_admit edge case {case}", got, ops.quota_admit_ref(*args))
    print(f"# K12 edge cases: {len(ADMIT_EDGE_CASES)} exact ({', '.join(ADMIT_EDGE_CASES)}); "
          f"card {card}", flush=True)


def check_quota_kernels(rng, device, card: str) -> dict:
    """K12 at B = 131072 with N = 32 (R = 4, 17 and 40) and N = 1, 1024 and
    4096 (R = 4), and on its edge batches; K13's per-row form at 4096 x 5000;
    against their plain versions on the card; exact."""
    from karmada_tpu_torch import ops

    stats = {}
    wide = np.random.default_rng(SEED + 32)  # the namespace counts' own draws
    for n, r in ((32, 4), (32, 17), (32, 40), (1, 4), (1024, 4), (4096, 4)):
        t = to_device(admit_batch(rng if n == 32 else wide, n=n, r=r), device)
        args = (t["ns_ids"], t["demand"], t["remaining"])
        got = ops.quota_admit(*args)
        b = t["demand"].shape[0]
        err = compare(f"quota_admit N={n} R={r}", got, ops.quota_admit_ref(*args))
        denied = int((~got[0]).sum().item())
        st = timed(f"quota_admit (K12) B={b} N={n} R={r}", lambda: ops.quota_admit(*args),
                   lambda: ops.quota_admit_ref(*args), _nbytes(*args, *got),
                   # per row and dim: the scan's add, the compare, the admitted add
                   b * r * 3, card)
        print(f"# K12 at N={n} R={r}: exact, {denied} of {b} rows denied", flush=True)
        if (n, r) == (32, 4):
            stats["quota_admit"] = dict(st, max_abs_err=err)
    check_admit_edges(device, card)
    t = to_device(caps_batch(rng), device)
    args = (t["caps"], t["ns_rows"], t["requests"])
    got = ops.quota_cluster_caps(*args)
    b, c = got.shape
    err = compare("quota_cluster_caps", got, ops.cluster_caps_ref(*args))
    stats["quota_cluster_caps"] = dict(timed(
        f"quota_cluster_caps (K13 per-row form) {b}x{c}",
        lambda: ops.quota_cluster_caps(*args), lambda: ops.cluster_caps_ref(*args),
        # the caps of the rows' namespaces, the requests, the answers
        _nbytes(*args, got), b * c * r * 3, card,
    ), max_abs_err=err)
    return stats


def check_caps_fold(engine, card: str) -> dict:
    """K13's fold form against its plain version on the quota cell's own
    profile table (the fleet's padded interned profiles x 5000 clusters,
    K1's table form before the fold) and cap tensor; exact."""
    import torch
    from karmada_tpu_torch import ops
    from karmada_tpu_torch.scheduler.fleet import _pow2

    fleet = engine._fleet
    profs = np.stack(fleet._profiles)
    pad = _pow2(max(len(profs), 4))
    profs_p = np.zeros((pad, profs.shape[1]), np.int64)
    profs_p[: len(profs)] = profs
    prof_ns = np.full(pad, -1, np.int32)
    prof_ns[: len(profs)] = fleet._prof_ns
    base = engine._profile_table(profs_p)
    dev = base.device
    rest = (engine._caps_device(), torch.from_numpy(prof_ns).to(dev),
            torch.from_numpy(profs_p).to(dev))
    t_k, t_r = base.clone(), base.clone()
    ops.quota_caps_fold(t_k, *rest)
    ops.quota_caps_fold_ref(t_r, *rest)
    err = compare("quota_caps_fold", t_k, t_r)
    if not torch.equal(t_k, fleet._dev_tables[3]):
        raise AssertionError("quota_caps_fold: the fleet's table differs from a fresh fold")
    u, c = base.shape
    r = profs.shape[1]
    changed = int((t_k != base).sum().item())
    capped = int((prof_ns >= 0).sum())
    used_ns = torch.from_numpy(np.unique(prof_ns[prof_ns >= 0]).astype(np.int64)).to(dev)
    print(f"# K13 fold on the quota table: {u} profiles ({capped} capped) x {c} "
          f"clusters; the fold changed {changed} cells", flush=True)
    # the fold is idempotent on its table, so repeated launches time it
    return dict(timed(
        f"quota_caps_fold (K13 fold form) {u}x{c}",
        lambda: ops.quota_caps_fold(t_k, *rest),
        lambda: ops.quota_caps_fold_ref(t_r, *rest),
        # the capped rows' int32 table cells read and written once, the
        # caps of the namespaces they name read once
        _nbytes(rest[0][used_ns], rest[1], rest[2]) + capped * c * 2 * base.element_size(),
        capped * c * r * 3, card,
    ), max_abs_err=err)


def check_partition(tag, snap, problems, results, q, rem0) -> tuple[int, int, np.ndarray]:
    """The pass's admitted/denied partition against the sequential numpy
    oracle (``admit_wave_np``) over the remaining quota the pass started
    from. Returns (admitted quota'd rows, denied rows, the wave's admitted
    demand per namespace); raises on any difference."""
    from karmada_tpu_torch.refimpl.quota_np import admit_wave_np
    from karmada_tpu_torch.scheduler.quota import QUOTA_EXCEEDED_ERROR

    ns_ids, demand = wave_demand(snap, problems, q.ns_index)
    flags, used = admit_wave_np(ns_ids, demand, rem0)
    denied = np.fromiter((r.error == QUOTA_EXCEEDED_ERROR for r in results), bool,
                         len(results))
    bad = int((denied == np.asarray(flags, bool)).sum())
    if bad:
        raise AssertionError(f"{tag}: {bad} rows' admission differs from admit_wave_np")
    quotad = np.asarray(ns_ids) >= 0
    return int((quotad & ~denied).sum()), int(denied.sum()), used


def check_admitted(tag, engine, problems, results, rows=None) -> tuple[int, float]:
    """Every admitted row (of ``rows`` when given) against the numpy
    divider on cap-folded availability (``oracle_check``); raises on any
    difference. Returns (rows checked, seconds)."""
    from karmada_tpu_torch.scheduler.quota import QUOTA_EXCEEDED_ERROR

    idx = [i for i in (range(len(problems)) if rows is None else rows)
           if results[i].error != QUOTA_EXCEEDED_ERROR]
    t0 = time.perf_counter()
    bad = oracle_check(engine, [problems[i] for i in idx], [results[i] for i in idx])
    secs = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"{tag}: {bad} admitted rows differ from the numpy divider")
    return len(idx), secs


def cpu_usage(problems, results) -> dict:
    """namespace -> {"cpu": bound replicas x per-replica cpu}, the FRQ
    status controller's usage after a pass: a row that placed is bound
    where it placed, any other row where it was before."""
    used = {ns: {"cpu": 0} for ns in QUOTA_NAMESPACES}
    for p, r in zip(problems, results):
        bound = r.clusters if r.success else p.prev
        used[p.namespace]["cpu"] += sum(bound.values()) * int(p.requests.get("cpu", 0))
    return used


def run_quota(device, card: str, bindings=None, clusters=None, general_rows: int = 20_000,
              raised: str = "nsq02") -> dict:
    """The quota cell: config 5 in 32 namespaces, one FRQ each, the first
    four also capping cluster 0 (K13's fold runs in the table rebuild).
    Passes on the fleet route: cold (generous limits: every row admitted),
    steady (the ``_quota_cache`` replay: no K12 launch), surge (the even
    rows grow by 3 replicas, every row's previous placement is its cold
    one, and each namespace's cpu limit is its cold usage plus 0.4 x its
    surge demand), raise (``raised``'s limit lifted with a generation bump;
    rows the surge placed hold their placement), delta (2% of the rows
    rebuilt in the same generation: the delta admission). Every pass's
    partition equals ``admit_wave_np`` (the delta pass's over its rebuilt
    rows, the rest replaying the raise pass); the cold and surge passes'
    admitted rows, the raised namespace's rows and the delta pass's rebuilt
    admitted rows equal the numpy divider on cap-folded availability. Then the surge wave's first ``general_rows`` rows on the
    general route (K12, K13's per-row form, K1 table and merge forms, K2)
    against the fleet's rows."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import BindingProblem, TensorScheduler
    from karmada_tpu_torch.scheduler.quota import build_quota_snapshot

    pkg = karmada_tpu_torch
    t0 = time.perf_counter()
    snap, problems = quota_workload(pkg, bindings, clusters)
    n = len(problems)
    build_s = time.perf_counter() - t0
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    limits = {ns: dict(GENEROUS) for ns in QUOTA_NAMESPACES}
    engine.set_quota(build_quota_snapshot(quota_frqs(pkg, snap, limits), snap, 1))
    on_card = device.type == "cuda"
    out = {"walls": {}, "k12": {}, "admitted": {}, "denied": {}}
    reset_counts()

    def one_pass(kind, batch, replay=False, rows=None):
        """One pass of ``batch``: its K12 launches, and its partition and
        debit against ``admit_wave_np`` over ``rows`` (every row when
        None; the delta pass admits only its rebuilt rows again)."""
        q = engine.quota
        rem0 = q.remaining.copy()
        k12 = read_counts()["quota_admit"]
        t0 = time.perf_counter()
        res = engine.schedule(batch)
        sync(device)
        out["walls"][kind] = time.perf_counter() - t0
        out["k12"][kind] = read_counts()["quota_admit"] - k12
        if on_card and out["k12"][kind] != (0 if replay else 1):
            raise AssertionError(f"quota {kind} pass: {out['k12'][kind]} K12 launches")
        part = (batch, res) if rows is None else (
            [batch[i] for i in rows], [res[i] for i in rows])
        adm, den, used = check_partition(f"quota {kind} pass", snap, *part, q, rem0)
        want = rem0 if replay else np.where(rem0 < 2**62, np.maximum(rem0 - used, 0), rem0)
        if not np.array_equal(q.remaining, want):
            raise AssertionError(f"quota {kind} pass: the debit differs from the oracle's")
        out["admitted"][kind], out["denied"][kind] = adm, den
        print(f"# quota {kind} pass {out['walls'][kind]:.4f} s [{breakdown_line(engine)}]; "
              f"K12 launches {out['k12'][kind]}; {adm} quota'd rows admitted, {den} "
              f"denied, equal to admit_wave_np; card {card}", flush=True)
        return res

    cold = one_pass("cold", problems)
    if engine._fleet is None:
        raise AssertionError("the quota cold pass did not ride the fleet table")
    if out["denied"]["cold"]:
        raise AssertionError("quota cold pass: generous limits denied rows")
    cold_out = outcomes(cold)  # decoded before the next pass rewrites the table
    rows, secs = check_admitted("quota cold pass", engine, problems, cold)
    print(f"# quota cold pass: numpy-divider check over cap-folded availability "
          f"{rows} ok / 0 bad ({secs:.1f} s)", flush=True)
    with uncounted():
        out["fold_stats"] = check_caps_fold(engine, card)
    steady = one_pass("steady", problems, replay=True)
    if outcomes(steady) != cold_out:
        raise AssertionError("quota steady pass disagrees with the cold pass")

    # the surge: the even rows grow by 3 replicas over their cold placement
    surge = []
    for i, (p, r) in enumerate(zip(problems, cold)):
        surge.append(BindingProblem(
            key=p.key, placement=p.placement, replicas=p.replicas + 3 * (i % 2 == 0),
            requests=p.requests, gvk=p.gvk,
            prev=dict(r.clusters) if r.success else dict(p.prev),
            namespace=p.namespace))
    used = cpu_usage(problems, cold)
    ns_index = {ns: k for k, ns in enumerate(QUOTA_NAMESPACES)}
    ns_ids, demand = wave_demand(snap, surge, ns_index)
    cpu_dim = list(snap.dims).index("cpu")
    surge_cpu = {ns: 0 for ns in QUOTA_NAMESPACES}
    for i, p in enumerate(surge):
        surge_cpu[p.namespace] += int(demand[i, cpu_dim])
    limits = {ns: {"cpu": used[ns]["cpu"] + int(0.4 * surge_cpu[ns])}
              for ns in QUOTA_NAMESPACES}
    surge_frqs = quota_frqs(pkg, snap, limits, used)
    engine.set_quota(build_quota_snapshot(surge_frqs, snap, 2))
    if engine._fleet is None:
        raise AssertionError("a generation bump with the same caps dropped the fleet table")
    from karmada_tpu_torch.scheduler.fleet import K_PREV

    print(f"# quota surge wave: {sum(len(p.prev) > K_PREV for p in surge)} of {n} rows "
          f"hold more than K_PREV = {K_PREV} previous sites (the host general route)",
          flush=True)
    surge_res = one_pass("surge", surge)
    if not (out["admitted"]["surge"] > 0 and out["denied"]["surge"] > 0):
        raise AssertionError(f"quota surge: admitted {out['admitted']['surge']}, "
                             f"denied {out['denied']['surge']}")
    rows, secs = check_admitted("quota surge pass", engine, surge, surge_res)
    print(f"# quota surge pass: numpy-divider check over cap-folded availability "
          f"{rows} ok / 0 bad ({secs:.1f} s)", flush=True)
    surge_out = outcomes(surge_res)
    # the surge wave again with provenance armed (a replay of its partition:
    # no K12 launch, no debit); every denied row carries the QuotaExceeded
    # bit on every cluster, and no admitted row carries it
    from karmada_tpu_torch.ops.explain import BIT_QUOTA_ADMIT
    from karmada_tpu_torch.scheduler.quota import QUOTA_EXCEEDED_ERROR

    ex = explain_capture("explain quota", engine, surge, device, card)
    if outcomes(ex["results"]) != surge_out:
        raise AssertionError("explain quota: the armed replay placed differently")
    denied = 0
    for cap in ex["store"].captures():
        bit = (cap.uniq_masks[cap.mask_inv] >> BIT_QUOTA_ADMIT) & 1
        is_denied = np.array([e == QUOTA_EXCEEDED_ERROR for e in cap.errors])
        if not ((bit.all(axis=1) == is_denied).all() and (bit.any(axis=1) == is_denied).all()):
            raise AssertionError("explain quota: a QuotaExceeded bit disagrees with a verdict")
        denied += int(is_denied.sum())
    if not denied:
        raise AssertionError("explain quota: the surge denied nothing")
    print(f"# explain quota: the surge wave armed {ex['wall']:.4f} s (disarmed "
          f"{out['walls']['surge']:.4f} s); {denied} denied rows carry QuotaExceeded on every "
          f"cluster; card {card}", flush=True)
    out["explain"] = {"wall": ex["wall"], "launches": ex["launches"], "denied": denied,
                      "captures": ex["captures"]}

    # the raise: placed surge rows hold their placement; one namespace's
    # limit is lifted
    raise_wave = [
        BindingProblem(key=p.key, placement=p.placement, replicas=p.replicas,
                       requests=p.requests, gvk=p.gvk, prev=dict(r.clusters),
                       namespace=p.namespace)
        if r.success else p
        for p, r in zip(surge, surge_res)
    ]
    used = cpu_usage(surge, surge_res)
    limits[raised] = {"cpu": 1 << 40}
    engine.set_quota(build_quota_snapshot(quota_frqs(pkg, snap, limits, used), snap, 3))
    raised_res = one_pass("raise", raise_wave)
    in_ns = [i for i, p in enumerate(raise_wave) if p.namespace == raised]
    was = sum(surge_res[i].error == QUOTA_EXCEEDED_ERROR for i in in_ns)
    now = sum(raised_res[i].error == QUOTA_EXCEEDED_ERROR for i in in_ns)
    if not (was > 0 and now == 0):
        raise AssertionError(f"quota raise: {raised} denials {was} -> {now}")
    rows, secs = check_admitted("quota raise pass", engine, raise_wave, raised_res, in_ns)
    print(f"# quota raise of {raised}: its denials {was} -> 0; its {rows} rows equal the "
          f"numpy divider ({secs:.1f} s)", flush=True)
    raised_out = outcomes(raised_res)  # decoded before a later pass rewrites the table

    # the delta admission: the same generation, 2% of the rows rebuilt as
    # new problem objects (a controller rebuilding changed bindings): only
    # they are admitted again, the rest replay uncharged
    moved = np.random.default_rng(SEED + 8).choice(n, n // 50, replace=False)
    delta_wave = list(raise_wave)
    for i in moved:
        p = raise_wave[i]
        delta_wave[i] = BindingProblem(key=p.key, placement=p.placement,
                                       replicas=p.replicas, requests=p.requests,
                                       gvk=p.gvk, prev=dict(p.prev), namespace=p.namespace)
    sub = sorted(map(int, moved))
    delta_res = one_pass("delta", delta_wave, rows=sub)
    kept = sorted(set(range(n)) - set(sub))
    delta_out = outcomes(delta_res)
    if any(delta_out[i] != raised_out[i] for i in kept):
        raise AssertionError("quota delta pass: an unchanged row moved")
    rows, secs = check_admitted("quota delta pass", engine, delta_wave, delta_res, sub)
    print(f"# quota delta pass: {len(sub)} rebuilt rows admitted again, {len(kept)} "
          f"replayed; the rebuilt admitted rows equal the numpy divider ({rows} rows, "
          f"{secs:.1f} s)", flush=True)
    out["launches"] = read_counts()

    # the general route: the surge wave's first rows, the surge's quota
    general = TensorScheduler(snap, chunk_size=4096, device=device)
    head = surge[:general_rows]
    general.fleet_threshold = len(head) + 1
    general.set_quota(build_quota_snapshot(surge_frqs, snap, 2))
    reset_counts()
    t0 = time.perf_counter()
    g_res = general.schedule(head)
    sync(device)
    out["walls"]["general"] = time.perf_counter() - t0
    out["general_launches"] = read_counts()
    bad = sum(a != b for a, b in zip(outcomes(g_res), surge_out[: len(head)]))
    print(f"# quota general route: the surge wave's first {len(head)} rows in "
          f"{out['walls']['general']:.4f} s; launches "
          f"{ {k: v for k, v in out['general_launches'].items() if v} }; equal to the "
          f"fleet's checked surge rows: {len(head) - bad} ok / {bad} bad; card {card}",
          flush=True)
    if bad:
        raise AssertionError(f"quota general route: {bad} rows differ from the fleet's")
    print(f"# quota phase: {n} bindings x {snap.num_clusters} clusters in "
          f"{len(QUOTA_NAMESPACES)} namespaces ({CAP_NAMESPACES} capped); build "
          f"{build_s:.1f} s; launches { {k: v for k, v in out['launches'].items() if v} }",
          flush=True)
    return out


def referent_groups(snap, placement) -> tuple[list[str], np.ndarray]:
    """(group names, bool[T, C]) of ``placement``'s ClusterAffinities terms,
    evaluated here on the clusters' names and labels and not through the
    port's placement compiler: the exclude list wins, then the cluster
    names (when given) and the label selector (match_labels, and In, NotIn,
    Exists, DoesNotExist expressions) must all pass. A field selector
    raises: no ranked workload of this script names one."""
    out = np.zeros((len(placement.cluster_affinities), snap.num_clusters), bool)
    for t, term in enumerate(placement.cluster_affinities):
        if term.field_selector is not None:
            raise NotImplementedError("referent_groups: field selectors")
        sel = term.label_selector
        for j, cl in enumerate(snap.clusters):
            labels = cl.meta.labels
            ok = cl.name not in term.exclude and (
                not term.cluster_names or cl.name in term.cluster_names)
            if ok and sel is not None:
                ok = all(labels.get(k) == v for k, v in sel.match_labels.items())
                for e in sel.match_expressions:
                    has = e.key in labels
                    ok = ok and {"In": has and labels.get(e.key) in e.values,
                                 "NotIn": not has or labels[e.key] not in e.values,
                                 "Exists": has, "DoesNotExist": not has}[e.operator]
            out[t, j] = ok
    return [term.affinity_name for term in placement.cluster_affinities], out


def ranked_referent(engine, problems, results) -> int:
    """Every row against the port's copy of the ordered-failover referent
    (``failover_np.solve_one_ordered``: try each group in order, divide with
    the numpy divider, keep the first that schedules), run per row. The
    group masks come from ``referent_groups`` and the caps from
    ``referent_caps``; the other filters
    (taints, API enablement), the requests and the numpy estimate come from
    the engine's packing (``with_affinity=False``) and host mirror. Returns
    the number of rows whose placement, group or error differs. Rows are
    checked on a pool of threads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from karmada_tpu_torch.refimpl.failover_np import solve_one_ordered

    snap = engine.snapshot
    names = snap.names
    groups = {}
    for p in problems:
        if id(p.placement) not in groups:
            groups[id(p.placement)] = referent_groups(snap, p.placement)
    compiled_all = [engine._compiled(p.placement) for p in problems]

    def chunk_bad(start: int) -> int:
        chunk = problems[start : start + engine.chunk_size]
        compiled = compiled_all[start : start + engine.chunk_size]
        base, strategy, replicas, static_w, requests, prev, fresh = (
            engine._pack_chunk(chunk, compiled, 0, with_affinity=False)
        )
        caps = referent_caps(engine, chunk, requests)
        avail = engine._availability_np(requests, replicas,
                                        extras=() if caps is None else (caps,))
        bad = 0
        for i, (p, got) in enumerate(zip(chunk, results[start : start + len(chunk)])):
            term_names, terms = groups[id(p.placement)]
            a, ti, err = solve_one_ordered(terms, base[i], int(strategy[i]),
                                           int(replicas[i]), static_w[i], avail[i],
                                           prev[i], bool(fresh[i]))
            want = {} if a is None else {names[j]: int(a[j]) for j in np.flatnonzero(a > 0)}
            bad += (got.clusters, got.affinity_name, got.error) != (
                want, term_names[ti], err)
        return bad

    starts = range(0, len(problems), engine.chunk_size)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return sum(pool.map(chunk_bad, starts))


def ranked_breakdown(engine, problems, device) -> dict:
    """Host-clock seconds of each stage of ``_schedule_chunk_ranked`` on the
    first chunk of ``problems``, synchronising the card after each device
    stage: pack (numpy masks, no term stack), estimate (uploads, K1 table
    form, K13, K1 merge form), upload (K17's inputs: base, term masks,
    prev, flags), first_fit_group (K17), fetch (rank and selected to the
    host), assign (uploads + kernel_variant's max + K2, the result
    fetched), unpack."""
    from karmada_tpu_torch.ops.masks import first_fit_group

    chunk = problems[: engine.chunk_size]
    compiled = [engine._compiled(p.placement) for p in chunk]
    out = {}
    t0 = time.perf_counter()
    padded, (base, strategy, replicas, static_w, requests, prev, fresh) = engine._pad_chunk(
        engine._pack_chunk(chunk, compiled, 0, with_affinity=False))
    out["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_small, avail = engine._chunk_availability(chunk, requests, replicas, padded)
    sync(device)
    out["estimate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = engine._group_inputs(compiled, padded, base, avail, replicas, prev, strategy, fresh)
    sync(device)
    out["upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rank, _fit, selected = first_fit_group(*g)
    sync(device)
    out["first_fit_group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rank, feasible = rank.cpu().numpy(), selected.cpu().numpy()
    out["fetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assignment, unsched = engine._solve_chunk(host_small, strategy, replicas, feasible,
                                              static_w, avail, prev, fresh, prev_dev=g[6])
    out["assign"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine._unpack(chunk, compiled, rank, feasible, assignment, unsched)
    out["unpack"] = time.perf_counter() - t0
    return out


def check_ranked_groups(engine, problems, card: str) -> None:
    """K17 against its plain version on each chunk of the ranked cell as
    the engine hands it over (``_group_inputs`` after the chunk's packing
    and availability); exact; the first chunk timed."""
    for start in range(0, len(problems), engine.chunk_size):
        chunk = problems[start : start + engine.chunk_size]
        compiled = [engine._compiled(p.placement) for p in chunk]
        padded, (base, strategy, replicas, _sw, requests, prev, fresh) = engine._pad_chunk(
            engine._pack_chunk(chunk, compiled, 0, with_affinity=False))
        _small, avail = engine._chunk_availability(chunk, requests, replicas, padded)
        g = engine._group_inputs(compiled, padded, base, avail, replicas, prev,
                                 strategy, fresh)
        check_first_fit_group(dict(zip(GROUP_ARGS, g)), card,
                              f"ranked chunk at row {start} ({padded} rows)",
                              time_it=start == 0)


def run_ranked(device, card: str, bindings: int = 10_000, clusters=None) -> dict:
    """The ranked cell (``ranked_workload``): ordered-failover rows with
    three ClusterAffinities terms over the config-5 fleet, half of them in
    namespaces whose static assignments cap 600 clusters, through the
    engine's ranked path on the card (K12 admission, then per chunk K1's
    table form, K13's per-row form, K1's merge form, K17 and K2). Every row
    equals the ordered-failover referent; some rows must land on a fallback
    group. K17 is held to its plain version on each of the cell's chunks."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler
    from karmada_tpu_torch.scheduler.quota import build_quota_snapshot

    pkg = karmada_tpu_torch
    t0 = time.perf_counter()
    snap, problems = ranked_workload(pkg, bindings, clusters)
    limits = {ns: dict(GENEROUS) for ns in RANKED_NAMESPACES}
    quota = build_quota_snapshot(quota_frqs(pkg, snap, limits, caps=ranked_caps(snap)),
                                 snap, 1)
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    engine.set_quota(quota)
    build_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res = engine.schedule(problems)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    bad = ranked_referent(engine, problems, res)
    check_s = time.perf_counter() - t0
    first = {cp.terms[0][0] for cp in (engine._compiled(p.placement) for p in problems[:4])}
    by_group = {}
    for r in res:
        key = r.affinity_name if r.success else "failed"
        by_group[key] = by_group.get(key, 0) + 1
    fallback = sum(v for k, v in by_group.items() if k not in first and k != "failed")
    with uncounted():
        check_ranked_groups(engine, problems, card)
        stages = ranked_breakdown(engine, problems, device)
    print(f"# ranked chunk stages of one 4096-row chunk (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()) + f"; card {card}",
          flush=True)
    print(f"# ranked phase: {len(problems)} bindings x {snap.num_clusters} clusters, "
          f"3 affinity groups, one pass {wall:.4f} s ({len(problems) / wall:.0f} "
          f"bindings/s); rows by group {dict(sorted(by_group.items()))}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; ordered-failover referent "
          f"{len(problems) - bad} ok / {bad} bad ({check_s:.1f} s); build {build_s:.1f} s; "
          f"card {card}", flush=True)
    if bad:
        raise AssertionError(f"ranked phase: {bad} rows differ from the referent")
    if not fallback:
        raise AssertionError("ranked phase: no row landed on a fallback group")
    return {"launches": launches, "pass_s": wall, "by_group": by_group,
            "stages": stages, "fallback": fallback}


# --------------------------------------------------------------------------
# provenance (K14) and preemption (K15)
# --------------------------------------------------------------------------


def explain_batch(rng, b: int, c: int) -> dict:
    """K14 inputs full of key ties: availability in [-1, 4) (-1 = no
    summary), 5% of the cells assigned, caps and every stage mask mixed."""
    return {
        "aff_ok": rng.random((b, c)) < 0.8,
        "taint_ok": rng.random((b, c)) < 0.9,
        "api_ok": rng.random((b, c)) < 0.95,
        "spread_ok": rng.random((b, c)) < 0.85,
        "avail": rng.integers(-1, 4, (b, c), dtype=np.int32),
        "caps": np.where(rng.random((b, c)) < 0.2, rng.integers(-1, 4, (b, c), dtype=np.int32),
                         np.int32(2**31 - 1)).astype(np.int32),
        "admitted": rng.random(b) < 0.9,
        "dynamic": rng.random(b) < 0.8,
        "replicas": rng.integers(0, 12, b, dtype=np.int32),
        "assignment": np.where(rng.random((b, c)) < 0.05,
                               rng.integers(1, 4, (b, c), dtype=np.int32), 0).astype(np.int32),
        "prev": rng.integers(0, 3, (b, c), dtype=np.int32),
        "preempted": rng.random((b, c)) < 0.01,
    }


def explain_bound(t: dict, k: int) -> tuple[int, int]:
    """(bytes, operations) K14 must move and do on the device tensors ``t``:
    each input read once (``prev`` only at the k winners of a row: the
    gather is its one read), the mask and the top-k written once; 12
    integer operations a cell (8 stage bits, the key's multiply-add, two
    compares)."""
    b, c = t["aff_ok"].shape
    nbytes = (_nbytes(*(v for name, v in t.items() if name != "prev")) + b * k * 4
              + b * c + b * k * 5 * 4)
    return nbytes, 12 * b * c


def check_explain_kernel(rng, device, card: str) -> dict:
    """K14 against its plain version on the card, exact, at the main path's
    chunk (4096 x 5000, k = 8) and at C = 5 (k = 5); timed at the first."""
    import torch
    from karmada_tpu_torch import ops

    stats = None
    for b, c in ((4096, 5000), (64, 5)):
        t = to_device(explain_batch(rng, b, c), device)
        args = list(t.values())
        k = ops.topk_width(c)
        kern = lambda: ops.explain_pass(*args, k=k)  # noqa: E731
        plain = lambda: ops.explain_pass_ref(*args, k=k)  # noqa: E731
        compare(f"explain_pass {b}x{c}", kern(), plain())
        torch.cuda.synchronize()
        if stats is None:
            stats = timed("explain_pass", kern, plain, *explain_bound(t, k), card)
    print(f"# kernel explain_pass at C = 5: exact; card {card}", flush=True)
    return stats


#: K14 edge batches (B, C, k): every C about the 16-cell step and a warp's
#: 512 cells at k = topk_width(C), and k = 1..7 at C = 5000; B odd, so with
#: an odd C the rows start at every byte offset mod 16
EXPLAIN_EDGE_C = (1, 5, 7, 8, 15, 16, 17, 31, 33, 5000, 5001, 16_385)
EXPLAIN_EDGE_CASES = (tuple((37, c, min(c, 8)) for c in EXPLAIN_EDGE_C)
                      + tuple((37, 5000, k) for k in range(1, 8)))


def explain_edge_batch(rng, b: int, c: int) -> dict:
    """K14 inputs on which it must stay exact, rows by kind (i mod 7): 0
    mixed; 1 every key tied (one availability, nothing assigned); 2 ties on
    availability alone (nothing assigned, availability in {0, 1, 2}); 3
    extremes (assignment and availability at MAX_INT32, availability at -1
    and INT32_MIN, assignment INT32_MIN: keys that wrap int64); 4 fewer
    than k non-zero keys (availability -1 but for at most k - 1 cells); 5
    padding rows as the JAX engine pads (replicas 0, all-false masks,
    admitted, nothing else set); 6 negative keys (availability down to
    INT32_MIN, nothing assigned)."""
    lo, hi = -(2**31), 2**31 - 1
    kind = np.arange(b) % 7
    t = {
        "aff_ok": rng.random((b, c)) < 0.8,
        "taint_ok": rng.random((b, c)) < 0.9,
        "api_ok": rng.random((b, c)) < 0.95,
        "spread_ok": rng.random((b, c)) < 0.85,
        "avail": rng.integers(-3, 60, (b, c)).astype(np.int32),
        "caps": np.where(rng.random((b, c)) < 0.3, rng.integers(-2, 5, (b, c)),
                         hi).astype(np.int32),
        "admitted": rng.random(b) < 0.8,
        "dynamic": rng.random(b) < 0.7,
        "replicas": rng.integers(0, 12, b).astype(np.int32),
        "assignment": np.where(rng.random((b, c)) < 0.3, rng.integers(1, 6, (b, c)),
                               0).astype(np.int32),
        "prev": rng.integers(0, 3, (b, c)).astype(np.int32),
        "preempted": rng.random((b, c)) < 0.1,
    }
    av, asg = t["avail"], t["assignment"]
    av[kind == 1], asg[kind == 1] = 7, 0
    av[kind == 2] = rng.integers(0, 3, (int((kind == 2).sum()), c))
    asg[kind == 2] = 0
    for i in np.flatnonzero(kind == 3):
        av[i] = rng.choice(np.array([hi, -1, lo, 0, 5], np.int32), c)
        asg[i] = rng.choice(np.array([hi, 0, 0, 1, lo], np.int32), c)
        t["caps"][i] = rng.choice(np.array([hi, lo, 0, 1], np.int32), c)
        t["prev"][i] = rng.choice(np.array([hi, 0, 3], np.int32), c)
    t["replicas"][kind == 3] = hi
    for i in np.flatnonzero(kind == 4):
        av[i], asg[i] = -1, 0
        few = rng.choice(c, int(rng.integers(0, min(c, 8))), replace=False)
        av[i, few] = rng.integers(0, 9, len(few))
    pad = kind == 5
    for name in ("aff_ok", "taint_ok", "api_ok", "spread_ok", "preempted"):
        t[name][pad] = False
    av[pad], asg[pad], t["caps"][pad], t["prev"][pad] = 0, 0, 0, 0
    t["replicas"][pad], t["dynamic"][pad], t["admitted"][pad] = 0, False, True
    neg = np.flatnonzero(kind == 6)
    av[neg] = rng.integers(lo, 0, (len(neg), c))
    av[neg] = np.where(rng.random((len(neg), c)) < 0.2, lo, av[neg])
    asg[neg] = 0
    return t


def misaligned(t: dict) -> dict:
    """The same tensors as views whose data starts one element past a fresh
    allocation: no base address is 16-B aligned."""
    import torch

    out = {}
    for name, v in t.items():
        flat = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        view = flat[1:].view(v.shape)
        view.copy_(v)
        out[name] = view
    return out


def check_explain_edges(device, card: str) -> None:
    """K14 against its plain version on every ``EXPLAIN_EDGE_CASES`` batch,
    and on one batch through misaligned views (every cell one a lane);
    exact."""
    from karmada_tpu_torch import ops

    t0 = time.perf_counter()
    for j, (b, c, k) in enumerate(EXPLAIN_EDGE_CASES):
        t = to_device(explain_edge_batch(np.random.default_rng(SEED + 900 + j), b, c), device)
        forms = [("", t)] + ([(", misaligned views", misaligned(t))] if j == 10 else [])
        for form, tt in forms:
            args = list(tt.values())
            compare(f"explain_pass edge case {b}x{c} k={k}{form}",
                    ops.explain_pass(*args, k=k), ops.explain_pass_ref(*args, k=k))
    print(f"# K14 edge cases: {len(EXPLAIN_EDGE_CASES)} exact (B x C x k: "
          + ", ".join(f"{b}x{c}x{k}" for b, c, k in EXPLAIN_EDGE_CASES)
          + f"; {b}x{EXPLAIN_EDGE_CASES[10][1]} also through misaligned views; "
          f"{time.perf_counter() - t0:.1f} s); card {card}", flush=True)


def preempt_batch(rng, device, b: int = 131_072, c: int = 5000, r: int = 4,
                  classes: int = 16) -> dict:
    """K15 inputs at the row bound: 16 priority classes, ~30% victims bound
    to 1-3 clusters with 1-4 replicas each, ~5% demanders (priority > 0)
    short of 1-8 replicas, per-replica requests over 4 dims. The dense
    ``assigned`` is built on the card from the seeded (row, cluster)
    entries."""
    import torch

    prio = rng.integers(0, classes, b).astype(np.int32)
    role = rng.random(b)
    victim = role < 0.30
    dem = (role >= 0.30) & (role < 0.35) & (prio > 0)
    requests = rng.integers(1, 4000, (b, r)).astype(np.int64)
    rows = np.repeat(np.flatnonzero(victim), 3)
    cols = rng.integers(0, c, rows.size)
    reps = rng.integers(0, 5, rows.size).astype(np.int32)
    keep = reps > 0
    rows, cols, reps = rows[keep], cols[keep], reps[keep]
    weight = np.bincount(rows, weights=reps, minlength=b).astype(np.int32)
    victim_ok = weight > 0
    freed = np.where(victim_ok[:, None], weight[:, None].astype(np.int64) * requests, 0)
    demand = np.where(dem[:, None], rng.integers(1, 9, b)[:, None] * requests, 0)
    out = to_device({"prio": prio, "demand": demand, "freed": freed,
                     "victim_ok": victim_ok, "weight": weight}, device)
    assigned = torch.zeros((b, c), dtype=torch.int32, device=device)
    assigned.index_put_((torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)),
                        torch.from_numpy(reps).to(device), accumulate=True)
    out["assigned"] = assigned
    out["requests"] = torch.from_numpy(requests).to(device)
    return out


def preempt_bound(t: dict, victims) -> tuple[int, int]:
    """(bytes, operations) K15 must move and do: every row's selection
    inputs read and its flag written once; the freed-capacity product is
    sparse, so only the selected rows' assignments and requests count, each
    read once; freed_caps written once; a multiply-add per selected (row,
    cluster, dim)."""
    b, c = t["assigned"].shape
    r = t["requests"].shape[1]
    sel = int(victims.sum().item())
    nbytes = (_nbytes(t["prio"], t["demand"], t["freed"], t["victim_ok"], t["weight"]) + b
              + sel * (c * 4 + r * 8) + c * r * 8)
    return nbytes, 2 * sel * c * r


def check_preempt_kernel(t: dict, card: str, label: str, b_key: int | None = None) -> dict:
    """K15 against its plain version on the card on the tensors ``t``
    (sort keys built for ``b_key`` rows); exact; timed."""
    import torch
    from karmada_tpu_torch import ops

    args = [t[k] for k in ("prio", "demand", "freed", "victim_ok", "weight", "assigned",
                           "requests")]
    kern = lambda: ops.preempt_select(*args, b_key=b_key)  # noqa: E731
    plain = lambda: ops.preempt_select_ref(*args, b_key=b_key)  # noqa: E731
    got, want = kern(), plain()
    compare(f"preempt_select {label}", got, want)
    torch.cuda.synchronize()
    sel = int(got[0].sum().item())
    print(f"# kernel preempt_select {label}: {len(args[0])} rows, {sel} victims selected",
          flush=True)
    nbytes, ops_n = preempt_bound(t, got[0])
    return timed(f"preempt_select {label}", kern, plain, nbytes, ops_n, card)


#: K15's edge batches (``preempt_edge_batch``)
PREEMPT_EDGE_CASES = ("no_victims", "no_demanders", "equal_keys", "wrapping", "b_key", "b1",
                      "b2e17", "weights", "nothing_freed", "r1", "r16", "r17", "r40")


def preempt_edge_batch(case: str) -> dict:
    """K15 inputs (numpy; ``b_key`` beside them) on which it must stay
    exact, by ``case`` (each drawn from its own seed, so the CPU tests pose
    the same batches): no eligible victim; no demand; every row of one
    priority and one weight (equal d keys; nothing is displaced);
    priorities at and past 2^20 and up to 2^31 - 1, and negative ones, at
    b_key 2^17 (the packed victim key wraps), with requests near 2^40 (the
    int64 sums wrap); b_key above B; B = 1; B = 2^17 (16 classes); weights
    below 0 and above MAX_WEIGHT; eligible rows that free nothing; R = 1,
    16, 17 and 40. Otherwise 5000 rows (two sort tiles and part of a third)
    over 7 clusters in 5 classes, a third demanders, a third victims."""
    rng = np.random.default_rng(1500 + PREEMPT_EDGE_CASES.index(case))
    b, r, c, classes, b_key = 5000, 4, 7, 5, None
    if case == "b1":
        b = 1
    elif case == "b2e17":
        b, c, classes = 1 << 17, 3, 16
    elif case[0] == "r" and case[1:].isdigit():
        r = int(case[1:])
    prio = rng.integers(0, classes, b).astype(np.int32)
    role = rng.integers(0, 3, b)
    requests = rng.integers(0, 8, (b, r)).astype(np.int64)
    if case == "wrapping":
        prio = rng.choice(np.array([0, 1, 2**20 - 1, 2**20, 2**20 + 5, 2**27, 2**29, 2**30,
                                    2**31 - 1, -1, -5], np.int32), b)
        requests = rng.integers(0, 1 << 40, (b, r)).astype(np.int64)
        b_key = 1 << 17
    elif case == "b_key":
        b_key = 8192
    elif case == "equal_keys":
        prio[:] = 3
    dem = (role == 0) & (prio > 0) if case != "wrapping" else role == 0
    demand = np.where(dem[:, None], rng.integers(0, 24, (b, r)), 0).astype(np.int64)
    if case == "wrapping":
        demand = np.where(dem[:, None], rng.integers(0, 1 << 62, (b, r)), 0).astype(np.int64)
    vic = role == 1
    assigned = np.where(vic[:, None], rng.integers(0, 4, (b, c)), 0).astype(np.int32)
    if case == "equal_keys":
        assigned = np.where(vic[:, None], 1, 0).astype(np.int32)
    weight = assigned.sum(axis=1).astype(np.int32)
    victim_ok = vic & (weight > 0)
    freed = np.where(victim_ok[:, None], weight[:, None].astype(np.int64) * requests, 0)
    if case == "no_victims":
        victim_ok[:], freed[:] = False, 0
    elif case == "no_demanders":
        demand[:] = 0
    elif case == "weights":
        weight = rng.choice(np.array([-(2**31), -7, -1, 0, 3, 2**20 - 1, 2**20, 2**20 + 9,
                                      2**31 - 1], np.int32), b)
    elif case == "nothing_freed":
        freed[rng.random(b) < 0.5] = 0
    return {"prio": prio, "demand": demand, "freed": freed, "victim_ok": victim_ok,
            "weight": weight, "assigned": assigned, "requests": requests, "b_key": b_key}


def check_preempt_edges(device, card: str) -> None:
    """K15 against its plain version on every ``preempt_edge_batch`` case;
    exact."""
    from karmada_tpu_torch import ops

    picked = 0
    for case in PREEMPT_EDGE_CASES:
        a = preempt_edge_batch(case)
        b_key = a.pop("b_key")
        t = to_device(a, device)
        args = [t[k] for k in ("prio", "demand", "freed", "victim_ok", "weight", "assigned",
                               "requests")]
        got = ops.preempt_select(*args, b_key=b_key)
        compare(f"preempt_select edge case {case}", got,
                ops.preempt_select_ref(*args, b_key=b_key))
        picked += int(got[0].sum().item())
    print(f"# K15 edge cases: {len(PREEMPT_EDGE_CASES)} exact ({', '.join(PREEMPT_EDGE_CASES)})"
          f", {picked} victims in all; card {card}", flush=True)


class held_to_plain:
    """Inside the block every call the engine makes to K14
    (``karmada_tpu_torch.ops.explain.explain_pass``, which ``_explain_chunk``
    imports at each call) launches the kernel alone and keeps its inputs
    and outputs (references: the engine uploads fresh tensors for each
    chunk and writes none of them afterwards; about 0.43 GB a 4096 x 5000
    chunk stays on the device until ``check``). ``check``, after the block
    and outside any timed wall, holds each kept call to its plain version on
    the same inputs, exactly and uncounted, and sets ``seconds`` to the time
    it took; ``chunks`` counts the calls held. The stand-in's ``launches``
    is the wrapper's own (the wrapper counts its launches through that
    module name)."""

    def __init__(self, tag: str):
        self.tag, self.kept, self.chunks, self.seconds = tag, [], 0, 0.0

    @property
    def launches(self) -> int:
        return self.kernel.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.kernel.launches = n

    def __call__(self, *args, k):
        got = self.kernel(*args, k=k)
        self.kept.append((args, k, got))
        return got

    def __enter__(self):
        from karmada_tpu_torch.ops import explain

        self.module, self.kernel = explain, explain.explain_pass
        explain.explain_pass = self
        return self

    def __exit__(self, *exc):
        self.module.explain_pass = self.kernel

    def check(self) -> None:
        t0 = time.perf_counter()
        with uncounted():
            for n, (args, k, got) in enumerate(self.kept):
                compare(f"{self.tag} chunk {n}", got, self.module.explain_pass_ref(*args, k=k))
        self.chunks, self.kept = len(self.kept), []
        self.seconds = time.perf_counter() - t0


def explain_capture(tag: str, engine, problems, device, card: str, sample: int = 64,
                    seed: int = SEED + 21) -> dict:
    """One pass of ``problems`` with a fresh ExplainStore armed, then the
    store disarmed. The launch counters are zeroed just before the pass
    and read just after (and restored afterwards, so the caller's path
    counts stay its own). Checks: one capture per chunk (on the card, one
    K14 launch per chunk); the first chunk's capture equal to K14's plain
    version on the composed inputs (``_explain_inputs``); every chunk's K14
    launch equal to K14's plain version on the same device inputs
    (``held_to_plain``: kept during the pass, compared after its wall); a
    ``sample``-row sample
    of every capture equal to the numpy referent ``explain_batch_np`` on
    those rows' composed inputs."""
    import torch
    from karmada_tpu_torch import ops
    from karmada_tpu_torch.refimpl.explain_np import explain_batch_np
    from karmada_tpu_torch.utils.explainstore import ExplainStore

    saved = read_counts()
    reset_counts()
    store = ExplainStore(cap=4)
    engine.set_explain(store)
    try:
        with held_to_plain(tag) as held:
            t0 = time.perf_counter()
            res = engine.schedule(problems)
            sync(device)
            wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        engine.set_explain(None)
        for name, fn in wrappers().items():
            fn.launches = saved[name]
    held.check()
    if held.chunks != -(-len(problems) // engine.chunk_size):
        raise AssertionError(f"{tag}: {held.chunks} chunks held to K14's plain version")
    caps = store.captures()
    chunks = -(-len(problems) // engine.chunk_size)
    if len(caps) != chunks:
        raise AssertionError(f"{tag}: {len(caps)} captures for {chunks} chunks")
    if device.type == "cuda" and launches["explain_pass"] != chunks:
        raise AssertionError(f"{tag}: {launches['explain_pass']} K14 launches for "
                             f"{chunks} chunks")
    t0 = time.perf_counter()
    first = caps[0]
    n0 = len(first.keys)
    inputs, _rank = engine._explain_inputs(problems[:n0], res[:n0])
    k = first.topk.shape[1]
    with uncounted():
        want = ops.explain_pass_ref(*to_device(inputs, device).values(), k=k)
    compare(f"{tag} first chunk", (torch.from_numpy(first.uniq_masks[first.mask_inv]).to(device),
                                   torch.from_numpy(first.topk).to(device)), want)
    rng = np.random.default_rng(seed)
    sampled = 0
    for ci, cap in enumerate(caps):
        start = ci * engine.chunk_size
        rows = np.sort(rng.choice(len(cap.keys), min(sample, len(cap.keys)), replace=False))
        inputs, rank = engine._explain_inputs([problems[start + int(i)] for i in rows],
                                              [res[start + int(i)] for i in rows])
        masks, topk = explain_batch_np(*inputs.values(), k=k)
        if not (np.array_equal(masks, cap.uniq_masks[cap.mask_inv[rows]])
                and np.array_equal(topk, cap.topk[rows])
                and np.array_equal(rank, cap.group_rank[rows])):
            raise AssertionError(f"{tag}: capture {ci} differs from explain_batch_np")
        sampled += len(rows)
    check_s = time.perf_counter() - t0
    print(f"# {tag}: armed pass {wall:.4f} s, {len(caps)} captures, K14 launches "
          f"{launches['explain_pass']}; each of the {held.chunks} chunks' K14 output equal "
          f"to its plain version ({held.seconds:.1f} s), the first chunk's capture too, "
          f"{sampled} sampled rows equal to explain_batch_np ({check_s:.1f} s); card {card}",
          flush=True)
    return {"wall": wall, "launches": launches, "captures": len(caps), "chunks": chunks,
            "results": res, "store": store, "sampled": sampled}


def run_explain_fleet(device, card: str, engine=None, problems=None, bindings=None,
                      clusters=None, chunk: int = 4096) -> dict:
    """The config-5 storm engine with provenance: one steady pass disarmed,
    one armed (``explain_capture``), the same placements. Without
    ``engine`` it builds config 5 (at ``bindings`` x ``clusters``) and
    takes a cold pass first."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler

    if engine is None:
        snap, problems = build_workload(karmada_tpu_torch, 5, bindings, clusters)
        engine = TensorScheduler(snap, chunk_size=chunk, device=device)
        engine.schedule(problems)
    t0 = time.perf_counter()
    base = engine.schedule(problems)
    sync(device)
    off_s = time.perf_counter() - t0
    base = outcomes(base)  # decoded before the next pass rewrites the table
    out = explain_capture("explain fleet", engine, problems, device, card)
    if outcomes(out["results"]) != base:
        raise AssertionError("explain fleet: the armed pass placed differently")
    summary = out["store"].wave_summary()
    print(f"# explain fleet: {len(problems)} bindings x {engine.snapshot.num_clusters} "
          f"clusters; steady pass disarmed {off_s:.4f} s, armed {out['wall']:.4f} s; "
          f"verdicts {summary['verdicts']}; card {card}", flush=True)
    out.update(off_s=off_s, summary=summary)
    return out


def preemption_scene(residents: int, clusters: int, surge: int, pkg=None,
                     extra_dims: int = 0):
    """bench.py ``run_preemption``'s scene (bench.py:2809-3190), built with
    ``pkg``'s modules (karmada_tpu_torch by default): (snapshot, residents,
    surge, per-replica request). ``clusters`` clusters of 200 cpu / 4000Gi
    / 10^6 pods in min(64, C // 8) label groups; ``residents`` priority-0
    rows of 2 replicas x (500m cpu, 512Mi), each pinned to one group;
    ``surge`` priority-100 rows of the same shape over every cluster. Keys
    are ``default/w<i>`` and ``default/hi<i>``. With ``extra_dims``, every
    cluster also carries 10,000 of each extended resource
    ``example.com/rNN`` and every request asks 1-3 of each, as
    ``wide_quota_scene`` adds them (13: 17 dims)."""
    name = pkg.__name__ if pkg is not None else "karmada_tpu_torch"
    api = importlib.import_module(f"{name}.api")
    b = importlib.import_module(f"{name}.utils.builders")
    q = importlib.import_module(f"{name}.utils.quantity")
    s = importlib.import_module(f"{name}.scheduler")

    n_groups = max(1, min(64, clusters // 8))
    ext = [f"example.com/r{k:02d}" for k in range(extra_dims)]
    fleet = [b.new_cluster(f"p{i:04d}", cpu="200", memory="4000Gi", pods=1_000_000,
                           labels={"group": f"g{i % n_groups}"}) for i in range(clusters)]
    for cl in fleet:
        for d in ext:
            cl.status.resource_summary.allocatable[d] = 10_000
    snap = s.ClusterSnapshot(fleet)
    group_pl = [b.dynamic_weight_placement(cluster_affinity=api.ClusterAffinity(
        label_selector=api.LabelSelector(match_labels={"group": f"g{k}"})))
        for k in range(n_groups)]
    req = {**q.parse_resource_list({"cpu": "500m", "memory": "512Mi"}),
           **{d: 1 + k % 3 for k, d in enumerate(ext)}}
    low = [s.BindingProblem(key=f"default/w{i}", placement=group_pl[i % n_groups],
                            replicas=2, requests=req, gvk="apps/v1/Deployment",
                            namespace="default")
           for i in range(residents)]
    hi_pl = b.dynamic_weight_placement()
    hi = [s.BindingProblem(key=f"default/hi{i}", placement=hi_pl, replicas=2, requests=req,
                           gvk="apps/v1/Deployment", namespace="default", priority=100)
          for i in range(surge)]
    return snap, low, hi, req


def saturated_clusters(clusters, placements, req, pkg=None) -> list:
    """New Cluster objects (``pkg``'s, karmada_tpu_torch's by default) of
    the same names and labels whose cpu is saturated exactly by
    ``placements`` (each {cluster: replicas} of one resident of request
    ``req``): allocatable = allocated = the residents' usage; extended
    resources keep their allocatable, unallocated."""
    name = pkg.__name__ if pkg is not None else "karmada_tpu_torch"
    new_cluster = importlib.import_module(f"{name}.utils.builders").new_cluster
    col = {cl.name: j for j, cl in enumerate(clusters)}
    used = np.zeros((len(clusters), 3), np.int64)  # cpu milli, memory bytes, pods
    for placement in placements:
        for nm, reps in placement.items():
            used[col[nm]] += (reps * req["cpu"], reps * req["memory"], reps)
    out = []
    for cl, u in zip(clusters, used):
        sat = new_cluster(cl.name, cpu=f"{u[0]}m", memory="4000Gi", pods=1_000_000,
                          labels=cl.meta.labels,
                          allocated={"cpu": f"{u[0]}m", "memory": int(u[1]),
                                     "pods": int(u[2])})
        alloc = sat.status.resource_summary.allocatable
        for d, v in cl.status.resource_summary.allocatable.items():
            alloc.setdefault(d, v)
        out.append(sat)
    return out


def preempt_referent(demanders, pool, names, dims, base_caps) -> tuple[list, dict]:
    """``preempt_and_place_np`` on ``preemption_scene``'s rows: sequential
    victim selection over ``pool`` (residents with ``prev``) and a one-row
    numpy divide per demander over the boosted capacity, request vectors
    computed here. Returns (victim keys, demander key -> placement)."""
    from karmada_tpu_torch.refimpl import DYNAMIC_WEIGHT
    from karmada_tpu_torch.refimpl.preempt_np import preempt_and_place_np

    def vec(requests):
        return np.array([max(requests.get(d, 0), 1) if d == "pods" else requests.get(d, 0)
                         for d in dims], np.int64)

    prios, dem_rows, freed_rows, ok, weights = [], [], [], [], []
    for p in demanders:
        prios.append(p.priority)
        dem_rows.append(vec(p.requests) * max(p.replicas - sum(p.prev.values()), 0))
        freed_rows.append(np.zeros(len(dims), np.int64))
        ok.append(False)
        weights.append(0)
    for v in pool:
        total = sum(v.prev.values())
        prios.append(v.priority)
        dem_rows.append(np.zeros(len(dims), np.int64))
        freed_rows.append(vec(v.requests) * total)
        ok.append(total > 0)
        weights.append(total)
    return preempt_and_place_np(
        [p.key for p in demanders + pool], prios, np.stack(dem_rows), np.stack(freed_rows),
        ok, weights, names=names, assigned={v.key: v.prev for v in pool},
        requests={p.key: vec(p.requests) for p in demanders + pool}, base_caps=base_caps,
        demanders=[p.key for p in demanders],
        # no cluster carries a taint and every one enables the workload's API
        candidates={p.key: np.ones(len(names), bool) for p in demanders},
        strategies={p.key: DYNAMIC_WEIGHT for p in demanders},
        replicas={p.key: p.replicas for p in demanders},
        prev={p.key: p.prev for p in demanders})


def run_preemption(device, card: str, residents: int = 100_000, clusters: int = 5000,
                   surge: int = 1000, extra_dims: int = 0) -> dict:
    """bench.py ``run_preemption``'s scene (bench.py:2809-3190) at the
    engine: ``clusters`` clusters of 200 cpu / 4000Gi / 10^6 pods in
    min(64, C // 8) label groups; ``residents`` priority-0 rows of 2
    replicas x (500m cpu, 512Mi), each pinned to one group, placed by a
    cold pass; then a snapshot whose cpu is saturated exactly (allocatable
    = allocated = the residents' usage); then a surge of ``surge``
    priority-100 rows of the same shape over every cluster, with the
    victim source answering the residents. The surge pass must launch K15
    once, and its victims and the demanders' placements must equal
    ``preempt_and_place_np``. K15 is held to its plain version on the
    pass's own inputs. Then the residents' wave as a steady pass, the
    plane armed and disarmed. ``extra_dims`` extended resources on every
    cluster and in every request (``preemption_scene``)."""
    from karmada_tpu_torch.scheduler import BindingProblem, ClusterSnapshot, TensorScheduler

    t0 = time.perf_counter()
    snap, low, hi, req = preemption_scene(residents, clusters, surge, extra_dims=extra_dims)
    names = snap.names
    n_groups = len({cl.meta.labels["group"] for cl in snap.clusters})
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    t1 = time.perf_counter()
    cold = engine.schedule(low)
    sync(device)
    cold_s = time.perf_counter() - t1
    if not all(r.success for r in cold):
        raise AssertionError("preemption: a resident did not place")

    sat = ClusterSnapshot(saturated_clusters(snap.clusters, [r.clusters for r in cold], req))
    if not engine.update_snapshot(sat):
        raise AssertionError("preemption: the saturated snapshot was refused")
    dims = list(sat.dims)
    base_caps = np.asarray(sat.available_cap).copy()
    if int(np.maximum(base_caps[:, dims.index("cpu")], 0).sum()) != 0:
        raise AssertionError("preemption: free cpu remains after saturation")
    pool = [BindingProblem(key=p.key, placement=p.placement, replicas=2, requests=req,
                           gvk=p.gvk, prev=dict(r.clusters)) for p, r in zip(low, cold)]
    build_s = time.perf_counter() - t0 - cold_s
    engine.set_preemption(lambda exclude: [v for v in pool if v.key not in exclude])

    reset_counts()
    t1 = time.perf_counter()
    res = engine.schedule(hi)
    sync(device)
    surge_s = time.perf_counter() - t1
    launches = read_counts()
    out = engine.last_preemption
    if out is None or not out.victims:
        raise AssertionError(f"preemption: no outcome or no victims ({out})")
    if device.type == "cuda" and launches["preempt_select"] != 1:
        raise AssertionError(f"preemption: {launches['preempt_select']} K15 launches")
    keys = set(out.placed) | set(out.still_unschedulable)
    demanders = [p for p in hi if p.key in keys]
    rows = len(demanders) + len(pool)

    # K15 against its plain version on the pass's own inputs
    with uncounted():
        inputs, padded = engine._preempt_inputs(demanders, pool)
        t = to_device(inputs, device)
        stats = (check_preempt_kernel(t, card, "on the preemption pass's inputs", b_key=padded)
                 if device.type == "cuda" else no_times())
        del t, inputs

    t1 = time.perf_counter()
    want_victims, want_placed = preempt_referent(demanders, pool, names, dims, base_caps)
    by_key = {r.key: r for r in res}
    got_victims = [v[0] for v in out.victims]
    bad_victims = len(set(want_victims) ^ set(got_victims))
    bad_placed = sum(want_placed[p.key] != (by_key[p.key].clusters if by_key[p.key].success
                                            else {}) for p in demanders)
    check_s = time.perf_counter() - t1
    print(f"# preemption surge: {len(demanders)} demanders over {len(pool)} residents "
          f"({rows} rows, sort keys for {padded}, {len(dims)} dims); pass {surge_s:.4f} s; "
          f"K15 launches "
          f"{launches['preempt_select']}; {len(got_victims)} victims, {len(out.placed)} "
          f"placed, {len(out.still_unschedulable)} still unschedulable; referent "
          f"preempt_and_place_np: victims {len(want_victims)} ({bad_victims} differ), "
          f"placements {len(demanders) - bad_placed} ok / {bad_placed} bad ({check_s:.1f} s); "
          f"card {card}", flush=True)
    if bad_victims or bad_placed:
        raise AssertionError(f"preemption: {bad_victims} victims and {bad_placed} "
                             "placements differ from preempt_and_place_np")
    if not out.placed:
        raise AssertionError("preemption: no demander placed")

    # the residents' wave: one pass to intern it, then steady passes armed
    # and disarmed (priority 0 rows: the armed pass scans for demanders)
    engine.schedule(pool)
    walls = {}
    for kind, source in (("armed", engine.preempt_source), ("disarmed", None)):
        engine.set_preemption(source)
        t1 = time.perf_counter()
        engine.schedule(pool)
        sync(device)
        walls[kind] = time.perf_counter() - t1
    print(f"# preemption phase: {residents} residents x {clusters} clusters in {n_groups} "
          f"groups; build {build_s:.1f} s, residents' cold pass {cold_s:.4f} s; residents' "
          f"steady pass armed {walls['armed']:.4f} s, disarmed {walls['disarmed']:.4f} s; "
          f"launches { {k: v for k, v in launches.items() if v} }; card {card}", flush=True)
    return {"launches": launches, "stats": stats, "surge_s": surge_s, "cold_s": cold_s,
            "walls": walls, "victims": len(got_victims), "placed": len(out.placed),
            "still": len(out.still_unschedulable), "rows": rows, "padded": padded,
            "dims": len(dims)}


# --------------------------------------------------------------------------
# the scheduler process: Store, Runtime and SchedulerController on the card
# --------------------------------------------------------------------------


def written(rb) -> tuple:
    """What the scheduler process wrote on ``rb``: (key, its placements
    sorted by cluster, the Scheduled=False message or "")."""
    sched = next((c for c in rb.status.conditions if c.type == "Scheduled"), None)
    return (rb.meta.namespaced_name,
            tuple(sorted((tc.name, tc.replicas) for tc in rb.spec.clusters)),
            sched.message if sched is not None and not sched.status else "")


def unwritten(rbs, placed: bool = False) -> int:
    """Bindings the write-back has not reached at their generation: no
    Scheduled condition (with ``placed``, no Scheduled=True) or an observed
    generation behind the spec's."""
    def done(rb) -> bool:
        sched = next((c for c in rb.status.conditions if c.type == "Scheduled"), None)
        return (sched is not None and (sched.status or not placed)
                and rb.status.scheduler_observed_generation == rb.meta.generation)
    return sum(not done(rb) for rb in rbs)


def expected_row(p, r) -> tuple:
    """``written`` as the write-back derives it from an engine result: a
    placed row its placements (every feasible cluster at 0 replicas for a
    zero-replica row); a row that failed its previous placement and the
    error."""
    if not r.success:
        return p.key, tuple(sorted(p.prev.items())), r.error
    if p.replicas > 0:
        return p.key, tuple(sorted(r.clusters.items())), ""
    return p.key, tuple((n, 0) for n in sorted(r.feasible)), ""


def expected_written(problems, results) -> list:
    """``expected_row`` of every row."""
    return [expected_row(p, r) for p, r in zip(problems, results)]


def written_digest(rows) -> np.ndarray:
    """int64[B]: a hash of each ``written`` tuple."""
    return np.fromiter((hash(w) for w in rows), np.int64, len(rows))


def written_check(engine, problems, bindings) -> int:
    """Every binding's written placement and error against the numpy
    referent on its problem (``referent_mismatches``). Returns the rows
    that differ."""
    return referent_mismatches(engine, problems, [written(rb) for rb in bindings],
                               expected_row)


class Written:
    """A binding's write-back read as a result (``.key``, ``.error``), for
    the partition checks."""

    def __init__(self, rb):
        self.key, _, self.error = written(rb)


class ReconcileFaults(logging.Handler):
    """The worker's error records (a reconcile that raised, a key dropped
    after its retries), formatted with their tracebacks."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list[str] = []

    def emit(self, record) -> None:
        self.records.append(self.format(record))


def settle_wave(tag: str, rt, ctl, device, card: str, apply_s: float = 0.0,
                max_steps: int = 100_000, engine_of=None) -> dict:
    """One ``run_until_settled`` of the plane, timed and split from its
    spans: the store apply that enqueued it (``apply_s``, measured by the
    caller), gate and problem build (the scheduler drain's start to its
    first ``scheduler.pass``), the engine passes (the ``scheduler.pass``
    spans, with the engine's ``last_breakdown``) and write-back (the last
    pass's end to the drain's end). The controller's share is everything
    but the engine passes. Raises when a reconcile raised (the worker
    logs it and requeues the key) or a key is left waiting for a retry.
    ``engine_of`` (default: the controller's in-process engine) returns the
    engine whose breakdown the line names, read after the wave."""
    from karmada_tpu_torch.utils.tracing import tracer

    faults = ReconcileFaults()
    log = logging.getLogger("karmada_tpu_torch")
    log.addHandler(faults)
    t0 = time.perf_counter()
    try:
        steps = rt.run_until_settled(max_steps=max_steps)
        sync(device)
    finally:
        log.removeHandler(faults)
    wall = time.perf_counter() - t0
    if faults.records or ctl.worker._retries:
        raise AssertionError(f"{tag}: {len(faults.records)} reconcile errors, "
                             f"{len(ctl.worker._retries)} keys awaiting a retry; first:\n"
                             + (faults.records[0] if faults.records else ""))
    spans = [s for s in tracer.dump() if s["start"] >= t0 - 1e-6]
    passes = [s for s in spans if s["name"] == "scheduler.pass"]
    drains = [s for s in spans if s["name"] == "controller.scheduler"]
    engine_s = sum(s["duration_s"] for s in passes)
    gate_s = write_s = 0.0
    if passes and drains:
        gate_s = passes[0]["start"] - drains[0]["start"]
        write_s = (drains[-1]["start"] + drains[-1]["duration_s"]
                   - passes[-1]["start"] - passes[-1]["duration_s"])
    ctl_s = apply_s + wall - engine_s
    out = {"wall": wall, "apply_s": apply_s, "gate_s": gate_s, "engine_s": engine_s,
           "write_s": write_s, "controller_s": ctl_s, "steps": steps,
           "passes": [s["attrs"].get("bindings", 0) for s in passes],
           "dirty": [s["attrs"].get("dirty_rows", 0) for s in passes]}
    if passes:
        share = ctl_s / (ctl_s + engine_s)
        print(f"# {tag}: {sum(out['passes'])} bindings in {len(passes)} engine pass(es) "
              f"{out['passes']}; apply {apply_s:.4f} s + settle {wall:.4f} s = "
              f"{apply_s + wall:.4f} s: gate and problem build {gate_s:.4f} s, engine "
              f"pass {engine_s:.4f} s [{breakdown_line(ctl._engine if engine_of is None else engine_of())}], write-back "
              f"{write_s:.4f} s; controller {ctl_s:.4f} s, {share:.3f} of the wave, "
              f"{ctl_s / engine_s:.2f}x the engine pass; card {card}", flush=True)
    else:
        print(f"# {tag}: apply {apply_s:.4f} s + settle {wall:.4f} s ({steps} reconcile "
              f"steps), no engine pass; card {card}", flush=True)
    return out


def drift_referent(engine, problems, current: dict, budget: int) -> list:
    """``rebalance_np``'s trigger set over ``problems`` (the descheduler's
    fresh candidates, in arrival order) on the engine's packed inputs: per
    row the engine's candidate clusters after the host spread selection,
    its strategy and replicas, and the numpy availability (with the quota
    caps of ``referent_caps``). ``rebalance_np`` divides one row at a time
    (about 1 ms a row at 5000 clusters), so each chunk first runs the
    divider it calls, ``assign_batch_np``, over all its rows at once with
    ``rebalance_np``'s arguments (no static weights, fresh; rows are
    independent), on a pool of threads, and keeps its top ``budget`` rows
    by (drift desc, arrival asc). ``rebalance_np`` then runs over the union
    of those rows in arrival order: the whole set's top ``budget`` are
    among them."""
    from concurrent.futures import ThreadPoolExecutor

    from karmada_tpu_torch.refimpl import assign_batch_np
    from karmada_tpu_torch.refimpl.divider import STATIC_WEIGHT
    from karmada_tpu_torch.refimpl.preempt_np import rebalance_np
    from karmada_tpu_torch.scheduler.spread import select_clusters_batch

    snap = engine.snapshot
    col = snap.index
    compiled_all = [engine._compiled(p.placement) for p in problems]

    def chunk_top(start: int) -> dict:
        chunk = problems[start : start + engine.chunk_size]
        b = len(chunk)
        compiled = compiled_all[start : start + engine.chunk_size]
        feasible, strategy, replicas, static_w, requests, prev, fresh = (
            engine._pack_chunk(chunk, compiled, 0))
        if (np.asarray(strategy[:b]) == STATIC_WEIGHT).any():
            raise ValueError("drift_referent: rebalance_np divides without static weights")
        caps = referent_caps(engine, chunk, requests)
        avail = engine._availability_np(requests, replicas,
                                        extras=() if caps is None else (caps,))
        cand = select_clusters_batch(snap, chunk, compiled, 0, feasible, avail, prev)
        cur = np.zeros((b, snap.num_clusters), np.int32)
        for i, p in enumerate(chunk):
            for nm, reps in current.get(p.key, {}).items():
                cur[i, col[nm]] = reps
        assignment, unsched = assign_batch_np(
            np.asarray(strategy[:b]), np.asarray(replicas[:b]), np.asarray(cand[:b], bool),
            np.zeros((b, snap.num_clusters), np.int32), np.asarray(avail[:b], np.int32),
            cur, np.ones(b, bool))
        drift = np.where(np.asarray(unsched, bool), 0,
                         np.abs(np.asarray(assignment, np.int64) - cur).sum(axis=1))
        order = sorted((i for i in range(b) if drift[i] > 0), key=lambda i: (-drift[i], i))
        return {chunk[i].key: (np.array(cand[i], bool), int(strategy[i]), int(replicas[i]),
                               np.array(avail[i], np.int32))
                for i in order[:budget]}

    tops: dict = {}
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for top in pool.map(chunk_top, range(0, len(problems), engine.chunk_size)):
            tops.update(top)
    keys = [p.key for p in problems if p.key in tops]
    return rebalance_np(
        keys, names=snap.names, current=current,
        candidates={k: v[0] for k, v in tops.items()},
        strategies={k: v[1] for k, v in tops.items()},
        replicas={k: v[2] for k, v in tops.items()},
        avail={k: v[3] for k, v in tops.items()}, budget=budget)[1]


def run_controller(device, card: str, bindings=None, clusters=None, scale: int = 1000,
                   quota_rows: int = 20_000, residents: int = 20_000,
                   surge: int = 1000) -> dict:
    """The scheduler process on the card: a ``Store`` and a ``Runtime``
    driving the port's ``SchedulerController`` (and a
    ``ContinuousDescheduler`` scoring through it), from ResourceBinding
    events to written placements. Every binding is built by
    ``binding_objects`` and must round-trip to its recipe problem.

    1. cold wave: config 5 (``build_workload``; 100k bindings x 5000
       clusters) applied to the store and settled; every binding's written
       placement and error equal those of the storm's cold pass run on the
       controller's cluster order (a new engine over the controller's
       snapshot, which sorts the clusters by name) and the numpy referent
       row for row;
    2. a settle with nothing to do: the write-back's echoes enqueued
       nothing, and a resync of every binding gates them all out (no
       engine pass);
    3. scale wave: ``scale`` bindings (seed 99) take new replica counts;
       one engine pass over exactly them, each equal to the numpy divider;
    4. drift round: every cluster's allocation drifts (``drift_snapshots``,
       the store's Cluster objects in place, delivered as one cluster
       event: each cluster event re-enqueues every binding, so one stands
       for the lot) and re-gates nothing; one ``ContinuousDescheduler``
       round at the default budget (64) triggers exactly
       ``drift_referent``'s set, and the settle after it reschedules
       exactly those bindings, each to the numpy divider's fresh ideal;
    5. quota wave: the quota cell's recipe (``quota_workload``, cut to
       ``quota_rows`` rows at the full cluster count) under one FRQ a
       namespace whose status is not reconciled (so the snapshot reads the
       usage from the store's bindings) and whose cpu limit is that usage
       plus half the namespace's wave demand; the partition equals
       ``admit_wave_np`` and the admitted rows the numpy divider; then one
       namespace is raised and exactly its denied bindings are re-enqueued
       and admitted;
    6. preemption wave: ``preemption_scene`` (``residents`` residents at
       the full cluster count): the residents' cold wave, the clusters'
       cpu saturated by it (one cluster event), then ``surge``
       priority-100 bindings; their wave's victims, eviction tasks and
       placements equal ``preempt_and_place_np``'s.

    Each wave prints its wall and split (``settle_wave``). Returns the
    launch counts of the cold, quota and preemption waves and the waves'
    numbers."""
    import karmada_tpu_torch
    from karmada_tpu_torch.controllers import ContinuousDescheduler, SchedulerController
    from karmada_tpu_torch.controllers.rebalance import disruption_budget
    from karmada_tpu_torch.scheduler import (
        BindingProblem,
        TensorScheduler,
        build_quota_snapshot,
    )
    from karmada_tpu_torch.scheduler.quota import QUOTA_EXCEEDED_ERROR, UNLIMITED
    from karmada_tpu_torch.utils import Runtime, Store

    pkg = karmada_tpu_torch
    on_card = device.type == "cuda"
    out = {"waves": {}}

    def plane():
        store, rt = Store(), Runtime()
        ctl = SchedulerController(store, rt, device=device)
        # a reconcile that raises is not retried here: its wave fails
        # (``settle_wave``) after one engine pass, not after the
        # worker's bisection and 16 retries of a 100k-row batch
        ctl.worker.MAX_RETRIES = ctl.worker.POISON_TOLERANCE = 0
        return store, rt, ctl

    def apply(store, objs) -> float:
        t0 = time.perf_counter()
        errors = store.apply_many(objs)
        if errors:
            raise AssertionError(f"controller: the store refused {len(errors)} objects")
        return time.perf_counter() - t0

    def round_trip(tag, ctl, problems) -> None:
        bad = sum(ctl._problem_cache.get(p.key) != p for p in problems)
        if bad:
            raise AssertionError(f"{tag}: {bad} bindings' problems differ from the recipe's")

    # -- 1. cold wave ------------------------------------------------------
    t0 = time.perf_counter()
    snap, problems = build_workload(pkg, 5, bindings, clusters)
    cluster_objs, rbs, _ = binding_objects(pkg, snap, problems)
    n = len(problems)
    build_s = time.perf_counter() - t0
    store, rt, ctl = plane()
    desched = ContinuousDescheduler(store, rt, ctl)
    desched.active = False  # rounds run by hand below
    apply(store, cluster_objs)
    reset_counts()
    cold = settle_wave("controller cold wave", rt, ctl, device, card,
                       apply(store, rbs))
    out["cold_launches"] = read_counts()
    out["waves"]["cold"] = cold
    engine = ctl._engine
    if cold["passes"] != [n] or engine._fleet is None:
        raise AssertionError(f"controller cold wave: passes {cold['passes']}, fleet "
                             f"{engine._fleet is not None}")
    round_trip("controller cold wave", ctl, problems)
    got = [written(rb) for rb in rbs]
    t0 = time.perf_counter()
    with uncounted():
        ref = TensorScheduler(ctl._snapshot, chunk_size=4096, device=device).schedule(problems)
    sync(device)
    ref_s = time.perf_counter() - t0
    bad_ref = int((written_digest(got) != written_digest(expected_written(problems, ref))).sum())
    failed = sum(1 for w in got if w[2])
    missed = unwritten(rbs)
    t0 = time.perf_counter()
    bad = written_check(engine, problems, rbs)
    check_s = time.perf_counter() - t0
    print(f"# controller cold wave: {n} bindings x {snap.num_clusters} clusters (build "
          f"{build_s:.1f} s); {n - failed} placed, {missed} not written; written digest against the storm's cold "
          f"pass on the controller's cluster order ({ref_s:.2f} s): {n - bad_ref} ok / "
          f"{bad_ref} bad; numpy-divider check {n - bad} ok / {bad} bad ({check_s:.1f} s); "
          f"launches { {k: v for k, v in out['cold_launches'].items() if v} }", flush=True)
    if bad_ref or bad or missed:
        raise AssertionError(f"controller cold wave: {bad_ref} rows differ from the storm's "
                             f"cold pass, {bad} from the numpy divider, {missed} not written")
    del ref

    # -- 2. a settle with nothing to do -------------------------------------
    before = engine.solve_batches
    echoes = rt.pending()
    idle = settle_wave("controller idle settle", rt, ctl, device, card)
    t0 = time.perf_counter()
    for rb in rbs:
        ctl.worker.enqueue(("ResourceBinding", rb.meta.namespaced_name))
    resync = settle_wave("controller resync (every binding re-gated)", rt, ctl, device,
                         card, time.perf_counter() - t0)
    if echoes or idle["steps"] or idle["passes"] or resync["passes"] or failed \
            or engine.solve_batches != before:
        raise AssertionError(f"controller idle settle: {echoes} echoes queued, passes "
                             f"{idle['passes']} / {resync['passes']}, {failed} unplaced rows")
    out["waves"]["resync"] = resync

    # -- 3. scale wave -------------------------------------------------------
    rng = np.random.default_rng(99)
    idx = sorted(map(int, rng.choice(n, min(scale, n), replace=False)))
    reps = rng.integers(1, 100, len(idx))
    scaled, want = [], []
    for i, r in zip(idx, reps):
        rb, p = rbs[i], problems[i]
        r = int(r) if int(r) != rb.spec.replicas else int(r) + 1
        rb.spec.replicas = r
        rb.meta.generation += 1
        scaled.append(rb)
        want.append(BindingProblem(
            key=p.key, placement=p.placement, replicas=r, requests=p.requests, gvk=p.gvk,
            prev={tc.name: tc.replicas for tc in rb.spec.clusters}))
    wave = settle_wave("controller scale wave", rt, ctl, device, card, apply(store, scaled))
    out["waves"]["scale"] = wave
    round_trip("controller scale wave", ctl, want)
    bad = written_check(engine, want, scaled) + unwritten(scaled)
    print(f"# controller scale wave: {len(scaled)} bindings (seed 99); dirty rows "
          f"{wave['dirty']}; written and held to the numpy divider {len(scaled) - bad} ok / "
          f"{bad} bad", flush=True)
    if wave["passes"] != [len(scaled)] or bad:
        raise AssertionError(f"controller scale wave: passes {wave['passes']}, {bad} rows "
                             "unwritten or differ from the numpy divider")

    # -- 4. drift round ------------------------------------------------------
    drift_snapshots(pkg, ctl._snapshot, 1)
    t0 = time.perf_counter()
    store.apply(ctl._snapshot.clusters[0])
    regate = settle_wave("controller drift re-gate", rt, ctl, device, card,
                         time.perf_counter() - t0)
    if regate["passes"]:
        raise AssertionError(f"controller drift re-gate scheduled {regate['passes']}")
    cands = desched._candidates()
    current = {rb.meta.namespaced_name: {tc.name: tc.replicas for tc in rb.spec.clusters}
               for _, rb, _ in cands}
    # the round's split: its candidates' problem build and its dry solve
    # (instance wrappers; the rest is scoring and stamping)
    split = {}

    def timed(name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                split[name] = time.perf_counter() - t
        return call

    desched._candidates = timed("candidates", desched._candidates)
    ctl.dry_solve = timed("dry solve", ctl.dry_solve)
    t0 = time.perf_counter()
    stats = desched.rebalance_once()
    round_s = time.perf_counter() - t0
    dry_bd = breakdown_line(ctl._engine)
    del desched._candidates, ctl.dry_solve
    budget = disruption_budget()
    t0 = time.perf_counter()
    want_keys = drift_referent(ctl._engine, [p for _, _, p in cands], current, budget)
    ref_s = time.perf_counter() - t0
    trig = stats["triggered"]
    replace = settle_wave("controller drift settle", rt, ctl, device, card)
    fresh = [ctl._problem_cache[k] for k in trig]
    moved = [store.get("ResourceBinding", k) for k in trig]
    bad = written_check(ctl._engine, fresh, moved) + unwritten(moved, placed=True)
    stale = sum(rb.status.last_scheduled_time < rb.spec.reschedule_triggered_at
                for rb in moved)
    print(f"# controller drift round: {stats['scored']} scored, {stats['drifted']} drifted, "
          f"{len(trig)} of budget {budget} triggered in {round_s:.4f} s (candidates "
          f"{split['candidates']:.4f} s, dry solve {split['dry solve']:.4f} s "
          f"[{dry_bd}], scoring and stamps "
          f"{round_s - split['candidates'] - split['dry solve']:.4f} s); rebalance_np's set {'equal' if trig == want_keys else 'DIFFERENT'} "
          f"({ref_s:.1f} s); settle rescheduled {replace['passes']}; {len(trig) - bad} "
          f"re-placed at the numpy divider's fresh ideal / {bad} bad; card {card}",
          flush=True)
    if trig != want_keys or replace["passes"] != [len(trig)] or bad or stale \
            or len(trig) != min(budget, stats["drifted"]) or not trig:
        raise AssertionError(f"controller drift round: triggered {len(trig)}, referent "
                             f"{len(want_keys)}, passes {replace['passes']}, {bad} bad, "
                             f"{stale} unconsumed")
    out["waves"]["drift"] = dict(replace, round_s=round_s, triggered=len(trig),
                                 drifted=stats["drifted"], **split)
    del store, rt, ctl, desched, rbs, cands, engine

    # -- 5. quota wave -------------------------------------------------------
    snap, qprobs = quota_workload(pkg, quota_rows, clusters)
    for p in qprobs:
        p.key = f"{p.namespace}/{p.key}"
    ns_index = {ns: k for k, ns in enumerate(QUOTA_NAMESPACES)}
    ns_ids, demand = wave_demand(snap, qprobs, ns_index)
    cpu_dim = list(snap.dims).index("cpu")
    used = {ns: 0 for ns in QUOTA_NAMESPACES}
    wave_cpu = {ns: 0 for ns in QUOTA_NAMESPACES}
    for i, p in enumerate(qprobs):
        used[p.namespace] += sum(p.prev.values()) * int(p.requests.get("cpu", 0))
        wave_cpu[p.namespace] += int(demand[i, cpu_dim])
    limits = {ns: {"cpu": used[ns] + wave_cpu[ns] // 2} for ns in QUOTA_NAMESPACES}
    cluster_objs, qrbs, frqs = binding_objects(pkg, snap, qprobs, limits)
    store, rt, ctl = plane()
    apply(store, cluster_objs)
    apply(store, frqs)

    def quota_rem0():
        """The remaining quota a wave starts from: the FRQs packed against
        the controller's cluster order, the usage read from the store."""
        from karmada_tpu_torch.scheduler import ClusterSnapshot

        snap_c = ClusterSnapshot(ctl._sorted_clusters())
        q = build_quota_snapshot(store.list("FederatedResourceQuota"), snap_c, 0, store=store)
        return snap_c, q, q.remaining.copy()

    t0 = time.perf_counter()
    store.apply_many(qrbs)
    apply_s = time.perf_counter() - t0
    snap_c, q0, rem0 = quota_rem0()
    want_rem = np.array([[limits[ns]["cpu"] - used[ns] if j == cpu_dim else UNLIMITED
                          for j in range(len(snap_c.dims))] for ns in sorted(limits)])
    if not np.array_equal(rem0, np.maximum(want_rem, 0)):
        raise AssertionError("controller quota wave: the store's usage was not read")
    reset_counts()
    wave = settle_wave("controller quota wave", rt, ctl, device, card, apply_s)
    out["quota_launches"] = read_counts()
    out["waves"]["quota"] = wave
    if on_card and out["quota_launches"]["quota_admit"] != 1:
        raise AssertionError(f"controller quota wave: {out['quota_launches']['quota_admit']} "
                             "K12 launches")
    round_trip("controller quota wave", ctl, qprobs)
    res = [Written(rb) for rb in qrbs]
    adm, den, _ = check_partition("controller quota wave", snap_c, qprobs, res, q0, rem0)
    ok_rows = [i for i, r in enumerate(res) if r.error != QUOTA_EXCEEDED_ERROR]
    bad = written_check(ctl._engine, [qprobs[i] for i in ok_rows], [qrbs[i] for i in ok_rows])
    bad += unwritten(qrbs)
    print(f"# controller quota wave: {len(qprobs)} bindings x {snap.num_clusters} clusters "
          f"in {len(QUOTA_NAMESPACES)} namespaces ({CAP_NAMESPACES} capped; rows cut from "
          f"100000 to {len(qprobs)}); {adm} quota'd rows admitted, {den} denied, equal to "
          f"admit_wave_np; admitted rows against the numpy divider (and every row written) "
          f"{len(ok_rows) - bad} ok / {bad} bad; K12 launches {out['quota_launches']['quota_admit']}", flush=True)
    if not (adm and den) or bad:
        raise AssertionError(f"controller quota wave: admitted {adm}, denied {den}, {bad} bad")
    raised = "nsq02"
    denied = {("ResourceBinding", qprobs[i].key) for i, r in enumerate(res)
              if r.error == QUOTA_EXCEEDED_ERROR and qprobs[i].namespace == raised}
    frq = store.get("FederatedResourceQuota", f"{raised}/quota")
    frq.spec.overall = {"cpu": 1 << 40}
    t0 = time.perf_counter()
    store.apply(frq)
    apply_s = time.perf_counter() - t0
    queued = set(ctl.worker._queued)
    if not denied or queued != denied:
        raise AssertionError(f"controller quota raise: {len(queued)} bindings re-enqueued, "
                             f"{len(denied)} denied in {raised}")
    rows = [i for i, p in enumerate(qprobs) if ("ResourceBinding", p.key) in denied]
    snap_c, q0, rem0 = quota_rem0()
    wave = settle_wave(f"controller quota raise of {raised}", rt, ctl, device, card, apply_s)
    out["waves"]["quota raise"] = wave
    sub_p, sub_b = [qprobs[i] for i in rows], [qrbs[i] for i in rows]
    adm, den, _ = check_partition("controller quota raise", snap_c, sub_p,
                                  [Written(rb) for rb in sub_b], q0, rem0)
    bad = written_check(ctl._engine, sub_p, sub_b) + unwritten(sub_b, placed=True)
    print(f"# controller quota raise of {raised}: exactly its {len(denied)} denied bindings "
          f"re-enqueued; {adm} admitted, {den} denied, equal to admit_wave_np; numpy-divider "
          f"check {len(rows) - bad} ok / {bad} bad", flush=True)
    if den or bad or wave["passes"] != [len(rows)]:
        raise AssertionError(f"controller quota raise: {den} denied, {bad} bad, passes "
                             f"{wave['passes']}")
    del store, rt, ctl, qrbs, qprobs

    # -- 6. preemption wave --------------------------------------------------
    snap, low, hi, req = preemption_scene(residents, clusters or 5000, surge)
    cluster_objs, low_rbs, _ = binding_objects(pkg, snap, low)
    _, hi_rbs, _ = binding_objects(pkg, snap, hi)
    store, rt, ctl = plane()
    apply(store, cluster_objs)
    wave = settle_wave("controller preemption residents' wave", rt, ctl, device, card,
                       apply(store, low_rbs))
    out["waves"]["residents"] = wave
    placements = [dict(written(rb)[1]) for rb in low_rbs]
    missed = unwritten(low_rbs, placed=True)
    if missed:
        raise AssertionError(f"controller preemption: {missed} residents lack Scheduled=True")
    for cl, sat in zip(snap.clusters, saturated_clusters(snap.clusters, placements, req)):
        cl.status = sat.status
    t0 = time.perf_counter()
    store.apply(snap.clusters[0])
    regate = settle_wave("controller preemption saturation re-gate", rt, ctl, device, card,
                         time.perf_counter() - t0)
    if regate["passes"]:
        raise AssertionError(f"controller preemption re-gate scheduled {regate['passes']}")
    reset_counts()
    wave = settle_wave("controller preemption surge wave", rt, ctl, device, card,
                       apply(store, hi_rbs), max_steps=1)
    out["preempt_launches"] = read_counts()
    out["waves"]["surge"] = wave
    outcome = ctl._engine.last_preemption
    if outcome is None or not outcome.victims or wave["passes"] != [len(hi)]:
        raise AssertionError(f"controller preemption: passes {wave['passes']}, outcome "
                             f"{outcome}")
    if on_card and out["preempt_launches"]["preempt_select"] != 1:
        raise AssertionError(f"controller preemption: "
                             f"{out['preempt_launches']['preempt_select']} K15 launches")
    sat_snap = ctl._engine.snapshot
    dims = list(sat_snap.dims)
    base_caps = np.asarray(sat_snap.available_cap)
    if int(np.maximum(base_caps[:, dims.index("cpu")], 0).sum()) != 0:
        raise AssertionError("controller preemption: free cpu remains after saturation")
    pool = [BindingProblem(key=p.key, placement=p.placement, replicas=p.replicas,
                           requests=p.requests, gvk=p.gvk, prev=pl, namespace=p.namespace)
            for p, pl in zip(low, placements)]
    keys = set(outcome.placed) | set(outcome.still_unschedulable)
    demanders = [p for p in hi if p.key in keys]
    t0 = time.perf_counter()
    want_victims, want_placed = preempt_referent(demanders, pool, sat_snap.names, dims,
                                                 base_caps)
    check_s = time.perf_counter() - t0
    got_victims = {v[0] for v in outcome.victims}
    prev_of = {p.key: p.prev for p in pool}
    bad_tasks = 0
    for key in got_victims:
        rb = store.get("ResourceBinding", key)
        tasks = {t.from_cluster: t.replicas for t in rb.spec.graceful_eviction_tasks
                 if t.reason == "PreemptedByHigherPriority"}
        cond = next((c for c in rb.status.conditions if c.type == "Preempted"), None)
        bad_tasks += (tasks != prev_of[key] or rb.spec.clusters != [] or cond is None
                      or not cond.status)
    by_key = {rb.meta.namespaced_name: rb for rb in hi_rbs}
    bad_placed = sum(dict(written(by_key[p.key])[1]) != want_placed[p.key]
                     for p in demanders) + unwritten(hi_rbs)
    bad_victims = len(got_victims ^ set(want_victims))
    rest = settle_wave("controller preemption victims' wave", rt, ctl, device, card)
    out["waves"]["victims"] = rest
    # the victims' own wave: each rescheduled once with its evicted
    # clusters excluded, written, and held to the numpy divider
    vkeys = sorted(got_victims)
    vprobs = [ctl._problem_cache[k] for k in vkeys]
    vrbs = [store.get("ResourceBinding", k) for k in vkeys]
    bad_rest = sum(bool(p.prev) or set(p.evict_clusters) != set(prev_of[p.key])
                   or set(p.preempt_clusters) != set(prev_of[p.key]) for p in vprobs)
    t0 = time.perf_counter()
    bad_rest += written_check(ctl._engine, vprobs, vrbs) + unwritten(vrbs)
    rest_s = time.perf_counter() - t0
    print(f"# controller preemption: {residents} residents x {snap.num_clusters} clusters "
          f"(rows cut from 100000), {len(hi)} priority-100 bindings: {len(got_victims)} "
          f"victims ({bad_victims} differ from preempt_and_place_np; {bad_tasks} with wrong "
          f"eviction tasks or conditions), {len(outcome.placed)} placed, "
          f"{len(outcome.still_unschedulable)} still unschedulable; demanders' placements "
          f"{len(demanders) - bad_placed} ok / {bad_placed} bad ({check_s:.1f} s); the "
          f"victims' own wave {rest['passes']}, held to the numpy divider with their "
          f"clusters excluded {len(vkeys) - bad_rest} ok / {bad_rest} bad ({rest_s:.1f} s); "
          f"K15 launches "
          f"{out['preempt_launches']['preempt_select']}; card {card}", flush=True)
    if bad_victims or bad_tasks or bad_placed or bad_rest or not outcome.placed \
            or rest["passes"] != [len(vkeys)]:
        raise AssertionError(f"controller preemption: {bad_victims} victims, {bad_tasks} "
                             f"tasks, {bad_placed} placements and {bad_rest} victims' "
                             f"reschedules differ; victims' passes {rest['passes']}")
    return out


# --------------------------------------------------------------------------
# the solver sidecar's in-process seams
# --------------------------------------------------------------------------


class InProcessSolver:
    """A solver client that calls a ``SolverService``'s protobuf-free core in
    this process: what ``RemoteSolver`` does over gRPC, less protobuf's own
    bytes. Problems travel as the wire carries them (placements as
    canonical JSON, interned by content; rows as ``ProblemRecord``s) and
    results come back as ``ResultRecord``s, decoded to
    ``RemoteScheduleResult``s; a ``StaleSnapshotError`` re-syncs from
    ``_cluster_source`` once and retries through ``call_with_resync``, the
    policy ``RemoteSolver`` applies to FAILED_PRECONDITION. With ``down``
    set every call raises ``ConnectionError`` (a dead sidecar). ``split``
    holds the last request's wall in seconds: the client's encode, the
    sidecar's decode, engine pass and encode (the results' lazy decode
    included), the client's decode."""

    def __init__(self, service):
        self.service = service
        self._version = 0
        self._cluster_source = None
        self.down = False
        self.syncs = 0
        self.requests = 0
        self.split: dict = {}

    def sync_clusters(self, clusters) -> int:
        if self.down:
            raise ConnectionError("solver sidecar unreachable")
        self._version += 1
        self.syncs += 1
        return self.service.sync_clusters(list(clusters), self._version)

    def schedule(self, problems) -> list:
        from karmada_tpu_torch.solver import RemoteScheduleResult, StaleSnapshotError
        from karmada_tpu_torch.solver.client import call_with_resync
        from karmada_tpu_torch.solver.service import encode_records, result_records

        if self.down:
            raise ConnectionError("solver sidecar unreachable")
        self.requests += 1
        t0 = time.perf_counter()
        jsons, records = encode_records(problems)
        t1 = time.perf_counter()
        results = call_with_resync(
            self, lambda _: self.service.solve(self._version, jsons, records),
            lambda exc: isinstance(exc, StaleSnapshotError), self.sync_clusters)
        t2 = time.perf_counter()
        recs = result_records(results)
        t3 = time.perf_counter()
        out = [RemoteScheduleResult(key=r.key, clusters=dict(r.clusters), feasible=r.feasible,
                                    affinity_name=r.affinity_name, error=r.error)
               for r in recs]
        split = self.service.last_split
        self.split = {"client encode": t1 - t0, "decode": split["decode"],
                      "engine": split["engine"], "encode": t3 - t2,
                      "client decode": time.perf_counter() - t3}
        return out


def split_line(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f} s" for k, v in split.items())


def run_sidecar(device, card: str, reference: dict, bindings=None, clusters=None) -> dict:
    """Config 5 through the solver sidecar's in-process seam: a port
    ``SolverService`` on ``device`` driven by ``InProcessSolver``. Steps:
    ``sync_clusters`` at version 1, a cold request, the same request again
    (new problem objects, so the engine's batch-identity replay misses and
    the fleet's diff route runs, as on the wire), a request at version 0
    (must raise ``StaleSnapshotError``), a re-sync at version 2 and the same
    request, then bench.py's drift (seed 99, the storm's drift count) synced
    at version 3 and the same request. ``reference`` is the config-5 fleet
    phase's digests (``run_fleet_storm``): every row (key, placements,
    error, affinity, feasible set) equals that phase's numpy-checked cold
    pass, and the drift request its numpy-checked last pass; no row is
    solved by the divider again. Each request prints its wall split and the
    engine's ``last_breakdown``."""
    import karmada_tpu_torch
    from karmada_tpu_torch.solver import SolverService, StaleSnapshotError
    from karmada_tpu_torch.solver.service import encode_records

    t0 = time.perf_counter()
    snap, problems = build_workload(karmada_tpu_torch, 5, bindings, clusters)
    fleet = list(snap.clusters)
    n = len(problems)
    build_s = time.perf_counter() - t0
    service = SolverService(device=device)
    client = InProcessSolver(service)
    out = {"walls": {}, "splits": {}}
    reset_counts()
    t0 = time.perf_counter()
    client.sync_clusters(fleet)
    sync_s = time.perf_counter() - t0

    def request(tag: str, want, which: str) -> None:
        t = time.perf_counter()
        res = client.schedule(problems)
        sync(device)
        wall = time.perf_counter() - t
        bad = int((outcome_digest(res) != want).sum())
        out["walls"][tag] = wall
        out["splits"][tag] = dict(client.split)
        print(f"# sidecar {tag} request (version {service.snapshot_version}): {wall:.4f} s "
              f"= {split_line(client.split)} [{breakdown_line(service._engine)}]; equal to "
              f"the config-5 fleet phase's numpy-checked {which} pass: {n - bad} ok / "
              f"{bad} bad; card {card}", flush=True)
        if bad:
            raise AssertionError(f"sidecar {tag} request: {bad} rows differ from the "
                                 f"config-5 fleet phase's {which} pass")

    request("cold", reference["cold"], "cold")
    request("repeat", reference["cold"], "cold")
    jsons, records = encode_records(problems)
    try:
        service.solve(0, jsons, records)
    except StaleSnapshotError as exc:
        stale = str(exc)
    else:
        raise AssertionError("sidecar: a request at version 0 was answered")
    client.sync_clusters(fleet)
    request("re-synced", reference["cold"], "cold")
    t0 = time.perf_counter()
    drift_snapshots(karmada_tpu_torch, snap, reference["drift"])
    client.sync_clusters(fleet)
    drift_sync_s = time.perf_counter() - t0
    request("drift", reference["churn"][reference["checked"]], "last churn")
    launches = read_counts()
    print(f"# sidecar: {n} bindings x {len(fleet)} clusters (build {build_s:.1f} s); sync "
          f"{sync_s:.4f} s, drift and re-sync {drift_sync_s:.4f} s; the version-0 request "
          f"raised StaleSnapshotError ({stale}); launches "
          f"{ {k: v for k, v in launches.items() if v} }; card {card}", flush=True)
    out["launches"] = launches
    return out


def run_sidecar_estimator(device, card: str, est: dict, servers: int = 4) -> dict:
    """The estimator-aware sidecar over the estimator phase's own state
    (``run_estimator``'s node caches, snapshot and problems: 128 clusters x
    4000 nodes, 10k bindings): the clusters' ``EstimatorService``s hosted on
    ``servers`` ``MultiClusterEstimatorService``s of 32, each behind one
    in-process ``EstimatorConnection``; ``solver.__main__.
    estimator_service`` registers a ``RemoteAccurateEstimator`` a cluster
    and revalidates the registry (``invalidate()``) before each solve.
    The estimator phase's pod events are undone first, so the passes see
    its state: cold, the same request (one ping a server, no re-fetch), and
    the pod events again then the same request. Checks: the registry's RPC
    counts (a batch RPC a server cold, none quiet, one for each server
    hosting a moved cluster; a ping a server on the later passes), K8
    launches (a cluster cold, none quiet, one a moved cluster), every
    cluster answered and memoized, and every row equal to the estimator
    phase's numpy-checked cold and pod-event passes."""
    from karmada_tpu_torch.estimator import AccurateEstimator
    from karmada_tpu_torch.estimator.service import (
        EstimatorConnection,
        EstimatorService,
        MultiClusterEstimatorService,
    )
    from karmada_tpu_torch.solver.__main__ import estimator_service

    snap, caches, problems, events = (est[k] for k in ("snap", "caches", "problems",
                                                       "pod_events"))
    for name, node, req in reversed(events):
        caches[name].remove_pod(node, req)
    names = snap.names
    per = -(-len(names) // servers)
    conns = {}
    for k in range(servers):
        hosted = names[k * per:(k + 1) * per]
        conn = EstimatorConnection("multi", MultiClusterEstimatorService({
            n: EstimatorService(AccurateEstimator(n, caches[n], device=device))
            for n in hosted}))
        conns.update(dict.fromkeys(hosted, conn))
    service, registry = estimator_service(conns, device=device)
    client = InProcessSolver(service)
    client.sync_clusters(list(snap.clusters))
    moved = sorted({name for name, _, _ in events})
    hit = len({id(conns[name]) for name in moved})
    want_rpcs = {"cold": {"batch": servers, "unary": 0, "ping": 0},
                 "quiet": {"batch": 0, "unary": 0, "ping": servers},
                 "pod events": {"batch": hit, "unary": 0, "ping": servers}}
    want_k8 = {"cold": len(names), "quiet": 0, "pod events": len(moved)}
    on_card = device.type == "cuda"
    out = {"walls": {}, "splits": {}, "k8": {}, "rpcs": {},
           "launches": dict.fromkeys(KERNELS, 0)}
    for kind in ("cold", "quiet", "pod events"):
        if kind == "pod events":
            for name, node, req in events:
                caches[name].add_pod(node, req)
        before = dict(registry.rpc_counts)
        reset_counts()
        t0 = time.perf_counter()
        res = client.schedule(problems)
        sync(device)
        out["walls"][kind] = time.perf_counter() - t0
        out["splits"][kind] = dict(client.split)
        counts = read_counts()
        for k, v in counts.items():
            out["launches"][k] += v
        out["k8"][kind] = counts["node_sum_estimate"]
        rpcs = {k: registry.rpc_counts[k] - before[k] for k in before}
        out["rpcs"][kind] = rpcs
        unanswered = service._engine.extra_estimators[0].unanswered
        memoized = {name for name, _ in registry._memo}
        want = est["digests"]["cold" if kind == "quiet" else kind]
        bad = int((outcome_digest(res) != want).sum())
        print(f"# sidecar estimator {kind} pass {out['walls'][kind]:.4f} s = "
              f"{split_line(client.split)}; RPCs {rpcs}; K8 launches {out['k8'][kind]}; "
              f"unanswered {len(unanswered)}, memoized {len(memoized)} of {len(names)}; "
              f"equal to the estimator phase's numpy-checked "
              f"{'cold' if kind == 'quiet' else kind} pass: {len(problems) - bad} ok / "
              f"{bad} bad; card {card}", flush=True)
        if unanswered or memoized != set(names):
            raise AssertionError(f"sidecar estimator {kind} pass: unanswered "
                                 f"{sorted(unanswered)[:5]}, memoized {len(memoized)}")
        if rpcs != want_rpcs[kind]:
            raise AssertionError(f"sidecar estimator {kind} pass: RPCs {rpcs}, expected "
                                 f"{want_rpcs[kind]}")
        if on_card and out["k8"][kind] != want_k8[kind]:
            raise AssertionError(f"sidecar estimator {kind} pass: {out['k8'][kind]} K8 "
                                 f"launches, expected {want_k8[kind]}")
        if bad:
            raise AssertionError(f"sidecar estimator {kind} pass: {bad} rows differ")
    print(f"# sidecar estimator: {len(names)} clusters on {servers} servers, "
          f"{len(problems)} bindings; K8 launches by pass {out['k8']}; launches "
          f"{ {k: v for k, v in out['launches'].items() if v} }; card {card}", flush=True)
    return out


def run_sidecar_controller(device, card: str, bindings=None, clusters=None,
                           scale: int = 1000) -> dict:
    """``SchedulerController(solver=...)`` over config 4 (10k bindings x 500
    clusters), its client an ``InProcessSolver`` on a port
    ``SolverService``: a cold wave through the sidecar; a scale wave of
    ``scale`` bindings while the client raises ``ConnectionError`` (the
    controller serves it on its in-process engine on ``device``, counts
    one ``degraded_passes{channel="solver"}`` and drops its sync mark); a
    second scale wave with the sidecar back, which re-syncs before it is
    answered; a cluster event (one cluster's status refreshed) with a third
    scale wave, which re-syncs through the controller's cluster-event
    handler and moves no unscaled row. Every wave's scaled placements pass
    ``written_check`` (the numpy divider) on the engine that solved it."""
    import karmada_tpu_torch
    from karmada_tpu_torch.controllers import SchedulerController
    from karmada_tpu_torch.scheduler import BindingProblem
    from karmada_tpu_torch.solver import SolverService
    from karmada_tpu_torch.utils import Runtime, Store
    from karmada_tpu_torch.utils.metrics import degraded_passes

    snap, problems = build_workload(karmada_tpu_torch, 4, bindings, clusters)
    cluster_objs, rbs, _ = binding_objects(karmada_tpu_torch, snap, problems)
    n = len(problems)
    service = SolverService(device=device)
    client = InProcessSolver(service)
    store, rt = Store(), Runtime()
    ctl = SchedulerController(store, rt, solver=client, device=device)
    ctl.worker.MAX_RETRIES = ctl.worker.POISON_TOLERANCE = 0
    store.apply_many(cluster_objs)
    out = {"waves": {}, "launches": {}}
    rng = np.random.default_rng(5)

    def apply(objs) -> float:
        t0 = time.perf_counter()
        if store.apply_many(objs):
            raise AssertionError("sidecar controller: the store refused objects")
        return time.perf_counter() - t0

    def scaled_wave():
        idx = sorted(map(int, rng.choice(n, min(scale, n), replace=False)))
        objs, want = [], []
        for i in idx:
            rb, p = rbs[i], problems[i]
            rb.spec.replicas = rb.spec.replicas % 40 + 1
            rb.meta.generation += 1
            objs.append(rb)
            want.append(BindingProblem(
                key=p.key, placement=p.placement, replicas=rb.spec.replicas,
                requests=p.requests, gvk=p.gvk,
                prev={tc.name: tc.replicas for tc in rb.spec.clusters}))
        return objs, want

    def wave(tag, objs, want, engine_of, rows=None):
        reset_counts()
        w = settle_wave(f"sidecar controller {tag}", rt, ctl, device, card, apply(objs),
                        engine_of=engine_of)
        out["launches"][tag] = read_counts()
        bad = written_check(engine_of(), want, objs) + unwritten(objs)
        print(f"# sidecar controller {tag}: {len(objs)} bindings, engine passes "
              f"{w['passes']}; written and held to the numpy divider {len(objs) - bad} ok / "
              f"{bad} bad; client syncs {client.syncs}, requests {client.requests}; "
              f"launches { {k: v for k, v in out['launches'][tag].items() if v} }; "
              f"card {card}", flush=True)
        if w["passes"] != [len(objs) if rows is None else rows] or bad:
            raise AssertionError(f"sidecar controller {tag}: passes {w['passes']}, {bad} "
                                 f"rows unwritten or differ from the numpy divider")
        out["waves"][tag] = w

    wave("cold wave", rbs, problems, lambda: service._engine)
    if (client.syncs, client.requests) != (1, 1) or ctl._engine is not None:
        raise AssertionError(f"sidecar controller cold wave: {client.syncs} syncs, "
                             f"{client.requests} requests, in-process engine "
                             f"{ctl._engine is not None}")
    degraded0 = degraded_passes.value(channel="solver")
    client.down = True
    objs, want = scaled_wave()
    wave("fallback wave", objs, want, lambda: ctl._engine)
    degraded = degraded_passes.value(channel="solver") - degraded0
    if degraded != 1 or ctl._solver_synced or client.requests != 1:
        raise AssertionError(f"sidecar controller fallback wave: degraded passes "
                             f"{degraded}, synced {ctl._solver_synced}, requests "
                             f"{client.requests}")
    client.down = False
    objs, want = scaled_wave()
    wave("recovery wave", objs, want, lambda: service._engine)
    if (client.syncs, client.requests) != (2, 2) or not ctl._solver_synced:
        raise AssertionError(f"sidecar controller recovery wave: {client.syncs} syncs, "
                             f"{client.requests} requests")
    # a cluster event (one cluster's status refreshed, nothing changed)
    # drops the sync mark through _on_cluster_event and re-enqueues every
    # binding: the next wave re-syncs before its one request, schedules the
    # scaled rows and those the gate always passes, and moves no other row
    objs, want = scaled_wave()
    scaled = {rb.meta.namespaced_name for rb in objs}
    steady = {rb.meta.namespaced_name: written(rb) for rb in rbs
              if rb.meta.namespaced_name not in scaled}
    t0 = time.perf_counter()
    store.apply(cluster_objs[0])
    event_s = time.perf_counter() - t0
    if ctl._solver_synced:
        raise AssertionError("sidecar controller: a cluster event left the sync mark set")
    rows = sum(ctl._needs_scheduling(rb)[0] for rb in rbs)
    wave("cluster-event wave", objs, want, lambda: service._engine, rows=rows)
    out["waves"]["cluster-event wave"]["apply_s"] += event_s
    moved = sum(written(rb) != steady[rb.meta.namespaced_name] for rb in rbs
                if rb.meta.namespaced_name in steady)
    if (client.syncs, client.requests) != (3, 3) or not ctl._solver_synced or moved:
        raise AssertionError(f"sidecar controller cluster-event wave: {client.syncs} syncs, "
                             f"{client.requests} requests, {moved} unscaled rows moved")
    print(f"# sidecar controller: {n} bindings x {snap.num_clusters} clusters; degraded "
          f"passes {degraded}; the recovery wave re-synced first, and the cluster-event "
          f"wave's {rows} rows after a re-sync (syncs {client.syncs}), {moved} unscaled "
          f"rows moved; card {card}", flush=True)
    return out


def plane_wave(tag: str, cp, device, card: str, apply_s: float = 0.0) -> dict:
    """One ``ControlPlane.settle``, timed and split from its spans: the store
    apply that started it (``apply_s``, measured by the caller), the
    detector's drains (bindings created), the scheduler's gate and problem
    build (its drains less its engine passes), the engine passes
    (``scheduler.pass``), the binding controller's render, the execution
    controller's member applies, status collection (the work-status and
    binding-status drains, template write-back included) and the rest
    (cluster status ticks, the cluster and unified-auth drains, the loop).
    Raises when any worker of the plane caught a reconcile error or holds a
    key for a retry: the plane's workers retry nothing
    (``MAX_RETRIES = POISON_TOLERANCE = 0``), so an engine error fails its
    wave at once. Returns the split; the caller prints it with its checks
    (``plane_line``)."""
    from karmada_tpu_torch.utils.tracing import tracer

    faults = ReconcileFaults()
    log = logging.getLogger("karmada_tpu_torch")
    log.addHandler(faults)
    t0 = time.perf_counter()
    try:
        steps = cp.settle()
        sync(device)
    finally:
        log.removeHandler(faults)
    wall = time.perf_counter() - t0
    retries = sum(len(w._retries) for w in cp.runtime.workers)
    if faults.records or retries or cp.runtime.pending():
        raise AssertionError(f"plane {tag}: {len(faults.records)} reconcile errors, {retries} "
                             f"keys awaiting a retry, {cp.runtime.pending()} queued; first:\n"
                             + (faults.records[0] if faults.records else ""))
    spans = [s for s in tracer.dump() if s["start"] >= t0 - 1e-6]

    def drained(worker: str) -> float:
        return sum(s["duration_s"] for s in spans if s["name"] == f"controller.{worker}")

    passes = [s for s in spans if s["name"] == "scheduler.pass"]
    engine_s = sum(s["duration_s"] for s in passes)
    split = {
        "store apply": apply_s,
        "detector": drained("detector"),
        "scheduler gate and build": drained("scheduler") - engine_s,
        "engine pass": engine_s,
        "binding render": drained("binding"),
        "execution apply": drained("execution"),
        "status collection": drained("work-status") + drained("binding-status"),
    }
    controllers = sum(s["duration_s"] for s in spans if s["name"].startswith("controller."))
    split["other"] = wall - controllers
    return {"wall": wall, "apply_s": apply_s, "steps": steps, "split": split,
            "passes": [s["attrs"].get("bindings", 0) for s in passes]}


def plane_line(tag: str, wave: dict, checks: str, card: str) -> None:
    split = ", ".join(f"{k} {v:.4f} s" for k, v in wave["split"].items())
    print(f"# plane {tag}: apply {wave['apply_s']:.4f} s + settle {wave['wall']:.4f} s = "
          f"{wave['apply_s'] + wave['wall']:.4f} s ({wave['steps']} reconcile steps, engine "
          f"passes {wave['passes']}): {split}; {checks}; card {card}", flush=True)


def plane_members_check(cp, rbs, region_of: dict) -> int:
    """Member objects that differ from the bindings: every member holds
    exactly the Deployments its bindings name, each with ``spec.replicas``
    equal to its divided count and the override's registry where the
    OverridePolicy's rule matches its cluster (the template's image
    elsewhere). Returns the number of (member, Deployment) entries that
    differ."""
    want = {name: {} for name in cp.members.names()}
    for rb in rbs:
        for tc in rb.spec.clusters:
            want[tc.name][rb.spec.resource.name] = tc.replicas
    bad = 0
    for name, objs in want.items():
        image = (f"{PLANE_REGISTRY}/nginx:1.25" if region_of[name] == PLANE_OVERRIDE_REGION
                 else "nginx:1.25")
        got = {(o.meta.namespace, o.meta.name, o.spec["replicas"],
                o.spec["template"]["spec"]["containers"][0]["image"])
               for o in cp.members.get(name).list("apps/v1/Deployment")}
        bad += len(got ^ {("default", d, reps, image) for d, reps in objs.items()})
    return bad


def plane_recipe_check(pkg, rbs, probs, replicas_of: dict) -> int:
    """Problems that differ from the recipe: each binding's problem, as the
    plane's detector and scheduler built it, must carry config 4's placement
    (``config4_placement``), the replicas ``replicas_of`` gives its binding,
    config 4's requests (250m cpu and 512Mi) and the Deployment's gvk, so a
    placement or count lost on the way to the engine cannot pass the
    divider check, which solves the same problems. Returns the number of
    bindings whose problem differs."""
    q = importlib.import_module(f"{pkg.__name__}.utils.quantity")
    placement = config4_placement(pkg)
    requests = q.parse_resource_list({"cpu": "250m", "memory": "512Mi"})
    return sum(p is None or p.key != rb.meta.namespaced_name or p.placement != placement
               or p.replicas != replicas_of[rb.meta.namespaced_name]
               or p.requests != requests or p.gvk != "apps/v1/Deployment"
               for rb, p in zip(rbs, probs))


def run_plane(device, card: str, templates: int = 10_000, clusters: int = 500,
              scale: int = 1000, delete: int = 1000, kill: int = PLANE_KILL,
              deschedule: int = PLANE_DESCHEDULE, autoscale: tuple = PLANE_AUTOSCALE,
              autoscale_down: int = PLANE_AUTOSCALE_DOWN, cron: int = PLANE_CRON,
              services: int = PLANE_SERVICES, ingresses: int = PLANE_INGRESSES) -> dict:
    """The control plane's propagation path on the card: the port's
    ``ControlPlane`` (detector, binding, execution, work-status,
    binding-status, cluster status and scheduler controllers over one store)
    from Deployments and their policy to Deployments in member clusters and
    status back to the templates, on BASELINE config 4 (``plane_objects``).

    1. join: the fleet joined in Push mode; every Cluster Ready, its
       summary (the status controller's sum over the member's NodeStates)
       equal to the recipe's, with the nine default resource models the
       cluster webhook gives it and no allocatable modelings;
    2. cold wave: the templates, the PropagationPolicy and the
       OverridePolicy applied and settled; every binding written and its
       placement equal to the numpy divider on the plane's own engine
       snapshot (``written_check`` on the controller's problems); one Work
       per placed cluster; every member holding exactly its Deployments
       with the divided replicas and the override's image on its region
       (``plane_members_check``); the engine on the summary route (no
       cluster with models, K7 never launched);
    3. status round: every member reports each of its Deployments ready;
       every template's ``status.readyReplicas`` equals its replicas and
       every binding's aggregated status is Healthy on exactly its clusters;
    4. scale wave: ``scale`` templates (``plane_picks``, seed 99) take new
       replica counts; one engine pass over exactly their bindings, each to
       the numpy divider; their Works and member objects carry the new
       counts; no Work of another binding is written again (its resource
       version and manifests as they were);
    5. delete wave: ``delete`` other templates deleted; their bindings,
       Works and member objects gone, and nothing else touched;
    6.-9. the failover, eviction drain, descheduler and recovery waves on
       the same plane (``plane_failover_waves``);
    10.-15. the autoscale up, hold and down, cron, networking (and its
       teardown), resume and resume drift round waves on the same plane,
       templates drawn among those the scale and delete waves did not pick
       (``plane_autoscale_waves``);
    16. pull: a small Pull-mode plane on ``device`` (``run_pull_plane``).

    The plane runs on an injected clock (``PlaneClock``), with the
    descheduler built and inactive until its wave. Each wave prints one
    ``# plane <wave>:`` line (``plane_line``) with its wall, its split
    (``plane_wave``), its checks and the card. Returns the waves and the
    cold, scale, failover, descheduler, autoscale up and down, cron and
    resume drift round waves' launch counts."""
    import karmada_tpu_torch
    from karmada_tpu_torch.controllers.propagation import WORK_BINDING_LABEL, work_manifests
    from karmada_tpu_torch.controlplane import ControlPlane
    from karmada_tpu_torch.utils.metrics import works_rendered

    pkg = karmada_tpu_torch
    out = {"waves": {}}
    t0 = time.perf_counter()
    objs = plane_objects(pkg, templates, clusters)
    build_s = time.perf_counter() - t0
    recipe = {cl.name: (dict(cl.status.resource_summary.allocatable),
                        dict(cl.status.resource_summary.allocated)) for cl in objs["clusters"]}
    region_of = {cl.name: cl.spec.region for cl in objs["clusters"]}
    clock = PlaneClock()
    cp = ControlPlane(device=device, clock=clock, enable_descheduler=True)
    cp.descheduler.active = False
    for w in cp.runtime.workers:
        w.MAX_RETRIES = w.POISON_TOLERANCE = 0
    store, ctl = cp.store, cp.scheduler

    def works_by_ref() -> dict:
        by: dict = {}
        for w in store.list("Work"):
            ref = w.meta.labels.get(WORK_BINDING_LABEL)
            if ref:
                by.setdefault(ref.partition(":")[2], []).append(w)
        return by

    # -- 1. join -------------------------------------------------------------
    t0 = time.perf_counter()
    for cl, m in zip(objs["clusters"], objs["members"]):
        cp.join_cluster(cl, m)
    wave = plane_wave("join", cp, device, card, time.perf_counter() - t0)
    bad = 0
    for cl in store.list("Cluster"):
        ready = any(c.type == "Ready" and c.status for c in cl.status.conditions)
        rs = cl.status.resource_summary
        bad += (not ready or (rs.allocatable, rs.allocated) != recipe[cl.name]
                or len(cl.spec.resource_models) != 9 or bool(rs.allocatable_modelings))
    plane_line("join", wave, f"{clusters} clusters (recipe built in {build_s:.1f} s): Ready "
               f"with the recipe's summary and 9 default models {clusters - bad} ok / {bad} "
               "bad", card)
    if bad or len(store.list("Cluster")) != clusters:
        raise AssertionError(f"plane join: {bad} clusters not Ready or off the recipe")
    out["waves"]["join"] = wave

    # -- 2. cold wave --------------------------------------------------------
    t0 = time.perf_counter()
    store.apply(objs["policy"])
    store.apply(objs["override"])
    if store.apply_many(objs["deployments"]):
        raise AssertionError("plane cold wave: the store refused templates")
    apply_s = time.perf_counter() - t0
    reset_counts()
    rendered0 = works_rendered.value()
    wave = plane_wave("cold", cp, device, card, apply_s)
    out["cold_launches"] = read_counts()
    out["waves"]["cold"] = wave
    engine = ctl._engine
    rbs = sorted_bindings(store)
    probs = [ctl._problem_cache.get(rb.meta.namespaced_name) for rb in rbs]
    if len(rbs) != templates or None in probs or wave["passes"] != [templates] \
            or engine._fleet is None:
        raise AssertionError(f"plane cold wave: {len(rbs)} bindings, passes {wave['passes']}, "
                             f"fleet {engine._fleet is not None}")
    t0 = time.perf_counter()
    bad_recipe = plane_recipe_check(pkg, rbs, probs, {
        f"default/d{i}-deployment": (i % 40) + 1 for i in range(templates)})
    bad_div = written_check(engine, probs, rbs) + unwritten(rbs, placed=True)
    by_ref = works_by_ref()
    placed_n = sum(len(rb.spec.clusters) for rb in rbs)
    bad_works = sum(sorted(w.meta.namespace[len("karmada-es-"):] for w in
                           by_ref.get(rb.meta.namespaced_name, ()))
                    != sorted(tc.name for tc in rb.spec.clusters) for rb in rbs)
    n_works = sum(map(len, by_ref.values()))
    delta = sum(w.spec.workload_template is not None for ws in by_ref.values() for w in ws)
    bad_members = plane_members_check(cp, rbs, region_of)
    models = bool(engine.snapshot.model_pack.has_models.any())
    check_s = time.perf_counter() - t0
    launched = {k: v for k, v in out["cold_launches"].items() if v}
    plane_line("cold", wave, f"{templates} templates x {clusters} clusters: problems "
               f"off the recipe (placement, replicas, requests) {bad_recipe}; numpy-divider "
               f"check {templates - bad_div} ok / {bad_div} bad; {n_works} Works for "
               f"{placed_n} placed clusters ({delta} template-delta, "
               f"{works_rendered.value() - rendered0:.0f} rendered; {bad_works} bindings' "
               f"Works off their clusters); members' Deployments, replicas and images "
               f"{bad_members} bad; models route {models}; checks {check_s:.1f} s; "
               f"launches {launched}", card)
    if bad_recipe or bad_div or bad_works or n_works != placed_n or bad_members or models \
            or out["cold_launches"]["model_overlay"]:
        raise AssertionError(f"plane cold wave: {bad_recipe} problems off the recipe, "
                             f"{bad_div} bindings differ from the numpy divider, {bad_works} bindings' Works and {bad_members} member "
                             f"objects are wrong, models route {models}")

    # -- 3. status round -----------------------------------------------------
    t0 = time.perf_counter()
    report_ready(cp)
    wave = plane_wave("status", cp, device, card, time.perf_counter() - t0)
    out["waves"]["status"] = wave
    tpls = store.list("Resource")
    bad_tpl = sum(t.status.get("readyReplicas") != t.spec["replicas"] for t in tpls)
    bad_agg = sum(
        sorted(i.cluster_name for i in rb.status.aggregated_status)
        != sorted(tc.name for tc in rb.spec.clusters)
        or not all(i.health == "Healthy" and i.applied for i in rb.status.aggregated_status)
        for rb in rbs)
    plane_line("status", wave, f"{n_works} member Deployments report ready: templates' "
               f"readyReplicas {len(tpls) - bad_tpl} ok / {bad_tpl} bad; bindings' aggregated "
               f"status Healthy on their clusters {len(rbs) - bad_agg} ok / {bad_agg} bad", card)
    if bad_tpl or bad_agg or len(tpls) != templates:
        raise AssertionError(f"plane status round: {bad_tpl} templates and {bad_agg} bindings "
                             "without their members' status")

    # -- 4. scale wave -------------------------------------------------------
    scaled, deleted = plane_picks(templates, scale, delete)
    scaled_keys = {f"default/d{i}-deployment": reps for i, reps in scaled.items()}
    before = {w.meta.namespaced_name: (w.meta.resource_version, w.meta.generation)
              for key, ws in works_by_ref().items() if key not in scaled_keys for w in ws}
    manifests_before = {k: [m.spec for m in work_manifests(store, store.get("Work", k))]
                        for k in list(before)[:: max(1, len(before) // 2000)]}
    t0 = time.perf_counter()
    for i, reps in scaled.items():
        t = store.get("Resource", f"default/d{i}")
        t.spec["replicas"] = reps
        t.meta.generation += 1
        store.apply(t)
    apply_s = time.perf_counter() - t0
    reset_counts()
    rendered0 = works_rendered.value()
    wave = plane_wave("scale", cp, device, card, apply_s)
    out["waves"]["scale"] = wave
    out["scale_launches"] = read_counts()
    rbs = sorted_bindings(store)
    srbs = [rb for rb in rbs if rb.meta.namespaced_name in scaled_keys]
    sprobs = [ctl._problem_cache[rb.meta.namespaced_name] for rb in srbs]
    bad_reps = plane_recipe_check(pkg, srbs, sprobs, scaled_keys)
    bad_div = written_check(ctl._engine, sprobs, srbs) + unwritten(srbs, placed=True)
    bad_members = plane_members_check(cp, rbs, region_of)
    rewritten = sum((w := store.get("Work", k)) is None
                    or (w.meta.resource_version, w.meta.generation) != v
                    for k, v in before.items())
    rewritten += sum([m.spec for m in work_manifests(store, store.get("Work", k))] != v
                     for k, v in manifests_before.items())
    plane_line("scale", wave, f"{len(scaled)} templates (seed 99) rescaled: numpy-divider "
               f"check {len(srbs) - bad_div} ok / {bad_div} bad ({bad_reps} problems off the "
               f"recipe or the new replicas); {works_rendered.value() - rendered0:.0f} Works rendered; members "
               f"{bad_members} bad; other bindings' Works written again {rewritten} of "
               f"{len(before)}; launches "
               f"{ {k: v for k, v in out['scale_launches'].items() if v} }", card)
    if wave["passes"] != [len(scaled)] or len(srbs) != len(scaled) or bad_reps or bad_div \
            or bad_members or rewritten:
        raise AssertionError(f"plane scale wave: passes {wave['passes']}, {bad_div} bindings "
                             f"differ from the numpy divider, {bad_members} member objects "
                             f"wrong, {rewritten} other Works written again")

    # -- 5. delete wave ------------------------------------------------------
    gone_keys = {f"default/d{i}-deployment" for i in deleted}
    kept = {rb.meta.namespaced_name: [(tc.name, tc.replicas) for tc in rb.spec.clusters]
            for rb in rbs if rb.meta.namespaced_name not in gone_keys}
    before = {w.meta.namespaced_name: w.meta.resource_version
              for key, ws in works_by_ref().items() if key in kept for w in ws}
    t0 = time.perf_counter()
    for i in deleted:
        store.delete("Resource", f"default/d{i}")
    wave = plane_wave("delete", cp, device, card, time.perf_counter() - t0)
    out["waves"]["delete"] = wave
    rbs = sorted_bindings(store)
    left = {rb.meta.namespaced_name: [(tc.name, tc.replicas) for tc in rb.spec.clusters]
            for rb in rbs}
    by_ref = works_by_ref()
    stale = sum(k in by_ref for k in gone_keys)
    touched = sum((w := store.get("Work", k)) is None or w.meta.resource_version != v
                  for k, v in before.items())
    bad_members = plane_members_check(cp, rbs, region_of)
    plane_line("delete", wave, f"{len(deleted)} templates deleted: {len(rbs)} bindings left "
               f"({'equal' if left == kept else 'NOT equal'} to the others before), "
               f"{stale} deleted bindings with Works, {touched} other Works touched, "
               f"members {bad_members} bad, passes {wave['passes']}", card)
    if left != kept or stale or touched or bad_members or wave["passes"]:
        raise AssertionError(f"plane delete wave: bindings {'kept' if left == kept else 'off'}"
                             f", {stale} with Works, {touched} other Works touched, "
                             f"{bad_members} member objects wrong")
    failover = plane_failover_waves(cp, clock, device, card, region_of, kill, deschedule)
    out["waves"].update(failover.pop("waves"))
    out.update(failover)
    autoscaled = plane_autoscale_waves(cp, clock, device, card, region_of,
                                       set(scaled) | set(deleted), templates, autoscale,
                                       autoscale_down, cron, services, ingresses)
    out["waves"].update(autoscaled.pop("waves"))
    out.update(autoscaled)
    out["waves"]["pull"] = run_pull_plane(device, card)
    return out


def plane_failover_waves(cp, clock, device, card: str, region_of: dict, kill: int,
                         deschedule: int) -> dict:
    """The failover path on a settled config-4 plane (``run_plane``'s, after
    its delete wave), with the Failover gate on and restored after:

    6. failover: the chaos seam (``utils.faultinject``) armed with
       ``cluster.health=down`` on ``kill`` clusters (``plane_kills``, seed
       7: one of the clusters that host bindings, the rest among the
       others), the clock advanced 60 s and the plane settled. Each killed cluster
       NotReady with the NoSchedule and NoExecute not-ready taints; no
       binding keeps a killed cluster; eviction tasks only on displaced
       bindings, at most one per killed cluster each had (from the taint
       manager, its replicas there, stamped with the clock). The
       graceful-eviction controller drops a task as soon as every cluster
       of the new placement reports applied and Healthy, and it may read
       the surviving clusters' status as it was before their counts
       changed, so some tasks are gone by the wave's end, as on the JAX
       plane (tier-1 holds the two planes' tasks equal); each displaced
       binding's placement equal to the numpy divider on the plane's own
       snapshot and the controller's problems (``written_check``), its
       replicas summing to its template's; every other binding's placement
       as it was and none of its Works written again;
    7. eviction drain: every live member reports its new and changed
       Deployments ready; every graceful-eviction task gone, and with them
       the displaced bindings' Works and member objects on the killed
       clusters;
    8. descheduler: ``deschedule`` bindings placed on a live cluster
       (``plane_deschedule_picks``, seed 11) get min(2, replicas there)
       pods marked unschedulable on one of their clusters, the clock
       advances 120 s and the descheduler runs its round
       (``deschedule_once``, what its ticker calls); each such binding
       shrunk on that cluster (its problem's previous placement) and
       re-solved to the numpy divider; no other binding's placement or Works
       changed;
    9. recovery: the seam disarmed, the clock advanced 60 s; every killed
       cluster Ready with its recipe's taints only; the engine passes and
       the Works written in the settle printed.

    Returns the waves and the failover and descheduler waves' launches."""
    from karmada_tpu_torch.api.cluster import NO_EXECUTE, NO_SCHEDULE, TAINT_CLUSTER_NOT_READY
    from karmada_tpu_torch.controllers.propagation import WORK_BINDING_LABEL
    from karmada_tpu_torch.utils import faultinject
    from karmada_tpu_torch.utils.features import FAILOVER, feature_gate
    from karmada_tpu_torch.utils.metrics import works_rendered

    store, ctl = cp.store, cp.scheduler
    out = {"waves": {}}

    def placement(rb) -> dict:
        return {tc.name: tc.replicas for tc in rb.spec.clusters}

    def work_versions() -> dict:
        """binding key -> {Work key: (resource version, generation)}."""
        by: dict = {}
        for w in store.list("Work"):
            ref = w.meta.labels.get(WORK_BINDING_LABEL)
            if ref:
                by.setdefault(ref.partition(":")[2], {})[w.meta.namespaced_name] = (
                    w.meta.resource_version, w.meta.generation)
        return by

    names = sorted(c.name for c in store.list("Cluster"))
    killed = plane_kills(names, kill, {tc.name for rb in store.list("ResourceBinding")
                                       for tc in rb.spec.clusters})
    dead = set(killed)
    live = set(names) - dead
    recipe_taints = {c.name: [(t.key, t.value, t.effect) for t in c.spec.taints]
                     for c in store.list("Cluster")}
    gate_was = feature_gate.enabled(FAILOVER)
    feature_gate.set(FAILOVER, True)
    try:
        # -- 6. failover ----------------------------------------------------
        rbs = sorted_bindings(store)
        before = {rb.meta.namespaced_name: placement(rb) for rb in rbs}
        replicas = {rb.meta.namespaced_name: rb.spec.replicas for rb in rbs}
        displaced = {k: sorted(set(p) & dead) for k, p in before.items() if set(p) & dead}
        versions = work_versions()
        engine0, fleet0 = ctl._engine, ctl._engine._fleet
        t0 = time.perf_counter()
        faultinject.arm(kill_spec(killed), seed=7)
        clock.now += 60
        apply_s = time.perf_counter() - t0
        reset_counts()
        rendered0 = works_rendered.value()
        wave = plane_wave("failover", cp, device, card, apply_s)
        out["failover_launches"] = read_counts()
        out["waves"]["failover"] = wave
        engine = ctl._engine
        rbs = sorted_bindings(store)
        bad_taints = 0
        for name in killed:
            c = store.get("Cluster", name)
            ready = any(x.type == "Ready" and x.status for x in c.status.conditions)
            keys = {(t.key, t.effect) for t in c.spec.taints}
            bad_taints += ready or not {(TAINT_CLUSTER_NOT_READY, NO_SCHEDULE),
                                        (TAINT_CLUSTER_NOT_READY, NO_EXECUTE)} <= keys
        kept_dead = sum(bool(set(placement(rb)) & dead) for rb in rbs)
        bad_tasks = carried = 0
        for rb in rbs:
            key = rb.meta.namespaced_name
            tasks = rb.spec.graceful_eviction_tasks
            carried += bool(tasks)
            froms = [t.from_cluster for t in tasks]
            bad_tasks += len(set(froms)) != len(froms) \
                or not set(froms) <= set(displaced.get(key, ())) or any(
                t.replicas != before[key][t.from_cluster] or t.producer != "TaintManager"
                or t.reason != "TaintUntolerated" or t.creation_timestamp != clock.now
                for t in tasks)
        drbs = [rb for rb in rbs if rb.meta.namespaced_name in displaced]
        dprobs = [ctl._problem_cache.get(rb.meta.namespaced_name) for rb in drbs]
        bad_div = (written_check(engine, dprobs, drbs) if None not in dprobs else len(drbs)) \
            + unwritten(drbs, placed=True)
        bad_sum = sum(sum(placement(rb).values()) != replicas[rb.meta.namespaced_name]
                      for rb in drbs)
        moved = sum(placement(rb) != before[rb.meta.namespaced_name] for rb in rbs
                    if rb.meta.namespaced_name not in displaced)
        after_versions = work_versions()
        rewritten = sum(after_versions.get(k) != v for k, v in versions.items()
                        if k not in displaced)
        rebuilt = engine is not engine0 or engine._fleet is not fleet0
        launched = {k: v for k, v in out["failover_launches"].items() if v}
        plane_line("failover", wave, f"{kill} of {len(names)} clusters killed (seed 7; "
                   f"{sorted(dead & {c for p in before.values() for c in p})} host bindings): "
                   f"NotReady with both not-ready taints {kill - bad_taints} ok / {bad_taints} "
                   f"bad; {len(displaced)} bindings displaced, {kept_dead} keep a killed "
                   f"cluster; {carried} carry eviction tasks, the others' already done, "
                   f"{bad_tasks} with tasks off; "
                   f"numpy-divider check {len(drbs) - bad_div} ok / {bad_div} bad, {bad_sum} "
                   f"off their replicas; other bindings moved {moved}, their Works written "
                   f"again {rewritten}; rows re-solved by pass {wave['passes']}; "
                   f"{works_rendered.value() - rendered0:.0f} Works rendered; fleet table "
                   f"rebuilt {rebuilt}; launches {launched}", card)
        if bad_taints or kept_dead or bad_tasks or bad_div or bad_sum or moved or rewritten \
                or not displaced or sum(wave["passes"]) != len(displaced):
            raise AssertionError(f"plane failover: {bad_taints} killed clusters off, "
                                 f"{kept_dead} bindings keep a killed cluster, {bad_tasks} "
                                 f"task sets off, {bad_div} differ from the numpy divider, "
                                 f"{bad_sum} off their replicas, {moved} others moved, "
                                 f"{rewritten} others' Works written again; passes "
                                 f"{wave['passes']} for {len(displaced)} displaced")

        # -- 7. eviction drain ----------------------------------------------
        t0 = time.perf_counter()
        reported = report_ready(cp, skip=dead)
        wave = plane_wave("drain", cp, device, card, time.perf_counter() - t0)
        out["waves"]["drain"] = wave
        rbs = sorted_bindings(store)
        tasks_left = sum(len(rb.spec.graceful_eviction_tasks) for rb in rbs)
        works_dead = sum(w.meta.namespace[len("karmada-es-"):] in dead
                         for w in store.list("Work") if w.meta.labels.get(WORK_BINDING_LABEL))
        objs_dead = sum(len(cp.members.get(n).list("apps/v1/Deployment")) for n in killed)
        bad_members = plane_members_check(cp, rbs, region_of)
        plane_line("drain", wave, f"{reported} member Deployments report ready: eviction "
                   f"tasks left {tasks_left}; Works on killed clusters {works_dead}, their "
                   f"member Deployments {objs_dead}; members {bad_members} bad; passes "
                   f"{wave['passes']}", card)
        if tasks_left or works_dead or objs_dead or bad_members:
            raise AssertionError(f"plane drain: {tasks_left} tasks, {works_dead} Works and "
                                 f"{objs_dead} member objects left on killed clusters, "
                                 f"{bad_members} member objects wrong")

        # -- 8. descheduler -------------------------------------------------
        rbs = sorted_bindings(store)
        before = {rb.meta.namespaced_name: placement(rb) for rb in rbs}
        picks = plane_deschedule_picks(rbs, live, deschedule)
        picked = {key: (cluster, n) for key, _, cluster, n in picks}
        versions = work_versions()
        mark_unschedulable(cp, picks, since=clock.now)
        clock.now += 120
        reset_counts()
        t0 = time.perf_counter()
        cp.descheduler.active = True
        try:
            cp.descheduler.deschedule_once()
        finally:
            cp.descheduler.active = False
        round_s = time.perf_counter() - t0
        wave = plane_wave("deschedule", cp, device, card, round_s)
        out["deschedule_launches"] = read_counts()
        out["waves"]["deschedule"] = wave
        rbs = sorted_bindings(store)
        prbs = [rb for rb in rbs if rb.meta.namespaced_name in picked]
        pprobs = [ctl._problem_cache.get(rb.meta.namespaced_name) for rb in prbs]

        def shrunk(key) -> dict:
            cluster, n = picked[key]
            want = dict(before[key])
            want[cluster] -= n
            return {c: r for c, r in want.items() if r > 0}

        bad_prev = sum(p is None or dict(p.prev) != shrunk(rb.meta.namespaced_name)
                       for rb, p in zip(prbs, pprobs))
        bad_div = (written_check(ctl._engine, pprobs, prbs) if None not in pprobs
                   else len(prbs)) + unwritten(prbs, placed=True)
        moved = sum(placement(rb) != before[rb.meta.namespaced_name] for rb in rbs
                    if rb.meta.namespaced_name not in picked)
        after_versions = work_versions()
        rewritten = sum(after_versions.get(k) != v for k, v in versions.items()
                        if k not in picked)
        launched = {k: v for k, v in out["deschedule_launches"].items() if v}
        plane_line("deschedule", wave, f"{len(picks)} bindings (seed 11) with "
                   f"{sum(n for _, n in picked.values())} replicas unschedulable for 120 s "
                   f"(descheduler round {round_s:.4f} s in the apply): shrunk on their cluster "
                   f"{len(prbs) - bad_prev} ok / {bad_prev} bad; numpy-divider check "
                   f"{len(prbs) - bad_div} ok / {bad_div} bad; other bindings moved {moved}, "
                   f"their Works written again {rewritten}; launches {launched}", card)
        if len(prbs) != len(picks) or bad_prev or bad_div or moved or rewritten \
                or wave["passes"] != [len(picks)]:
            raise AssertionError(f"plane descheduler: {bad_prev} not shrunk, {bad_div} differ "
                                 f"from the numpy divider, {moved} others moved, {rewritten} "
                                 f"others' Works written again; passes {wave['passes']}")

        # -- 9. recovery ----------------------------------------------------
        rbs = sorted_bindings(store)
        before = {rb.meta.namespaced_name: placement(rb) for rb in rbs}
        versions = work_versions()
        t0 = time.perf_counter()
        faultinject.disarm()
        clock.now += 60
        reset_counts()
        rendered0 = works_rendered.value()
        wave = plane_wave("recovery", cp, device, card, time.perf_counter() - t0)
        out["waves"]["recovery"] = wave
        bad_ready = 0
        for name in killed:
            c = store.get("Cluster", name)
            ready = any(x.type == "Ready" and x.status for x in c.status.conditions)
            bad_ready += not ready or [(t.key, t.value, t.effect) for t in c.spec.taints] \
                != recipe_taints[name]
        rbs = sorted_bindings(store)
        moved = sum(placement(rb) != before[rb.meta.namespaced_name] for rb in rbs)
        after_versions = work_versions()
        written_works = sum(after_versions.get(k) != v for k, v in versions.items())
        plane_line("recovery", wave, f"chaos seam disarmed: killed clusters Ready with their "
                   f"recipe's taints only {kill - bad_ready} ok / {bad_ready} bad; bindings "
                   f"moved {moved}; engine passes {wave['passes']}; bindings' Works written "
                   f"{written_works} ({works_rendered.value() - rendered0:.0f} rendered); "
                   f"launches { {k: v for k, v in read_counts().items() if v} }", card)
        if bad_ready:
            raise AssertionError(f"plane recovery: {bad_ready} killed clusters not Ready or "
                                 "still tainted")
    finally:
        faultinject.disarm()
        feature_gate.set(FAILOVER, gate_was)
    return out


def plane_autoscale_waves(cp, clock, device, card: str, region_of: dict, skip,
                          templates: int, autoscale: tuple = PLANE_AUTOSCALE,
                          autoscale_down: int = PLANE_AUTOSCALE_DOWN, cron: int = PLANE_CRON,
                          services: int = PLANE_SERVICES,
                          ingresses: int = PLANE_INGRESSES) -> dict:
    """The autoscaling, networking and resume waves on a settled config-4
    plane (``run_plane``'s, after its recovery wave), templates drawn with
    seed 7 among those not in ``skip`` (``autoscale_picks``):

    10. autoscale up: FederatedHPAs (cpu at ``HPA_TARGET`` %, min 1, max
        4x) on ``sum(autoscale)`` templates whose members report aggregate
        samples at 80 %, inside the tolerance (45-50 %) and at 400 %; the
        clock past the sync period. Every template at ``hpa_rule``; one
        engine pass over exactly the rescaled rows, each to the numpy
        divider; no other binding's Works written again. The samples then
        sit at the target;
    11. autoscale hold and down: ``autoscale_down`` more at 20 % behind a
        300 s window: the first settle changes no template and runs no pass;
        301 s later one pass over them (under ``fleet_threshold``: the
        general route), each to the numpy divider and ``hpa_rule``;
    12. cron: ``cron`` CronFederatedHPAs (``0 9 * * *``, half up, half
        down); the clock at the next 08:59:30 UTC (nothing fires), then
        09:00:30: one pass over exactly them, each to the numpy divider, one
        execution history entry each; a settle later in the minute fires
        nothing;
    13. networking and its teardown: ``services`` services exported from 2-4
        of their binding's clusters with a MultiClusterService each to 4
        named consumers, ``ingresses`` MultiClusterIngresses over them
        (``network_picks``, seed 13): every consumer holds the derived
        Service and every other provider's slice, every ingress stands on
        exactly the clusters that serve its backends, no engine pass; then
        everything deleted with the Works dispatched for it, and nothing
        derived left on any member or in the store;
    14. resume: the store checkpointed and restored into a new plane on the
        same clock, the same members joined (``resume_plane``). The settle
        keeps every binding's clusters and replicas and every member
        object's spec (members written again counted); the gate holds every
        binding (observed generation, Scheduled, replicas assigned), so the
        settle runs no engine pass, as on the JAX plane;
    15. resume drift round: the resumed plane is built with the drift
        rebalancer (its ticker off), and its first round
        (``rebalance_once``) dry-solves every binding on the resumed
        scheduler's new engine, a cold fleet pass: every row held to the
        numpy divider, the stamped set to ``drift_referent``
        (``rebalance_np``); the settle after it re-places the stamped rows
        at the numpy divider's fresh ideal and moves no other binding.

    Returns the waves and the launches of the up, down, cron and resume
    drift round waves."""
    import karmada_tpu_torch
    from karmada_tpu_torch.controllers.propagation import WORK_BINDING_LABEL
    from karmada_tpu_torch.controllers.rebalance import disruption_budget
    from karmada_tpu_torch.utils.metrics import works_rendered

    pkg = karmada_tpu_torch
    store, ctl = cp.store, cp.scheduler
    out = {"waves": {}}

    def work_versions() -> dict:
        by: dict = {}
        for w in store.list("Work"):
            ref = w.meta.labels.get(WORK_BINDING_LABEL)
            if ref:
                by.setdefault(ref.partition(":")[2], {})[w.meta.namespaced_name] = (
                    w.meta.resource_version, w.meta.generation)
        return by

    def replicas(i) -> int:
        return store.get("Resource", f"default/d{i}").spec["replicas"]

    def solved(tag, keys: dict) -> tuple[int, int]:
        """(rows off the numpy divider or unwritten, problems off the
        recipe or their new replicas) for ``keys``: {binding key:
        replicas}."""
        rbs = [rb for rb in sorted_bindings(store) if rb.meta.namespaced_name in keys]
        probs = [ctl._problem_cache.get(rb.meta.namespaced_name) for rb in rbs]
        if len(rbs) != len(keys) or None in probs:
            raise AssertionError(f"plane {tag}: {len(rbs)} bindings of {len(keys)}, "
                                 f"{probs.count(None)} without a problem")
        bad_div = written_check(ctl._engine, probs, rbs) + unwritten(rbs, placed=True)
        return bad_div, plane_recipe_check(pkg, rbs, probs, keys)

    up, down, crons = autoscale_picks(templates, skip, autoscale, autoscale_down, cron)
    rep0 = {i: replicas(i) for i in (*up, *down, *crons)}
    if any(r != (i % 40) + 1 for i, r in rep0.items()):
        raise AssertionError("plane autoscale: a picked template left its recipe's replicas")

    # -- 10. autoscale up -----------------------------------------------------
    want = {i: hpa_rule(rep0[i], u, 1, hpa_max(rep0[i])) for i, u in up.items()}
    moved = {f"default/d{i}-deployment": r for i, r in want.items() if r != rep0[i]}
    versions = work_versions()
    t0 = time.perf_counter()
    set_samples(cp, up)
    for hpa in hpa_objects(pkg, sorted(up), rep0, window=300):
        store.apply(hpa)
    clock.now += 16  # past the controller's 15 s sync period
    apply_s = time.perf_counter() - t0
    reset_counts()
    rendered0 = works_rendered.value()
    wave = plane_wave("autoscale up", cp, device, card, apply_s)
    out["up_launches"] = read_counts()
    out["waves"]["autoscale up"] = wave
    bad_rule = sum(replicas(i) != r for i, r in want.items())
    bad_status = sum((h.status.current_replicas, h.status.desired_replicas)
                     != (rep0[i], want[i]) for i in up
                     for h in [store.get("FederatedHPA", f"default/d{i}-hpa")])
    bad_div, bad_reps = solved("autoscale up", moved)
    after = work_versions()
    rewritten = sum(after.get(k) != v for k, v in versions.items() if k not in moved)
    bad_members = plane_members_check(cp, sorted_bindings(store), region_of)
    n80, ntol, n400 = autoscale
    plane_line("autoscale up", wave, f"{len(up)} FederatedHPAs ({n80} at 80 %, {ntol} inside "
               f"the tolerance, {n400} at 400 % of {HPA_TARGET} %; seed 7): templates at the "
               f"HPA rule {len(up) - bad_rule} ok / {bad_rule} bad, HPA status {bad_status} "
               f"bad; {len(moved)} rescaled, numpy-divider check {len(moved) - bad_div} ok / "
               f"{bad_div} bad ({bad_reps} problems off the recipe or the new replicas); "
               f"{works_rendered.value() - rendered0:.0f} Works rendered; other bindings' "
               f"Works written again {rewritten}; members {bad_members} bad; launches "
               f"{ {k: v for k, v in out['up_launches'].items() if v} }", card)
    if bad_rule or bad_status or bad_div or bad_reps or rewritten or bad_members \
            or wave["passes"] != [len(moved)] or len(moved) != n80 + n400:
        raise AssertionError(f"plane autoscale up: {bad_rule} templates off the HPA rule, "
                             f"{bad_status} statuses off, {bad_div} rows off the numpy "
                             f"divider, {rewritten} other Works written again, passes "
                             f"{wave['passes']} for {len(moved)} rescaled")
    set_samples(cp, {i: HPA_TARGET for i in up})

    # -- 11. autoscale hold, autoscale down -----------------------------------
    held = {i: hpa_rule(rep0[i], 20, 1, hpa_max(rep0[i])) for i in down}
    want = {i: hpa_rule(rep0[i], 20, 1, hpa_max(rep0[i]), held=False) for i in down}
    t0 = time.perf_counter()
    set_samples(cp, {i: 20 for i in down})
    for hpa in hpa_objects(pkg, down, rep0, window=300):
        store.apply(hpa)
    wave = plane_wave("autoscale hold", cp, device, card, time.perf_counter() - t0)
    out["waves"]["autoscale hold"] = wave
    bad_hold = sum(replicas(i) != held[i] for i in down)
    plane_line("autoscale hold", wave, f"{len(down)} FederatedHPAs at 20 % behind a 300 s "
               f"window: templates held {len(down) - bad_hold} ok / {bad_hold} bad; passes "
               f"{wave['passes']}", card)
    if bad_hold or wave["passes"] or any(held[i] != rep0[i] for i in down):
        raise AssertionError(f"plane autoscale hold: {bad_hold} templates moved, passes "
                             f"{wave['passes']}")
    moved = {f"default/d{i}-deployment": r for i, r in want.items()}
    versions = work_versions()
    clock.now += 301
    reset_counts()
    wave = plane_wave("autoscale down", cp, device, card)
    out["down_launches"] = read_counts()
    out["waves"]["autoscale down"] = wave
    bad_rule = sum(replicas(i) != r for i, r in want.items())
    bad_div, bad_reps = solved("autoscale down", moved)
    after = work_versions()
    rewritten = sum(after.get(k) != v for k, v in versions.items() if k not in moved)
    plane_line("autoscale down", wave, f"the window passed (301 s): templates at the HPA rule "
               f"{len(down) - bad_rule} ok / {bad_rule} bad; numpy-divider check "
               f"{len(moved) - bad_div} ok / {bad_div} bad ({bad_reps} problems off); other "
               f"bindings' Works written again {rewritten}; launches "
               f"{ {k: v for k, v in out['down_launches'].items() if v} }", card)
    if bad_rule or bad_div or bad_reps or rewritten or wave["passes"] != [len(moved)] \
            or any(want[i] >= rep0[i] for i in down):
        raise AssertionError(f"plane autoscale down: {bad_rule} templates off the HPA rule, "
                             f"{bad_div} rows off the numpy divider, {rewritten} other Works "
                             f"written again, passes {wave['passes']}")
    set_samples(cp, {i: HPA_TARGET for i in down})

    # -- 12. cron -------------------------------------------------------------
    t0 = time.perf_counter()
    for obj in cron_objects(pkg, crons):
        store.apply(obj)
    clock.now = next_utc(clock.now, 8, 59, 30)
    arm = plane_wave("cron arm", cp, device, card, time.perf_counter() - t0)
    fired_early = sum(bool(store.get("CronFederatedHPA", f"default/d{i}-cron").status
                           .execution_histories) for i in crons)
    moved = {f"default/d{i}-deployment": r for i, r in crons.items()}
    versions = work_versions()
    clock.now += 60
    fired_at = clock.now
    reset_counts()
    wave = plane_wave("cron", cp, device, card)
    out["cron_launches"] = read_counts()
    out["waves"]["cron"] = wave
    bad_reps_t = sum(replicas(i) != r for i, r in crons.items())
    bad_div, bad_reps = solved("cron", moved)
    after = work_versions()
    rewritten = sum(after.get(k) != v for k, v in versions.items() if k not in moved)

    def histories() -> int:
        return sum(
            [(h.rule_name, h.execution_time, h.applied_replicas, h.message)
             for h in store.get("CronFederatedHPA", f"default/d{i}-cron").status
             .execution_histories] != [("morning", fired_at, r, "")]
            for i, r in crons.items())

    bad_hist = histories()
    clock.now += 5
    again = plane_wave("cron again", cp, device, card)
    bad_again = histories()
    plane_line("cron", wave, f"{len(crons)} CronFederatedHPAs at 09:00 UTC (armed at 08:59:30 "
               f"in {arm['wall']:.4f} s, {fired_early} fired early, passes {arm['passes']}): "
               f"templates at their new sizes {len(crons) - bad_reps_t} ok / {bad_reps_t} bad; "
               f"numpy-divider check {len(moved) - bad_div} ok / {bad_div} bad ({bad_reps} "
               f"problems off); execution histories {len(crons) - bad_hist} ok / {bad_hist} "
               f"bad; a settle 5 s later ({again['wall']:.4f} s) fired {bad_again} again, "
               f"passes {again['passes']}; other bindings' Works written again {rewritten}; "
               f"launches { {k: v for k, v in out['cron_launches'].items() if v} }", card)
    if fired_early or arm["passes"] or bad_reps_t or bad_div or bad_reps or bad_hist \
            or bad_again or again["passes"] or rewritten or wave["passes"] != [len(moved)]:
        raise AssertionError(f"plane cron: {fired_early} fired early, {bad_reps_t} templates "
                             f"off, {bad_div} rows off the numpy divider, {bad_hist} "
                             f"histories off, {bad_again} after a second settle, passes "
                             f"{wave['passes']}")

    # -- 13. networking -------------------------------------------------------
    clock.now += 60  # out of the cron's minute
    rbs = sorted_bindings(store)
    names = sorted(cp.members.names())
    providers, consumers, ings = network_picks(rbs, names, services, ingresses,
                                               PLANE_CONSUMERS)
    t0 = time.perf_counter()
    network_objects(pkg, cp, providers, consumers, ings)
    wave = plane_wave("networking", cp, device, card, time.perf_counter() - t0)
    out["waves"]["networking"] = wave
    bad_mcs, bad_mci = network_check(cp, providers, consumers, ings)
    collected = sum(r.kind == "EndpointSlice" for r in store.list("Resource"))
    n_slices = sum(map(len, providers.values()))
    plane_line("networking", wave, f"{len(providers)} services exported from "
               f"{n_slices} provider clusters (seed 13), {collected} slices collected; "
               f"{len(providers)} MultiClusterServices to {PLANE_CONSUMERS} consumers each "
               f"{len(providers) - bad_mcs} ok / {bad_mcs} missing; {len(ings)} ingresses on "
               f"their backends' clusters {len(ings) - bad_mci} ok / {bad_mci} bad; passes "
               f"{wave['passes']}", card)
    if bad_mcs or bad_mci or collected != n_slices or wave["passes"]:
        raise AssertionError(f"plane networking: {bad_mcs} consumers off, {bad_mci} ingresses "
                             f"off, {collected} slices collected of {n_slices}, passes "
                             f"{wave['passes']}")
    t0 = time.perf_counter()
    network_teardown(cp, providers, ings)
    wave = plane_wave("networking teardown", cp, device, card, time.perf_counter() - t0)
    out["waves"]["networking teardown"] = wave
    left = sum(r.kind == "EndpointSlice" for r in store.list("Resource"))
    left += sum(w.meta.name.startswith(("mcs-", "mci-")) for w in store.list("Work"))
    derived = sum(o.kind in ("Service", "EndpointSlice", "Ingress")
                  for n in names for o in cp.members.get(n).list())
    plane_line("networking teardown", wave, f"exports, services, ingresses and their Works "
               f"deleted: {left} collected slices and Works left, {derived} derived member "
               f"objects left; passes {wave['passes']}", card)
    if left or derived or wave["passes"]:
        raise AssertionError(f"plane networking teardown: {left} objects left in the store, "
                             f"{derived} on members")

    # -- 14. resume -----------------------------------------------------------
    rbs = sorted_bindings(store)
    before = {rb.meta.namespaced_name: written(rb) for rb in rbs}
    objs_before = member_state(cp)
    path = os.path.join(tempfile.gettempdir(), f"plane-{os.getpid()}.ckpt")
    t0 = time.perf_counter()
    try:
        cp2, n_written, n_restored, walls = resume_plane(
            pkg, cp, path, device=device, clock=clock, enable_descheduler=True,
            enable_drift_rebalancer=True)
        size_mb = os.path.getsize(path) / 2**20
    finally:
        if os.path.exists(path):
            os.remove(path)
    restore_s = time.perf_counter() - t0
    cp2.descheduler.active = False
    cp2.drift_rebalancer.active = False  # its round is run by hand below
    for w in cp2.runtime.workers:
        w.MAX_RETRIES = w.POISON_TOLERANCE = 0
    reset_counts()
    wave = plane_wave("resume", cp2, device, card, restore_s)
    settle_launches = read_counts()
    out["waves"]["resume"] = wave
    store2, ctl2 = cp2.store, cp2.scheduler
    rbs2 = sorted_bindings(store2)
    moved = sum(written(rb) != before.get(rb.meta.namespaced_name) for rb in rbs2)
    objs_after = member_state(cp2)
    bad_objs = sum(objs_after.get(k, (None, None))[1] != spec
                   for k, (_, spec) in objs_before.items()) + len(
        set(objs_after) - set(objs_before))
    rewritten = sum(objs_after[k][0] != rv for k, (rv, _) in objs_before.items()
                    if k in objs_after)
    plane_line("resume", wave, f"{n_written} objects checkpointed ({size_mb:.1f} MB) and "
               f"{n_restored} restored into a new plane with the same {len(names)} members "
               f"(in the apply: " + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items())
               + f"); bindings "
               f"moved {moved} of {len(rbs2)}; member objects off their specs {bad_objs}, "
               f"written again {rewritten} of {len(objs_before)}; settle launches "
               f"{ {k: v for k, v in settle_launches.items() if v} }", card)
    if moved or bad_objs or len(rbs2) != len(rbs) or n_restored != n_written:
        raise AssertionError(f"plane resume: {moved} bindings moved, {bad_objs} member "
                             f"objects off, {n_restored} of {n_written} objects restored")

    # -- 15. the resumed plane's first drift round ------------------------------
    dry = []
    dry_solve = ctl2.dry_solve

    def seen(problems, dirty_keys=None):
        results = dry_solve(problems, dirty_keys)
        dry.append((problems, results))
        return results

    ctl2.dry_solve = seen
    reset_counts()
    t0 = time.perf_counter()
    try:
        stats = cp2.drift_rebalancer.rebalance_once()
        sync(device)
    finally:
        del ctl2.dry_solve
    round_s = time.perf_counter() - t0
    out["resume_launches"] = read_counts()
    if len(dry) != 1:
        raise AssertionError(f"plane resume drift round: {len(dry)} dry solves")
    (probs, results), = dry
    engine = ctl2._engine
    t0 = time.perf_counter()
    bad_div = oracle_check(engine, probs, results)
    check_s = time.perf_counter() - t0
    budget = disruption_budget()
    t0 = time.perf_counter()
    want_keys = drift_referent(engine, probs, {p.key: p.prev for p in probs}, budget)
    ref_s = time.perf_counter() - t0
    trig = stats["triggered"]
    kept = {rb.meta.namespaced_name: written(rb) for rb in rbs2}
    wave = plane_wave("resume drift round", cp2, device, card, round_s)
    out["waves"]["resume drift round"] = wave
    fresh = [ctl2._problem_cache[k] for k in trig]
    moved = [store2.get("ResourceBinding", k) for k in trig]
    bad = written_check(engine, fresh, moved) + unwritten(moved, placed=True)
    off = sum(written(rb) != kept[rb.meta.namespaced_name] for rb in sorted_bindings(store2)
              if rb.meta.namespaced_name not in trig)
    plane_line("resume drift round", wave, f"the round's dry solve of {stats['scored']} of "
               f"{len(rbs2)} bindings ({round_s:.4f} s with the round's scoring and stamps, "
               f"fleet table {engine._fleet is not None}): numpy-divider check "
               f"{len(probs) - bad_div} ok / {bad_div} bad ({check_s:.1f} s); drifted "
               f"{stats['drifted']}, {len(trig)} of budget {budget} triggered, rebalance_np's "
               f"set {'equal' if trig == want_keys else 'DIFFERENT'} ({ref_s:.1f} s); the "
               f"settle re-placed {len(trig) - bad} at the numpy divider's fresh ideal / {bad} "
               f"bad, {off} other bindings moved; launches "
               f"{ {k: v for k, v in out['resume_launches'].items() if v} }", card)
    if bad_div or engine._fleet is None or stats["scored"] != len(probs) or trig != want_keys \
            or len(trig) != min(budget, stats["drifted"]) or bad or off \
            or wave["passes"] != ([len(trig)] if trig else []):
        raise AssertionError(f"plane resume drift round: {bad_div} rows off the numpy "
                             f"divider, triggered {len(trig)}, referent {len(want_keys)}, "
                             f"{bad} re-placed rows bad, {off} others moved, engine passes "
                             f"{wave['passes']}")
    out["resume_walls"] = walls
    return out


def run_pull_plane(device, card: str) -> dict:
    """A Pull-mode plane on ``device`` at the size of the JAX package's
    Pull tests: one Push member and two Pull members registered through
    the plane's authority (a bootstrap token, a CSR, a Pull join), each
    with its in-process agent. A Deployment over the three; the agents
    apply their Works and reflect their members' status back (the
    template's readyReplicas); one agent stops, and its cluster stays Ready
    until the lease is ``lease_grace_seconds`` (30 s) old, then degrades and
    is tainted; the agent comes back and the cluster recovers. The engine
    runs on ``device``. Returns the wave."""
    from karmada_tpu_torch.api.core import ObjectMeta
    from karmada_tpu_torch.api.policy import PropagationPolicy, PropagationSpec, ResourceSelector
    from karmada_tpu_torch.controlplane import ControlPlane
    from karmada_tpu_torch.utils.builders import duplicated_placement, new_cluster, new_deployment

    clock = PlaneClock()
    t0 = time.perf_counter()
    cp = ControlPlane(device=device, clock=clock, lease_grace_seconds=30.0)
    for w in cp.runtime.workers:
        w.MAX_RETRIES = w.POISON_TOLERANCE = 0
    cp.join_cluster(new_cluster("pusher", cpu="100", memory="200Gi"))
    for name in ("puller-a", "puller-b"):
        token = cp.authority.create_token().token
        if cp.authority.submit_csr(name, token) is None:
            raise AssertionError(f"pull plane: the authority refused {name}'s CSR")
        cluster = new_cluster(name, cpu="100", memory="200Gi")
        cluster.spec.sync_mode = "Pull"
        cp.join_cluster(cluster)
    cp.store.apply(new_deployment("app", replicas=2))
    cp.store.apply(PropagationPolicy(
        meta=ObjectMeta(name="p", namespace="default"),
        spec=PropagationSpec(resource_selectors=[ResourceSelector(api_version="apps/v1",
                                                                  kind="Deployment")],
                             placement=duplicated_placement())))
    wave = plane_wave("pull", cp, device, card, time.perf_counter() - t0)
    names = ("pusher", "puller-a", "puller-b")
    applied = [cp.members.get(n).get("apps/v1/Deployment", "default", "app") for n in names]
    report_ready(cp)
    cp.settle()
    ready_reps = cp.store.get("Resource", "default/app").status.get("readyReplicas")

    def ready(name):
        c = cp.store.get("Cluster", name)
        cond = next(x for x in c.status.conditions if x.type == "Ready")
        return cond.status, cond.reason, [t.key for t in c.spec.taints]

    cp.members.get("puller-b").reachable = False
    clock.now += 20
    cp.settle()
    within = ready("puller-b")
    clock.now += 20
    cp.settle()
    past = ready("puller-b")
    cp.members.get("puller-b").reachable = True
    clock.now += 5
    cp.settle()
    back = ready("puller-b")
    engine = cp.scheduler._engine
    ok = (all(a is not None and a.spec["replicas"] == 2 for a in applied)
          and set(cp.agents) == {"puller-a", "puller-b"} and ready_reps == 6
          and within[0] and not past[0] and past[1] == "AgentLeaseExpired"
          and "cluster.karmada.io/not-ready" in past[2] and back[:2] == (True, "AgentLeaseRenewed")
          and not back[2] and engine is not None and engine.device == device)
    plane_line("pull", wave, f"1 Push + 2 Pull members (tokens and CSRs through the "
               f"authority): agents applied {sum(a is not None for a in applied)} of 3, "
               f"template readyReplicas {ready_reps}; a stopped agent's cluster 20 s in "
               f"{within[:2]}, 40 s in {past[:2]} tainted {past[2]}, back {back[:2]}; "
               f"engine on {engine.device if engine is not None else None}", card)
    if not ok:
        raise AssertionError("pull plane: the agents, the lease or the engine's device are off")
    return wave


def check_shape_limits(device, card: str) -> dict:
    """The shapes past the kernels' old limits, served: K1 beyond the first
    slice's one grid (65535 blocks of 128 rows; grid.x now takes the rows),
    each of its three forms at 65535 x 128 + 1 rows equal to its plain
    version; an engine at 16,385 clusters (one past
    K2's old shared-memory sort) scheduling 2000 config-5 bindings through
    the fleet, every row against the numpy divider; a 17-dim quota
    wave (one past K12's old 16) on the fleet, its partition against
    ``admit_wave_np`` and its admitted rows against the numpy divider; and
    a 17-dim preemption wave (one past K15's old 16: ``preemption_scene``
    with 13 extended resources, 2000 residents x 500 clusters, a 100-row
    surge), one K15 launch, its victims and placements against
    ``preempt_and_place_np``. Returns each engine path's launches."""
    import torch
    from karmada_tpu_torch import ops

    rng = np.random.default_rng(SEED + 17)
    rows, c = 65535 * 128 + 1, 8
    with uncounted():
        t = to_device(estimate_batch(rng, rows, c), device)
        args = [t[k] for k in ("available_cap", "profiles", "prof_idx", "has_summary",
                               "replicas")]
        compare("estimate_merge past one grid", ops.estimate_merge(*args),
                ops.estimate_merge_ref(*args))
        profs = torch.from_numpy(rng.integers(0, 1 << 12, (rows, 4), dtype=np.int64)).to(device)
        targs = (t["available_cap"], profs, t["has_summary"])
        compare("profile_table past one grid", ops.profile_table(*targs),
                ops.profile_table_ref(*targs))
        del profs, targs
        table = ops.profile_table_ref(t["available_cap"], t["profiles"], t["has_summary"])
        extra = torch.from_numpy(rng.integers(-1, 300, (rows, c)).astype(np.int32)).to(device)
        margs = (table, t["prof_idx"], (extra,), t["replicas"])
        compare("estimate_merge_table past one grid", ops.estimate_merge_table(*margs),
                ops.estimate_merge_table_ref(*margs))
        del t, args, table, extra, margs
    torch.cuda.empty_cache()
    print(f"# K1 at {rows} rows (65535 x 128 + 1) x {c} clusters: estimate_merge, "
          f"profile_table and estimate_merge_table served, each equal to its plain "
          f"version; card {card}", flush=True)
    return check_wide_engines(device, card)


def check_wide_engines(device, card: str, clusters: int = 16_385, bindings: int = 2000,
                       quota_bindings: int = 2000, residents: int = 2000,
                       preempt_clusters: int = 500, surge: int = 100) -> dict:
    """The engine past K2's, K12's and K15's old limits
    (``check_shape_limits``); smaller sizes rehearse it on the CPU."""
    import karmada_tpu_torch
    from karmada_tpu_torch.scheduler import TensorScheduler

    out = {}
    on_card = device.type == "cuda"
    snap, problems = build_workload(karmada_tpu_torch, 5, bindings, clusters)
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    reset_counts()
    t0 = time.perf_counter()
    results = engine.schedule(problems)
    sync(device)
    wall = time.perf_counter() - t0
    out["wide fleet"] = {"launches": read_counts()}
    if engine._fleet is None:
        raise AssertionError(f"the {clusters}-cluster pass did not ride the fleet table")
    bad = oracle_check(engine, problems, results)
    print(f"# K2 at {snap.num_clusters} clusters: {len(problems)} bindings through the "
          f"fleet in {wall:.4f} s, {sum(r.success for r in results)} scheduled; "
          f"numpy-divider check {len(problems) - bad} ok / {bad} bad; launches "
          f"{ {k: v for k, v in out['wide fleet']['launches'].items() if v} }; card {card}",
          flush=True)
    if bad:
        raise AssertionError(f"{clusters} clusters: {bad} rows differ from the numpy divider")
    del engine, results
    snap, problems, quota = wide_quota_scene(karmada_tpu_torch, quota_bindings)
    engine = TensorScheduler(snap, chunk_size=4096, device=device)
    engine.set_quota(quota)
    rem0 = quota.remaining.copy()
    reset_counts()
    results = engine.schedule(problems)
    sync(device)
    out["wide quota"] = {"launches": read_counts()}
    admitted, denied, _ = check_partition(f"{len(quota.dims)}-dim quota", snap, problems,
                                          results, quota, rem0)
    checked, _ = check_admitted(f"{len(quota.dims)}-dim quota", engine, problems, results)
    if not admitted or not denied:
        raise AssertionError(f"{len(quota.dims)}-dim quota: {admitted} admitted, "
                             f"{denied} denied")
    if on_card and out["wide quota"]["launches"]["quota_admit"] != 1:
        raise AssertionError(f"{len(quota.dims)}-dim quota: K12 launched "
                             f"{out['wide quota']['launches']['quota_admit']} times")
    print(f"# K12 at {len(quota.dims)} dims: a {len(problems)}-row wave on the "
          f"{'fleet' if engine._fleet is not None else 'general'} route, {admitted} admitted, "
          f"{denied} denied, equal to admit_wave_np; {checked} admitted rows equal to the "
          f"numpy divider; card {card}", flush=True)
    del engine, results
    # run_preemption holds victims and placements to preempt_and_place_np and
    # requires one K15 launch on the card
    wide = run_preemption(device, card, residents=residents, clusters=preempt_clusters,
                          surge=surge, extra_dims=13)
    if wide["dims"] != 17:
        raise AssertionError(f"the wide preemption wave has {wide['dims']} dims, not 17")
    out["wide preemption"] = wide
    print(f"# K15 at {wide['dims']} dims: {wide['victims']} victims, {wide['placed']} placed, "
          f"equal to preempt_and_place_np; K15 launches "
          f"{wide['launches']['preempt_select']}; card {card}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card only",
              file=sys.stderr)
        return 1
    from karmada_tpu_torch import native
    from karmada_tpu_torch.native import fold

    global REFERENT_PROCESSES
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    REFERENT_PROCESSES = min(8, len(os.sched_getaffinity(0)))
    print(f"# card: {card}; torch {torch.__version__}; CUDA {torch.version.cuda}", flush=True)
    import launch_floors

    t0 = time.perf_counter()
    floors = launch_floors.start()  # the launch floors' nvcc beside the kernels'
    built = native.build()
    built["fold.c (g++)"] = fold.build()
    built.update(launch_floors.finish(floors))
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)

    rng = np.random.default_rng(SEED)
    stats, paths = {}, {}
    phase_walls = {}

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        phase_walls[name] = time.perf_counter() - t
        print(f"# phase {name}: {phase_walls[name]:.1f} s", flush=True)
        return out

    def kernels():
        # the main path's chunk (U = 9 profiles: the shared-table branch of
        # K1), then the 10k-cluster tier with U = 300 (K1's direct branch)
        def one(name, arrays, label):
            st = check_kernel(name, arrays, device)
            print(f"# kernel {name} {label}: exact; {st['ms']:.4f} ms (plain "
                  f"{st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms by "
                  f"{st['bound_by']}); card {card}", flush=True)
            return dict(st, library_ms=None)

        for b, c, u in ((4096, 5000, 9), (4096, 10_000, 300)):
            st = one("estimate_merge", estimate_batch(rng, b, c, u=u), f"{b}x{c}")
            if (b, c) == (4096, 5000):
                stats["estimate_merge"] = st
        # K2: the main path's chunk, the 10k tier, one past the old sort's
        # 16384 and a 40k-cluster row; then the selection's edge cases
        for b, c in ((4096, 5000), (4096, 10_000), (1024, 16_385), (256, 40_000)):
            arrays = divide_batch(rng, b, c)
            st = one("divide_replicas", arrays, f"{b}x{c}")
            if (b, c) == (4096, 5000):
                stats["divide_replicas"] = st
                t = to_device(arrays, device)
                k2_phase_split([t[k] for k in K2_ARGS], True, f"{b}x{c} seeded", card)
                del t
        for b, c in ((512, 5000), (64, 16_385), (16, 40_000), (64, 1), (64, 2)):
            one("divide_replicas", divide_edge_batch(rng, b, c), f"{b}x{c} edge cases")
        stats["profile_table"] = check_profile_table(device, card, rng)
        stats["estimate_merge_table"] = check_merge_table(rng, device, card)
        stats["first_fit_group"] = check_group_kernels(rng, device, card)
        # an estimator server's batch: 4096 profile rows x 5000 nodes (the
        # Kubernetes node limit), prefilter mask included
        stats["node_sum_estimate"] = check_node_sum(node_batch(rng, 4096, 5000), device,
                                                    card, "4096x5000")
        check_node_sum(node_batch(rng, 8, 4000), device, card, "8x4000 seeded")
        check_node_edges(device, card)
        stats.update(check_quota_kernels(rng, device, card))
        check_caps_edges(device, card)
        check_estimate_edges(device, card)
        check_scatter_edges(device, card)
        check_model_edges(device, card)
        stats["explain_pass"] = check_explain_kernel(rng, device, card)
        check_explain_edges(device, card)
        t = preempt_batch(rng, device)
        stats["preempt_select"] = check_preempt_kernel(t, card, "131072 x 5000 seeded")
        del t
        # past the 16 dims the parent K15 refused, on its own draws
        t = preempt_batch(np.random.default_rng(SEED + 17), device, r=17)
        check_preempt_kernel(t, card, "131072 x 5000 seeded, 17 dims")
        del t
        check_preempt_edges(device, card)
        check_fleet_edges(device, card)
        check_wire_edges(device, card)

    def configs():
        for cfg in (1, 2, 3, 4):
            st = run_config(cfg, device, card)
            if cfg == 3 and any(st["launches"].values()):
                raise AssertionError(f"config 3 launched kernels: {st['launches']}")

    def storm():
        out = run_fleet_storm(device, card)
        stats.update(out["stats"])
        require_launched("config 5 fleet", out["launches"])
        paths["storm"] = out

    def explain_fleet():
        storm = paths["storm"]
        out = run_explain_fleet(device, card, storm.pop("engine"), storm.pop("problems"))
        require_launched("explain fleet", out["launches"])
        paths["explain fleet"] = {k: out[k] for k in ("launches", "wall", "off_s")}

    def legacy():
        # the dense storm's problems and drift sequence at a dense budget of
        # 0; two steady and two churn passes (three on the dense storm), the
        # traced pass on the dense storm's last snapshot. Its cold and last
        # passes equal the dense storm's numpy-checked ones row by row and
        # are not solved by the divider again: depth cut to keep the whole
        # smoke near half its time limit
        out = run_fleet_storm(device, card, steady=2, churn=2, legacy=True,
                              reference=paths["storm"]["digests"])
        stats.update(out["stats"])
        require_launched("config 5 legacy", out["launches"])
        want = out["chunks"] * (out["passes"] + out["reruns_total"])
        if out["launches"]["entry_diff"] != want:
            raise AssertionError(f"config 5 legacy: {out['launches']['entry_diff']} K16 "
                                 f"launches, expected {want}")
        print(f"# config 5 legacy: overflow reruns by churn pass {out['reruns']} "
              f"({out['reruns_total']} in all); K16 launches {want} "
              f"({out['chunks']} a pass); last breakdown {out['breakdown']}", flush=True)
        out.pop("engine"), out.pop("problems")
        paths["legacy"] = out

    def mixed():
        out = run_mixed(device, card)
        require_launched("mixed fleet", out["launches"])
        paths["mixed"] = out

    def mixed_legacy():
        out = run_mixed(device, card, legacy=True, reference=paths["mixed"]["digests"])
        require_launched("mixed fleet legacy", out["launches"])
        paths["mixed legacy"] = out

    def general():
        out = run_general(device, card, paths["storm"]["cold_out"], rows=40_000)
        require_launched("config 5 general", out["launches"])
        paths["general"] = out

    def sidecar():
        out = run_sidecar(device, card, paths["storm"]["digests"])
        require_launched("sidecar", out["launches"])
        paths["sidecar"] = out

    def sidecar_estimator():
        est = paths["estimator"]
        try:
            out = run_sidecar_estimator(device, card, est)
        finally:
            for k in ("caches", "snap", "problems", "pod_events"):
                est.pop(k)
        require_launched("sidecar estimator", out["launches"])
        paths["sidecar estimator"] = out

    def sidecar_controller():
        out = run_sidecar_controller(device, card)
        for wave in ("cold wave", "fallback wave"):
            require_launched("sidecar controller", out["launches"][wave])
        paths["sidecar controller"] = out

    def models():
        # two steady and two churn passes (three on the plain storm): depth cut
        # to keep the whole smoke near half its time limit
        out = run_fleet_storm(device, card, steady=2, churn=2, models=True)
        stats.update(out["stats"])
        require_launched("config 5 models fleet", out["launches"])
        paths["models"] = out
        out = run_general_models(device, card)
        require_launched("config 5 models general", out["launches"])
        paths["models general"] = out

    def estimator():
        out = run_estimator(device, card)
        require_launched("estimator", out["launches"])
        paths["estimator"] = out

    def quota():
        out = run_quota(device, card)
        require_launched("quota fleet", out["launches"])
        require_launched("quota general", out["general_launches"])
        stats["quota_caps_fold"] = out["fold_stats"]
        require_launched("explain quota", out["explain"]["launches"])
        paths["quota"] = out
        paths["quota general"] = {"launches": out["general_launches"]}
        paths["explain quota"] = out["explain"]

    def ranked():
        out = run_ranked(device, card)
        require_launched("ranked", out["launches"])
        paths["ranked"] = out

    def preemption():
        out = run_preemption(device, card)
        require_launched("preemption", out["launches"])
        paths["preemption"] = out

    def controller():
        out = run_controller(device, card)
        require_launched("controller cold", out["cold_launches"])
        require_launched("controller quota", out["quota_launches"])
        require_launched("controller preemption", out["preempt_launches"])
        paths["controller"] = out

    def plane():
        out = run_plane(device, card)
        require_launched("plane cold", out["cold_launches"])
        require_launched("plane failover", out["failover_launches"])
        require_launched("plane deschedule", out["deschedule_launches"])
        require_launched("plane autoscale up", out["up_launches"])
        require_launched("plane autoscale down", out["down_launches"])
        require_launched("plane cron", out["cron_launches"])
        require_launched("plane resume drift round", out["resume_launches"])
        paths["plane"] = out

    def limits():
        out = check_shape_limits(device, card)
        require_launched("wide fleet", out["wide fleet"]["launches"])
        require_launched("wide quota", out["wide quota"]["launches"])
        require_launched("wide preemption", out["wide preemption"]["launches"])
        paths.update(out)

    for name, fn in (("kernels", kernels), ("limits", limits),
                     ("configs", configs), ("storm", storm),
                     ("explain fleet", explain_fleet), ("legacy", legacy), ("mixed", mixed),
                     ("mixed legacy", mixed_legacy), ("general", general),
                     ("sidecar", sidecar), ("models", models), ("estimator", estimator),
                     ("sidecar estimator", sidecar_estimator),
                     ("sidecar controller", sidecar_controller),
                     ("quota", quota), ("ranked", ranked), ("preemption", preemption),
                     ("controller", controller), ("plane", plane)):
        phase(name, fn)

    # launches: each kernel's count on the path that drives it
    where = {
        "estimate_merge": ("general", "config 5 general path"),
        "fleet_bits": ("mixed", "mixed fleet phase"),
        "scatter_rows": ("mixed", "mixed fleet phase"),
        "model_overlay": ("models", "config 5 fleet passes under default models"),
        "estimate_merge_table": ("models general",
                                 "config 5 general pass under default models"),
        "node_sum_estimate": ("estimator", "estimator phase, cold pass"),
        "quota_admit": ("quota", "quota phase, fleet passes (cold, steady replay, "
                                 "surge, raise, delta)"),
        "quota_caps_fold": ("quota", "quota phase, fleet passes (table rebuilds)"),
        "quota_cluster_caps": ("quota general", "quota phase, general-route pass"),
        "explain_pass": ("explain fleet", "explain fleet phase, the armed steady pass"),
        "preempt_select": ("preemption", "preemption phase, the surge pass"),
        "entry_diff": ("legacy", "config 5 legacy passes"),
        "first_fit_group": ("ranked", "ranked phase pass"),
    }
    print(f"# estimator K8 launches by pass: {paths['estimator']['k8']}", flush=True)
    print(f"# quota K12 launches by pass: {paths['quota']['k12']}", flush=True)
    print(f"# K14 launches: explain fleet {paths['explain fleet']['launches']['explain_pass']}"
          f", explain quota {paths['explain quota']['launches']['explain_pass']}; K15 "
          f"launches: preemption surge {paths['preemption']['launches']['preempt_select']}"
          f"; K17 launches: ranked pass {paths['ranked']['launches']['first_fit_group']}, "
          f"preemption surge {paths['preemption']['launches']['first_fit_group']}",
          flush=True)
    print("# phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_walls.items()),
          flush=True)
    side, side_est = paths["sidecar"], paths["sidecar estimator"]
    print("# sidecar request splits (s): " + "; ".join(
        f"{tag} {side['walls'][tag]:.4f} = {split_line(split)}"
        for tag, split in side["splits"].items())
        + "; sidecar estimator passes: " + "; ".join(
        f"{kind} {side_est['walls'][kind]:.4f} = {split_line(split)}"
        for kind, split in side_est["splits"].items()), flush=True)
    print("# sidecar launches (config 5 through SolverService's core): "
          + ", ".join(f"{k} {v}" for k, v in side["launches"].items() if v)
          + "; request walls " + ", ".join(f"{k} {w:.4f} s" for k, w in side["walls"].items())
          + f"; sidecar estimator K8 by pass {paths['sidecar estimator']['k8']}, RPCs by "
          f"pass {paths['sidecar estimator']['rpcs']}; sidecar controller waves "
          + ", ".join(f"{k} {w['apply_s'] + w['wall']:.2f} s"
                      for k, w in paths["sidecar controller"]["waves"].items()), flush=True)
    ctl = paths["controller"]
    print("# controller launches (through SchedulerController): cold wave "
          + ", ".join(f"{k} {ctl['cold_launches'][k]}"
                      for k in ("fleet_masks", "divide_replicas", "fleet_diff", "fleet_wire"))
          + f"; quota wave quota_admit {ctl['quota_launches']['quota_admit']}; preemption "
          f"surge preempt_select {ctl['preempt_launches']['preempt_select']}", flush=True)
    plane = paths["plane"]
    print("# plane launches (through ControlPlane): cold wave "
          + ", ".join(f"{k} {v}" for k, v in plane["cold_launches"].items() if v)
          + "; scale wave "
          + ", ".join(f"{k} {v}" for k, v in plane["scale_launches"].items() if v)
          + "; failover wave "
          + ", ".join(f"{k} {v}" for k, v in plane["failover_launches"].items() if v)
          + "; descheduler wave "
          + ", ".join(f"{k} {v}" for k, v in plane["deschedule_launches"].items() if v)
          + "".join(f"; {tag} " + ", ".join(f"{k} {v}" for k, v in plane[key].items() if v)
                    for tag, key in (("autoscale up", "up_launches"),
                                     ("autoscale down", "down_launches"),
                                     ("cron", "cron_launches"),
                                     ("resume drift round", "resume_launches")))
          + "; wave walls " + ", ".join(
              f"{k} {w['apply_s'] + w['wall']:.2f} s" for k, w in plane["waves"].items()),
          flush=True)
    entries = []
    for name in KERNELS:
        key, on = where.get(name, ("storm", "config 5 fleet passes"))
        launches = paths[key]["launches"][name]
        entries.append({
            "name": name, "route": KERNELS[name][0], "source": KERNELS[name][1],
            "replaces": KERNELS[name][2], "launches": launches, "launches_on": on,
            **{k: stats[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}})
    print(json.dumps({"kernels": entries}))
    print(f"# total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
