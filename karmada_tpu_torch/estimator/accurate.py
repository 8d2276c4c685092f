"""Accurate estimator: node-level MaxAvailableReplicas per member cluster.

Counterpart of ``karmada_tpu/estimator/accurate.py``, in-process route only.
The analogue of the karmada-scheduler-estimator server (ref:
pkg/estimator/server/estimate.go:59-112): one estimator instance per member
cluster watches that cluster's nodes/pods and answers
``max available = sum over matching nodes of min_dim((allocatable -
requested) // request)`` with a node-affinity + toleration prefilter and the
allowed-pod headroom per node.

Each cluster's node state packs into ``[N, R]`` arrays; a request batch
evaluates as one ``[B, N]`` node sum per cluster: the numpy mirror below
``_NP_ESTIMATE_CELLS`` cells (the JAX package's own rule), the hand-written
kernel K8 (``csrc/node_sum.cu``, ``node_sum_estimate``) above it. The
scheduler side (``EstimatorRegistry``) fans out over estimators and
memoizes their answers under a generation gate; ``make_batch_estimator``
plugs it into ``TensorScheduler(extra_estimators=...)``.

Not ported yet: the gRPC transport (``estimator/service.py``,
``grpc_transport.py``, ``RemoteAccurateEstimator``). A registered estimator
that carries a ``conn`` raises ``NotImplementedError``. As in the JAX
registry, an exception raised by one estimator's fetch makes that cluster
answer -1 (no answer) for this pass, unmemoized, so the next pass asks it
again; the batch estimator's ``unanswered`` set names such clusters, and a
caller that must know every cluster answered (a kernel that failed to build
or launch reads as "no answer") checks it.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..api.work import ReplicaRequirements

UNAUTHENTIC = -1


@dataclass
class NodeState:
    """One member node (canonical int units)."""

    name: str
    allocatable: dict[str, int] = field(default_factory=dict)
    requested: dict[str, int] = field(default_factory=dict)  # sum of pod requests
    labels: dict[str, str] = field(default_factory=dict)
    taints: list = field(default_factory=list)  # api.cluster.Taint
    num_pods: int = 0


#: NodeSnapshot generation source: every instance gets a fresh, monotonic
#: generation so a snapshot swap always reads as movement to the generation
#: gate; offset far above any NodeCache event count so the two generation
#: spaces never collide for one cluster across a cache<->snapshot swap
_SNAPSHOT_GEN = itertools.count(1 << 32)


class NodeSnapshot:
    """Packed node arrays for one cluster (ref: the lifted kube-scheduler
    NodeInfo snapshot, pkg/util/lifted/scheduler/cache)."""

    def __init__(self, nodes: Sequence[NodeState], dims: Sequence[str]):
        self.nodes = list(nodes)
        self.dims = list(dims)
        self.generation = next(_SNAPSHOT_GEN)
        n, r = len(nodes), len(dims)
        self.available = np.zeros((n, r), np.int64)
        pods_dim = self.dims.index("pods") if "pods" in self.dims else None
        for i, node in enumerate(nodes):
            for j, d in enumerate(self.dims):
                self.available[i, j] = node.allocatable.get(d, 0) - node.requested.get(
                    d, 0
                )
            if pods_dim is not None:
                # allowed pods = allocatable pods - running pods
                # (server/estimate.go:104-112)
                self.available[i, pods_dim] = max(
                    node.allocatable.get("pods", 0) - node.num_pods, 0
                )


class NodeCache:
    """Incrementally-maintained node state for one member cluster.

    Ref: pkg/util/lifted/scheduler/cache/cache.go (AddPod/RemovePod/
    AddNode/RemoveNode/UpdateNode) + server/estimate.go:59-102. Packed rows
    are mutated in place: O(R) per event, stable row ids (a freed row is
    recycled), and the estimator reads the live arrays. Duck-type
    compatible with ``NodeSnapshot`` (``nodes`` / ``dims`` / ``available``
    / ``generation``), so ``AccurateEstimator`` takes either."""

    def __init__(self, dims: Sequence[str], nodes: Sequence[NodeState] = ()):
        self.dims = list(dims)
        self._pods_dim = (
            self.dims.index("pods") if "pods" in self.dims else None
        )
        self.nodes: list[Optional[NodeState]] = []
        self.available = np.zeros((0, len(self.dims)), np.int64)
        self._rows: dict[str, int] = {}
        self._free: list[int] = []
        self.generation = 0
        for node in nodes:
            self.upsert_node(node)

    def _pack_row(self, i: int, node: NodeState) -> None:
        for j, d in enumerate(self.dims):
            self.available[i, j] = (
                node.allocatable.get(d, 0) - node.requested.get(d, 0)
            )
        if self._pods_dim is not None:
            self.available[i, self._pods_dim] = max(
                node.allocatable.get("pods", 0) - node.num_pods, 0
            )

    def upsert_node(self, node: NodeState) -> None:
        row = self._rows.get(node.name)
        if row is None:
            if self._free:
                row = self._free.pop()
            else:
                row = len(self.nodes)
                self.nodes.append(None)
                if row >= self.available.shape[0]:
                    grown = np.zeros(
                        (max(16, 2 * self.available.shape[0]), len(self.dims)),
                        np.int64,
                    )
                    grown[: self.available.shape[0]] = self.available
                    self.available = grown
            self._rows[node.name] = row
        self.nodes[row] = node
        self._pack_row(row, node)
        self.generation += 1

    def remove_node(self, name: str) -> None:
        row = self._rows.pop(name, None)
        if row is None:
            return
        self.nodes[row] = None
        self.available[row] = 0  # zero rows contribute zero replicas
        self._free.append(row)
        self.generation += 1

    def add_pod(self, node_name: str, requests: Mapping[str, int]) -> None:
        """A pod scheduled onto the node: its requests reduce the node's
        headroom and occupy one pod slot (cache.go AddPod)."""
        row = self._rows.get(node_name)
        if row is None:
            return
        node = self.nodes[row]
        for d, q in requests.items():
            node.requested[d] = node.requested.get(d, 0) + q
        node.num_pods += 1
        self._pack_row(row, node)
        self.generation += 1

    def remove_pod(self, node_name: str, requests: Mapping[str, int]) -> None:
        row = self._rows.get(node_name)
        if row is None:
            return
        node = self.nodes[row]
        for d, q in requests.items():
            node.requested[d] = node.requested.get(d, 0) - q
        node.num_pods = max(0, node.num_pods - 1)
        self._pack_row(row, node)
        self.generation += 1

    def live_nodes(self) -> list[NodeState]:
        return [n for n in self.nodes if n is not None]


def _node_sum_estimate_np(node_avail, node_ok, requests):
    """numpy mirror of the node-sum estimate (the JAX ``_node_sum_kernel``
    over numpy): min over requested dims of floor(avail / request) per
    node, summed over prefilter-passing nodes, int32-clamped. Small
    problems take it instead of a kernel launch."""
    avail = np.maximum(node_avail, 0)
    per_node = np.full((requests.shape[0], avail.shape[0]), np.int64(2**62))
    for r in range(requests.shape[-1]):
        req_r = requests[:, r][:, None]
        ratio = avail[None, :, r] // np.maximum(req_r, 1)
        per_node = np.where(req_r > 0, np.minimum(per_node, ratio), per_node)
    per_node = np.where(per_node >= 2**62, 0, per_node)  # no requested dims
    total = np.sum(np.where(node_ok, per_node, 0), axis=1)
    return np.minimum(total, np.int64(2**31 - 1)).astype(np.int32)


def node_sum_estimate_ref(
    node_avail: torch.Tensor,  # int64[N, R]
    node_ok: torch.Tensor,  # bool[B, N]
    requests: torch.Tensor,  # int64[B, R]
) -> torch.Tensor:
    """Plain torch version of K8: int32[B] node-sum estimate, the JAX
    ``_node_sum_kernel`` (karmada_tpu/estimator/accurate.py:226). The int64
    sum wraps, as in the JAX program."""
    avail = node_avail.to(torch.int64).clamp_min(0)
    requests = requests.to(torch.int64)
    per_node = torch.full(
        (requests.shape[0], avail.shape[0]), 2**62, dtype=torch.int64,
        device=avail.device,
    )
    for r in range(requests.shape[-1]):
        req_r = requests[:, r : r + 1]
        # both operands are non-negative here, so floor == truncation
        ratio = torch.div(avail[None, :, r], req_r.clamp_min(1), rounding_mode="floor")
        per_node = torch.where(req_r > 0, torch.minimum(per_node, ratio), per_node)
    per_node = torch.where(per_node >= 2**62, 0, per_node)  # no requested dims
    total = torch.where(node_ok, per_node, 0).sum(dim=1)
    return total.clamp_max(2**31 - 1).to(torch.int32)


def node_sum_estimate(
    node_avail: torch.Tensor,
    node_ok: torch.Tensor,
    requests: torch.Tensor,
) -> torch.Tensor:
    """K8: ``node_sum_estimate_ref`` as one kernel launch.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``node_sum_estimate.launches`` counts kernel launches."""
    args = (node_avail, node_ok, requests)
    if native.on_cpu(args):
        return node_sum_estimate_ref(*args)
    native.check(
        "node_sum", node_avail=(node_avail, torch.int64),
        node_ok=(node_ok, torch.bool), requests=(requests, torch.int64))
    n, r = node_avail.shape
    b = requests.shape[0]
    if requests.shape[1] != r or node_ok.shape != (b, n):
        raise ValueError("node_sum: inconsistent shapes")
    out = torch.empty((b,), dtype=torch.int32, device=node_avail.device)
    if b:
        native.launch(node_sum_estimate, "node_sum", "node_sum_launch",
                      node_avail.device, node_avail, n, r, node_ok, requests,
                      b, out)
    return out


node_sum_estimate.launches = 0


#: below this B x N footprint the numpy mirror answers instead of a kernel
#: launch (the JAX package's rule, accurate.py:261)
_NP_ESTIMATE_CELLS = 1 << 14


class ResourceQuotaPlugin:
    """Estimate plugin capping replicas by namespace ResourceQuota headroom
    (ref: estimator server mini plugin framework,
    server/framework/interface.go + plugins/resourcequota/resourcequota.go,
    gated by the ResourceQuotaEstimate feature).

    ``quotas`` maps namespace -> {resource: remaining} (canonical units)."""

    def __init__(self, quotas: Optional[dict[str, dict[str, int]]] = None):
        self.quotas = quotas or {}

    def estimate(
        self, namespace: str, requirements: Optional[ReplicaRequirements]
    ) -> Optional[int]:
        """Max replicas the namespace quota still admits; None = no opinion."""
        quota = self.quotas.get(namespace)
        if quota is None or requirements is None:
            return None
        best: Optional[int] = None
        for res, req in requirements.resource_request.items():
            if req <= 0 or res not in quota:
                continue
            fit = max(quota[res], 0) // req
            best = fit if best is None else min(best, fit)
        return best


class AccurateEstimator:
    """Per-cluster node-level estimator service object. ``device`` is where
    the node sum runs above the host rule (default the card)."""

    def __init__(
        self,
        cluster_name: str,
        snapshot: NodeSnapshot,
        quota_plugin: Optional[ResourceQuotaPlugin] = None,
        device: str | torch.device = "cuda",
    ):
        self.cluster_name = cluster_name
        self.snapshot = snapshot
        self.quota_plugin = quota_plugin
        self.device = torch.device(device)
        # unschedulable replicas per workload key (fed by the member watcher;
        # ref: server/replica/replica.go:43-77)
        self.unschedulable: dict[str, int] = {}

    def _node_prefilter(
        self, requirements: Optional[ReplicaRequirements]
    ) -> np.ndarray:
        nodes = self.snapshot.nodes
        ok = np.ones(len(nodes), bool)
        if requirements is None or requirements.node_claim is None:
            return ok
        from ..api.cluster import NO_EXECUTE, NO_SCHEDULE, Toleration

        claim = requirements.node_claim
        tolerations = [
            t if isinstance(t, Toleration) else Toleration(**t)
            for t in claim.tolerations
        ]
        for i, node in enumerate(nodes):
            if node is None:  # NodeCache hole (removed node)
                ok[i] = False
                continue
            if claim.node_selector:
                if any(node.labels.get(k) != v for k, v in claim.node_selector.items()):
                    ok[i] = False
                    continue
            if node.taints:
                untolerated = any(
                    t.effect in (NO_SCHEDULE, NO_EXECUTE)
                    and not any(tol.tolerates(t) for tol in tolerations)
                    for t in node.taints
                )
                if untolerated:
                    ok[i] = False
        return ok

    def max_available_replicas(
        self,
        requirements: Optional[ReplicaRequirements],
        requests_batch: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """int32[B] for a request batch sharing one node_claim. When
        ``requests_batch`` is None a single row is built from
        ``requirements.resource_request``."""
        if len(self.snapshot.nodes) == 0:
            return np.zeros(
                1 if requests_batch is None else len(requests_batch), np.int32
            )
        if requests_batch is None:
            req = np.zeros((1, len(self.snapshot.dims)), np.int64)
            if requirements is not None:
                for j, d in enumerate(self.snapshot.dims):
                    req[0, j] = requirements.resource_request.get(d, 0)
        else:
            req = np.asarray(requests_batch, np.int64)
        n = len(self.snapshot.nodes)
        node_ok = np.broadcast_to(
            self._node_prefilter(requirements)[None, :], (len(req), n)
        )
        # trim to the row count: a NodeCache over-allocates
        avail = np.asarray(self.snapshot.available[:n])
        if len(req) * n <= _NP_ESTIMATE_CELLS:
            out = _node_sum_estimate_np(avail, node_ok, req)
        else:
            # each call uploads its own inputs and reads its result back
            # before it returns: the registry calls this from pool threads
            dev = self.device

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            out = node_sum_estimate(up(avail), up(node_ok), up(req)).cpu().numpy()
        # quota plugin caps the node-sum estimate (server/estimate.go:98-101,
        # RunEstimateReplicasPlugins min-merge), feature-gated
        from ..utils.features import RESOURCE_QUOTA_ESTIMATE, feature_gate

        if (
            self.quota_plugin is not None
            and requirements is not None
            and feature_gate.enabled(RESOURCE_QUOTA_ESTIMATE)
        ):
            cap = self.quota_plugin.estimate(requirements.namespace, requirements)
            if cap is not None:
                out = np.minimum(out, np.int32(cap))
        return out

    def get_unschedulable_replicas(self, workload_key: str) -> int:
        """Ref: server GetUnschedulableReplicas; counts come from the member
        watcher's pod conditions."""
        return self.unschedulable.get(workload_key, 0)


class EstimatorRegistry:
    """Scheduler-side estimator fan-out (ref: client/accurate.go:33-68 — the
    per-cluster estimator cache + concurrent fan-out), batch-native and
    delta-aware, over in-process estimators.

    Estimates memoize per (cluster, unique request profile) and are GATED
    by the owning estimator's snapshot generation: ``invalidate()`` marks
    every cluster unconfirmed, and the next pass re-confirms them by
    reading each estimator's generation; only clusters whose generation
    actually advanced re-pay the profile fan-out."""

    def __init__(self) -> None:
        self._by_cluster: dict[str, AccurateEstimator] = {}
        self._pool = None
        # wall seconds spent in estimator fan-outs since construction
        self.fanout_seconds_total = 0.0
        # memoized answers, one scalar per (cluster, profile bytes); the
        # profile key is positional over the engine snapshot's dims, so one
        # registry serves one dims universe at a time
        self._memo: dict[tuple[str, bytes], int] = {}
        # last generation each cluster's memo entries were computed at
        self._gen: dict[str, int] = {}
        # clusters whose memo is trusted until the next invalidate()
        self._confirmed: set[str] = set()
        # live RPCs issued, by kind: the in-process route issues none (the
        # wire route is not ported); kept for the JAX registry's surface
        self.rpc_counts: dict[str, int] = {"batch": 0, "unary": 0, "ping": 0}
        # memo-content version: bumped whenever an entry is written or
        # dropped; confirm_token() returns it
        self._epoch = 0

    def register(self, est: AccurateEstimator) -> None:
        if getattr(est, "conn", None) is not None:
            raise NotImplementedError(
                "remote estimators (the gRPC transport, karmada_tpu "
                "estimator/grpc_transport.py) are not ported to "
                "karmada_tpu_torch yet; register an in-process "
                "AccurateEstimator"
            )
        self._by_cluster[est.cluster_name] = est
        # a (re)registered estimator invalidates exactly its own cluster's
        # memo — columns are keyed by name, so other members keep theirs
        self._drop_cluster(est.cluster_name)

    def deregister(self, cluster_name: str) -> None:
        self._by_cluster.pop(cluster_name, None)
        self._drop_cluster(cluster_name)

    def _drop_cluster(self, name: str) -> None:
        self._gen.pop(name, None)
        self._confirmed.discard(name)
        self._epoch += 1
        for key in [k for k in self._memo if k[0] == name]:
            del self._memo[key]

    def get(self, cluster_name: str) -> Optional[AccurateEstimator]:
        return self._by_cluster.get(cluster_name)

    def invalidate(self, drop: bool = False) -> None:
        """Mark memoized estimates stale. The default is GENERATION-GATED:
        memo entries survive, and the next pass re-confirms each cluster's
        snapshot generation — a no-movement refresh never touches the
        profile fan-out. ``drop=True`` is the hard form: forget everything
        and re-pay the full fan-out next pass."""
        self._confirmed.clear()
        if drop:
            self._memo.clear()
            self._gen.clear()
            self._epoch += 1

    def make_batch_estimator(
        self,
        cluster_names: Sequence[str],
        *,
        max_workers: int = 64,
        timeout_seconds: Optional[float] = None,
    ):
        """Adapter for TensorScheduler.extra_estimators: returns
        fn(requests[B,R], replicas[B]) -> int32[B,C] numpy with -1 where no
        estimator serves the cluster. The arguments may be tensors on any
        device or numpy arrays.

        Fan-out is CONCURRENT under one shared deadline
        (client/accurate.go:139-162), one task per cluster to fetch. A
        cluster missing the deadline answers UnauthenticReplica (-1) for
        this pass, so the min-merge ignores it instead of blocking
        scheduling; its late result is discarded. ``fn.unanswered`` holds
        the registered clusters the last pass answered -1 for."""
        names = list(cluster_names)
        # registered clusters the LAST estimate pass answered -1 for: such a
        # pass is degraded and must never be replayed by the scheduler's
        # batch-identity fast path
        unanswered: set = set()

        def estimate(requests, replicas) -> np.ndarray:
            reqs, reps = _host(requests), _host(replicas)
            out = np.full((len(reqs), len(names)), UNAUTHENTIC, np.int32)
            # zero-replica rows (the engine's power-of-two PAD rows, plus
            # real scale-to-zero bindings) never need a live answer
            live = reps > 0
            if not live.any():
                return out
            uniq, inv = np.unique(reqs[live], axis=0, return_inverse=True)
            prof_keys = [row.tobytes() for row in uniq]
            self._refresh(names, uniq, prof_keys, max_workers, timeout_seconds)
            table = np.full((len(uniq), len(names)), UNAUTHENTIC, np.int32)
            memo = self._memo
            unanswered.clear()
            for ci, name in enumerate(names):
                # clusters with no registered estimator answer -1
                # STRUCTURALLY; unconfirmed clusters answer -1 for this
                # pass only
                if name not in self._confirmed:
                    if name in self._by_cluster:
                        unanswered.add(name)
                    continue
                for u, key in enumerate(prof_keys):
                    val = memo.get((name, key))
                    if val is not None:
                        table[u, ci] = val
                    else:
                        unanswered.add(name)
            out[live] = table[inv.reshape(-1)]
            return out

        def refresh_token():
            # the scheduler's batch-identity fast path probes this before
            # replaying a pass: an unchanged token iff no memo content moved
            # AND the last pass answered every registered cluster
            token = self.confirm_token(names)
            if token is None or unanswered:
                return None
            return token

        estimate.refresh_token = refresh_token
        estimate.unanswered = unanswered
        return estimate

    # -- refresh machinery (generation confirmation + fan-out) -------------

    def _refresh(
        self,
        names: Sequence[str],
        uniq: np.ndarray,
        prof_keys: Sequence[bytes],
        max_workers: int,
        timeout_seconds: Optional[float],
    ) -> None:
        """Bring every (cluster, profile) memo cell either up to date or
        provably unanswerable for this pass. Mutates memo/generation state
        only on the calling thread — pool tasks just return data."""
        import time as _time

        t0 = _time.perf_counter()
        deadline = None if timeout_seconds is None else t0 + timeout_seconds

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(deadline - _time.perf_counter(), 0.0)

        self._confirm_generations(names)
        fetch: list = []  # (name, est)
        for name in names:
            est = self._by_cluster.get(name)
            if est is None:
                continue
            if name in self._confirmed and all(
                (name, k) in self._memo for k in prof_keys
            ):
                continue
            fetch.append((name, est))
        if fetch:
            self._fetch(fetch, uniq, prof_keys, max_workers, remaining)
            self.fanout_seconds_total += _time.perf_counter() - t0

    def _confirm_generations(self, names: Sequence[str]) -> None:
        """Confirm every unconfirmed cluster's snapshot generation by a
        direct read; a cluster whose generation moved drops its memo (the
        fetch re-queries it)."""
        for name in names:
            if name in self._confirmed:
                continue
            est = self._by_cluster.get(name)
            if est is None:
                continue
            gen = int(getattr(est.snapshot, "generation", 0))
            if self._gen.get(name) != gen:
                self._drop_cluster(name)
                self._gen[name] = gen
            self._confirmed.add(name)

    def confirm_token(self, cluster_names: Sequence[str]):
        """Prove the estimator contribution to a scheduling batch unchanged:
        confirm every registered cluster's snapshot generation and return
        an opaque token that is EQUAL to a previous token iff no memo
        content changed in between."""
        names = list(cluster_names)
        self._confirm_generations(names)
        if all(
            name in self._confirmed
            for name in names
            if name in self._by_cluster
        ):
            return (self._epoch,)
        return None

    def _ensure_pool(self, max_workers: int):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers)
        return self._pool

    def _fetch(self, fetch, uniq, prof_keys, max_workers, remaining) -> None:
        """One task per cluster to fetch, over the profile columns some
        fetched cluster is missing. Results merge on the calling thread: a
        cluster that answered memoizes regardless of any other (per-column
        completeness). A fetch that raises answers -1 this pass and is not
        memoized, as in the JAX registry."""
        from concurrent.futures import wait as _fwait

        pool = self._ensure_pool(max_workers)
        # an unconfirmed cluster cannot trust ANY memo entry, so it needs
        # the full matrix; confirmed clusters only their missing columns
        miss_idx: set = set()
        for name, _est in fetch:
            if name not in self._confirmed:
                miss_idx = set(range(len(prof_keys)))
                break
            miss_idx.update(
                u for u, k in enumerate(prof_keys) if (name, k) not in self._memo
            )
        order = sorted(miss_idx)
        sub_uniq = np.asarray(uniq)[order]
        sub_keys = [prof_keys[u] for u in order]

        def fetch_single(est):
            # generation read BEFORE computing so a concurrent member event
            # makes the answer look stale
            gen = int(getattr(est.snapshot, "generation", 0))
            return (
                np.asarray(est.max_available_replicas(None, sub_uniq), np.int32),
                gen,
            )

        futs = {pool.submit(fetch_single, est): name for name, est in fetch}
        done, not_done = _fwait(futs, timeout=remaining())
        for f in not_done:
            # a straggler answers -1 this pass only (it stays unmemoized)
            f.cancel()
        for f in done:
            try:
                vals, gen = f.result()
            except Exception:  # noqa: BLE001 — a failed fetch = -1 this pass
                logging.getLogger("karmada_tpu_torch").warning(
                    "estimator fetch for cluster %s failed; it answers -1 this "
                    "pass", futs[f], exc_info=True)
                continue
            if vals.min(initial=0) < 0:
                # a negative (wrapped) answer is never memoized, as in the
                # JAX registry
                continue
            self._memoize(futs[f], sub_keys, vals, gen)

    def _memoize(self, name, prof_keys, values, gen) -> None:
        if gen is not None and self._gen.get(name) not in (None, int(gen)):
            # the snapshot moved between our last fetch and this partial
            # one: entries OUTSIDE this response are at the old generation
            self._drop_cluster(name)
        self._epoch += 1
        for key, val in zip(prof_keys, values):
            self._memo[(name, key)] = int(val)
        if gen is not None:
            self._gen[name] = int(gen)
        else:
            self._gen.pop(name, None)
        self._confirmed.add(name)


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
