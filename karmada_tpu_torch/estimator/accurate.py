"""Accurate estimator: node-level MaxAvailableReplicas per member cluster.

Counterpart of ``karmada_tpu/estimator/accurate.py``.
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

The registry serves in-process estimators and remote ones alike: an
estimator that carries a ``conn`` (``grpc_transport.RemoteAccurateEstimator``
over a ``GrpcEstimatorConnection``, or over the in-process
``service.EstimatorConnection``) is confirmed with one ``GetGenerations``
ping per server connection and fetched with one
``MaxAvailableReplicasBatch`` per server, and an old server (UNIMPLEMENTED)
falls back to pipelined per-profile unary calls; ``rpc_counts`` counts that
traffic. As in the JAX registry, an exception raised by one estimator's
fetch makes that cluster answer -1 (no answer) for this pass, unmemoized,
so the next pass asks it again; the batch estimator's ``unanswered`` set
names such clusters, and a caller that must know every cluster answered (a
kernel that failed to build or launch reads as "no answer") checks it.
"""

from __future__ import annotations

import itertools
import logging
import os
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..api.work import ReplicaRequirements

UNAUTHENTIC = -1

#: kill-switch for the batched wire protocol: 0 forces every connection
#: onto the per-profile unary fallback (the mixed-version escape hatch)
BATCH_ENV = "KARMADA_TPU_ESTIMATOR_BATCH"
#: seconds a generation confirmation stays trusted across invalidate();
#: 0 re-pings the servers on every invalidated pass
PING_ENV = "KARMADA_TPU_ESTIMATOR_PING_SECONDS"
#: in-flight unary RPCs per server channel on the pipelined fallback path
WIDTH_ENV = "KARMADA_TPU_ESTIMATOR_FALLBACK_WIDTH"


def batch_enabled() -> bool:
    return os.environ.get(BATCH_ENV, "1").lower() not in ("0", "false", "")


def ping_trust_seconds() -> float:
    try:
        return float(os.environ.get(PING_ENV, "0") or 0.0)
    except ValueError:
        return 0.0


def fallback_width() -> int:
    try:
        width = int(os.environ.get(WIDTH_ENV, "4") or 4)
    except ValueError:
        width = 4
    return max(1, width)


def conn_supports_batch(conn) -> Optional[bool]:
    """Per-connection negotiation state: None = not yet probed, False =
    server answered UNIMPLEMENTED (probed once; a reconnect builds a fresh
    connection and re-probes — a wire failure also resets the pin to None
    so a server that dies and returns mid-pass re-negotiates). The env
    kill-switch overrides."""
    if not batch_enabled():
        return False
    return getattr(conn, "supports_batch", None)


def conn_breaker_engaged(conn) -> bool:
    """Is the connection's circuit breaker currently rejecting calls?
    Routing layers consult this BEFORE submitting fan-out work so a
    breaker-open server answers UnauthenticReplica immediately instead of
    burning the executor (and the pass deadline) on a doomed RPC. The
    check is non-consuming — the half-open probe that heals the breaker
    is taken by the transport's own call path, never by routing."""
    br = getattr(conn, "breaker", None)
    return br is not None and br.engaged()


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
    per-cluster connection cache + concurrent fan-out), batch-native and
    delta-aware.

    Estimates memoize per (cluster, unique request profile) and are GATED
    by the owning estimator's snapshot generation: ``invalidate()`` marks
    every cluster unconfirmed, and the next pass re-confirms them — an
    in-process estimator by reading its generation, a remote one with one
    GetGenerations ping per SERVER connection — so only clusters whose
    generation actually advanced re-pay the profile fan-out, and the
    fan-out itself is one MaxAvailableReplicasBatch per server instead of
    clusters x profiles unary calls. Old servers (UNIMPLEMENTED) keep the
    reference shape: full per-cluster re-query on every invalidation,
    pipelined over the channel."""

    def __init__(self) -> None:
        self._by_cluster: dict = {}
        self._pool = None
        # wall seconds spent in live estimator traffic (generation pings +
        # memo-miss fan-outs) since construction
        self.fanout_seconds_total = 0.0
        # memoized answers, one scalar per (cluster, profile bytes); the
        # profile key is positional over the engine snapshot's dims, so one
        # registry serves one dims universe at a time
        self._memo: dict[tuple[str, bytes], int] = {}
        # last generation each cluster's memo entries were computed at
        self._gen: dict[str, int] = {}
        # clusters whose memo is trusted this epoch -> monotonic confirm
        # time (the PING_ENV trust window keys off it)
        self._confirmed: dict[str, float] = {}
        # live RPCs issued since construction, by kind — callers diff this
        # per pass to see the O(servers) steady-pass shape
        self.rpc_counts: dict[str, int] = {"batch": 0, "unary": 0, "ping": 0}
        # memo-content version: bumped whenever an entry is written or
        # dropped; confirm_token() returns it
        self._epoch = 0

    def _count_rpc(self, kind: str, n: int = 1) -> None:
        """One choke point for wire accounting: ``rpc_counts`` and the
        process metric family (karmada_tpu_estimator_rpcs_total) move
        together."""
        from ..utils.metrics import estimator_rpcs

        self.rpc_counts[kind] += n
        estimator_rpcs.inc(n, kind=kind)

    def register(self, est) -> None:
        self._by_cluster[est.cluster_name] = est
        # a (re)registered estimator invalidates exactly its own cluster's
        # memo — columns are keyed by name, so other members keep theirs
        self._drop_cluster(est.cluster_name)

    def deregister(self, cluster_name: str) -> None:
        self._by_cluster.pop(cluster_name, None)
        self._drop_cluster(cluster_name)

    def _drop_cluster(self, name: str) -> None:
        self._gen.pop(name, None)
        self._confirmed.pop(name, None)
        self._epoch += 1
        for key in [k for k in self._memo if k[0] == name]:
            del self._memo[key]

    def get(self, cluster_name: str):
        return self._by_cluster.get(cluster_name)

    def invalidate(self, drop: bool = False) -> None:
        """Mark memoized estimates stale. The default is GENERATION-GATED:
        memo entries survive, and the next pass re-confirms each cluster's
        snapshot generation (one ping per server) — a no-movement refresh
        never touches the profile fan-out. A confirmation younger than
        ``KARMADA_TPU_ESTIMATOR_PING_SECONDS`` stays trusted. ``drop=True``
        is the hard form: forget everything and re-pay the full fan-out
        next pass."""
        if drop:
            self._memo.clear()
            self._gen.clear()
            self._confirmed.clear()
            self._epoch += 1
            return
        trust = ping_trust_seconds()
        if trust <= 0:
            self._confirmed.clear()
            return
        import time as _time

        now = _time.monotonic()
        self._confirmed = {
            c: t for c, t in self._confirmed.items() if now - t < trust
        }

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
        (client/accurate.go:139-162), grouped by server connection: one
        batch RPC per server covers every hosted cluster's misses; clusters
        on fallback (unary) connections fan out per channel with pipelined
        per-profile calls; in-process estimators take one task each. A
        cluster missing the deadline answers UnauthenticReplica (-1) for
        this pass, so the min-merge ignores it instead of blocking
        scheduling; its late result is discarded, and it never blocks
        memoization of the clusters that did answer. ``fn.unanswered``
        holds the registered clusters the last pass answered -1 for."""
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
            if unanswered:
                # degraded pass: observable (the counter) and never
                # replayable (refresh_token below answers None)
                from ..utils.metrics import degraded_passes

                degraded_passes.inc(channel="estimator")
            return out

        def refresh_token():
            # the scheduler's batch-identity fast path probes this before
            # replaying a pass: an unchanged token iff no memo content moved
            # AND the last pass answered every registered cluster
            token = self.confirm_token(
                names, max_workers=max_workers, timeout_seconds=timeout_seconds,
            )
            if token is None or unanswered:
                return None
            return token

        estimate.refresh_token = refresh_token
        estimate.unanswered = unanswered
        return estimate

    # -- refresh machinery (ping + grouped fan-out) ------------------------

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

        from ..utils.metrics import (
            estimator_delta_requeries,
            estimator_refresh_seconds,
        )
        from ..utils.tracing import tracer

        t0 = _time.perf_counter()
        deadline = None if timeout_seconds is None else t0 + timeout_seconds

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(deadline - _time.perf_counter(), 0.0)

        with tracer.span("estimator.refresh") as sp:
            # confirm generations (local reads + one ping per server)
            touched_wire = self._confirm_generations(
                names, prof_keys, max_workers, remaining
            )
            # fetch: clusters with any unmemoized profile, grouped by
            # batch-capable connection; the rest per channel or cluster
            fetch: list = []  # (name, est, conn | None)
            for name in names:
                est = self._by_cluster.get(name)
                if est is None:
                    continue
                if name in self._confirmed and all(
                    (name, k) in self._memo for k in prof_keys
                ):
                    continue
                fetch.append((name, est, getattr(est, "conn", None)))
            sp.attrs["requeried_clusters"] = len(fetch)
            if fetch:
                touched_wire = True
                estimator_delta_requeries.inc(len(fetch))
                self._fetch(fetch, uniq, prof_keys, max_workers, remaining)
        if touched_wire:
            elapsed = _time.perf_counter() - t0
            self.fanout_seconds_total += elapsed
            estimator_refresh_seconds.observe(elapsed)

    def _confirm_generations(
        self,
        names: Sequence[str],
        prof_keys: Optional[Sequence[bytes]],
        max_workers: int,
        remaining,
    ) -> bool:
        """Confirm every unconfirmed cluster's snapshot generation: local
        estimators by a direct read, remote ones with one GetGenerations
        ping per server connection. A cluster whose generation moved drops
        its memo (the fetch step re-queries it). When ``prof_keys`` is
        given, remote clusters with ANY unmemoized profile skip the ping —
        the fetch returns their generation anyway; ``prof_keys=None``
        (confirm_token) pings every unconfirmed remote. Returns True when
        any wire traffic happened."""
        from concurrent.futures import wait as _fwait

        from .service import GetGenerationsRequest, UnsupportedMethodError

        # local estimators confirm by direct generation read
        remote_unconfirmed: list = []  # (name, est, conn)
        for name in names:
            if name in self._confirmed:
                continue
            est = self._by_cluster.get(name)
            if est is None:
                continue
            conn = getattr(est, "conn", None)
            if conn is None:
                gen = int(getattr(est.snapshot, "generation", 0))
                if self._gen.get(name) != gen:
                    self._drop_cluster(name)
                    self._gen[name] = gen
                self._confirm(name)
                continue
            remote_unconfirmed.append((name, est, conn))

        # generation pings, one per server connection
        ping_groups: dict[int, tuple] = {}
        for name, est, conn in remote_unconfirmed:
            if conn_breaker_engaged(conn):
                # breaker-open server: stay unconfirmed (-1 this pass)
                # WITHOUT submitting the doomed ping; the memo survives,
                # so the half-open probe that heals the channel
                # revalidates it without a refetch
                continue
            if prof_keys is not None and not all(
                (name, k) in self._memo for k in prof_keys
            ):
                continue
            if conn_supports_batch(conn) is False:
                # old server: no generations to ask for — re-pay the
                # fan-out for this cluster (the reference's shape)
                self._drop_cluster(name)
                continue
            ping_groups.setdefault(id(conn), (conn, []))[1].append(name)
        if not ping_groups:
            return False
        pool = self._ensure_pool(max_workers)

        def ping(conn, members):
            return conn.call(
                "GetGenerations", GetGenerationsRequest(clusters=members)
            )

        futs = {}
        for conn, members in ping_groups.values():
            self._count_rpc("ping")
            futs[pool.submit(ping, conn, list(members))] = (conn, members)
        done, not_done = _fwait(futs, timeout=remaining())
        for f in not_done:
            f.cancel()  # members stay unconfirmed: -1 this pass
        for f in done:
            conn, members = futs[f]
            try:
                resp = f.result()
            except UnsupportedMethodError:
                conn.supports_batch = False
                for name in members:
                    self._drop_cluster(name)  # refetch on the unary path
                continue
            except Exception:  # noqa: BLE001 — server unreachable:
                # members stay unconfirmed (and answer -1) this pass; the
                # memo survives, so a later ping that finds the generation
                # unchanged revalidates it without a refetch
                continue
            for name in members:
                gen = resp.generations.get(name)
                if gen is not None and self._gen.get(name) == gen:
                    self._confirm(name)
                else:
                    self._drop_cluster(name)  # moved (or unknown)
        return True

    def confirm_token(
        self,
        cluster_names: Sequence[str],
        *,
        max_workers: int = 64,
        timeout_seconds: Optional[float] = None,
    ):
        """Prove the estimator contribution to a scheduling batch
        unchanged, as cheaply as the protocol allows: confirm every
        registered cluster's snapshot generation (O(servers) pings; zero
        wire when everything is already confirmed) and return an opaque
        token that is EQUAL to a previous token iff no memo content changed
        in between. Returns None when any registered cluster could not be
        confirmed (old server, unreachable, or never fetched)."""
        import time as _time

        names = list(cluster_names)
        t0 = _time.perf_counter()
        deadline = None if timeout_seconds is None else t0 + timeout_seconds

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(deadline - _time.perf_counter(), 0.0)

        touched = self._confirm_generations(names, None, max_workers, remaining)
        if touched:
            self.fanout_seconds_total += _time.perf_counter() - t0
        if all(
            name in self._confirmed
            for name in names
            if name in self._by_cluster
        ):
            return (self._epoch,)
        return None

    def _confirm(self, name: str) -> None:
        import time as _time

        self._confirmed[name] = _time.monotonic()

    def _ensure_pool(self, max_workers: int):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            from ..utils.tracing import ContextPropagatingExecutor

            # context-propagating: ping/fetch tasks open their RPC spans
            # under the refresh span that submitted them
            self._pool = ContextPropagatingExecutor(
                ThreadPoolExecutor(max_workers)
            )
        return self._pool

    def _fetch(self, fetch, uniq, prof_keys, max_workers, remaining) -> None:
        """One batch RPC per batch-capable server connection; per-CHANNEL
        pipelined unary tasks for fallback servers; per-cluster tasks for
        local estimators. Results merge on the calling thread: a cluster
        that answered memoizes regardless of what happened to any other
        cluster (per-column completeness). Only the profile columns some
        fetched cluster is actually missing go over the wire. A fetch that
        raises answers -1 this pass and is not memoized."""
        from concurrent.futures import wait as _fwait

        from .service import UnsupportedMethodError

        pool = self._ensure_pool(max_workers)
        # an unconfirmed cluster cannot trust ANY memo entry (its
        # generation is unknown), so it needs the full matrix; confirmed
        # clusters only their missing columns
        miss_idx: set = set()
        for name, _est, _conn in fetch:
            if name not in self._confirmed:
                miss_idx = set(range(len(prof_keys)))
                break
            miss_idx.update(
                u for u, k in enumerate(prof_keys) if (name, k) not in self._memo
            )
        order = sorted(miss_idx)
        sub_uniq = np.asarray(uniq)[order]
        sub_keys = [prof_keys[u] for u in order]
        rows = [[int(v) for v in row] for row in sub_uniq]

        batch_groups: dict[int, tuple] = {}  # id(conn) -> (conn, members)
        unary_groups: dict[int, tuple] = {}  # id(conn) -> (conn, members)
        locals_: list = []  # (name, est) — no connection (in-proc direct)
        retry: list = []  # members re-routed after a mid-pass UNIMPLEMENTED

        def route(name, est, conn):
            if conn is not None and conn_breaker_engaged(conn):
                # breaker-open server: the cluster answers -1 for this pass
                # with ZERO executor/wire cost (stays unconfirmed, so the
                # pass is degraded and never replayable)
                return
            if conn is not None and conn_supports_batch(conn) is not False:
                batch_groups.setdefault(id(conn), (conn, []))[1].append((name, est))
            elif conn is not None and hasattr(conn, "call_future"):
                unary_groups.setdefault(id(conn), (conn, []))[1].append((name, est))
            else:
                locals_.append((name, est))

        for name, est, conn in fetch:
            route(name, est, conn)

        def fetch_batch(conn, members):
            # the profile matrix is unique'd ACROSS namespaces, so this path
            # sends no per-row namespaces: the server's ResourceQuota plugin
            # stays inert here, as on the unary fallback
            from .service import MaxAvailableReplicasBatchRequest

            dims = list(members[0][1].dims_provider())
            return conn.call(
                "MaxAvailableReplicasBatch",
                MaxAvailableReplicasBatchRequest(
                    clusters=[name for name, _ in members], dims=dims, rows=rows,
                ),
            )

        def fetch_unary_channel(conn, members):
            """The pipelined fallback: ONE task per server channel slides a
            bounded window of per-profile calls over it (grpc futures)."""
            from collections import deque

            from .service import MaxAvailableReplicasRequest

            width = fallback_width()
            out = {
                name: np.full(len(rows), UNAUTHENTIC, np.int32)
                for name, _ in members
            }

            def resolve(entry):
                name, u, fut = entry
                try:
                    out[name][u] = fut.result().max_replicas
                except Exception:  # noqa: BLE001 — per-RPC failure = -1
                    pass

            inflight: deque = deque()
            for name, est in members:
                dims = list(est.dims_provider())
                for u, row in enumerate(sub_uniq):
                    req = MaxAvailableReplicasRequest(
                        cluster=name,
                        resource_request={
                            d: int(q) for d, q in zip(dims, row) if q > 0
                        },
                    )
                    if len(inflight) >= width:
                        resolve(inflight.popleft())
                    try:
                        inflight.append(
                            (name, u, conn.call_future("MaxAvailableReplicas", req))
                        )
                    except Exception:  # noqa: BLE001 — submit failure = -1
                        pass
            while inflight:
                resolve(inflight.popleft())
            return out

        def fetch_single(name, est):
            conn = getattr(est, "conn", None)
            if conn is not None and hasattr(est, "query_profiles"):
                dims = list(est.dims_provider())
                return est.query_profiles(dims, sub_uniq)
            # local estimator: generation read BEFORE computing so a
            # concurrent member event makes the answer look stale
            gen = int(getattr(est.snapshot, "generation", 0))
            return (
                np.asarray(est.max_available_replicas(None, sub_uniq), np.int32),
                gen,
            )

        def merge_vals(name, vals, gen) -> None:
            if np.asarray(vals).min(initial=0) < 0:
                # a -1 row (a per-RPC wire failure) or a wrapped answer is
                # transient: never memoized
                return
            self._memoize(name, sub_keys, vals, gen)

        def failed(kind, meta, f) -> None:
            logging.getLogger("karmada_tpu_torch").warning(
                "estimator %s fetch for %s failed; it answers -1 this pass",
                kind, meta if kind == "single" else [n for n, _ in meta[1]],
                exc_info=f.exception())

        futs = {}
        for conn, members in batch_groups.values():
            self._count_rpc("batch")
            futs[pool.submit(fetch_batch, conn, members)] = ("batch", (conn, members))
        for conn, members in unary_groups.values():
            self._count_rpc("unary", len(members) * len(rows))
            futs[pool.submit(fetch_unary_channel, conn, members)] = (
                "unary", (conn, members))
        for name, est in locals_:
            if getattr(est, "conn", None) is not None:
                self._count_rpc("unary", len(rows))
            futs[pool.submit(fetch_single, name, est)] = ("single", name)
        done, not_done = _fwait(futs, timeout=remaining())
        for f in not_done:
            # a straggler answers -1 this pass only (it stays unconfirmed
            # and unmemoized)
            f.cancel()
        for f in done:
            kind, meta = futs[f]
            try:
                result = f.result()
            except UnsupportedMethodError:
                if kind == "batch":
                    # negotiated mid-pass: pin the fallback on the
                    # connection and re-fan these clusters over the unary
                    # path — once per connection lifetime
                    conn, members = meta
                    conn.supports_batch = False
                    retry.append((conn, members))
                continue
            except Exception:  # noqa: BLE001 — a failed fetch = -1 this pass
                failed(kind, meta, f)
                continue
            if kind == "batch":
                _conn, members = meta
                answered = {res.cluster: res for res in result.results}
                for name, _est in members:
                    res = answered.get(name)
                    if res is None:
                        continue  # unhosted: structural -1, never memoized
                    self._memoize(name, sub_keys, res.max_replicas, res.generation)
            elif kind == "unary":
                for name, vals in result.items():
                    merge_vals(name, vals, None)
            else:
                vals, gen = result
                merge_vals(meta, vals, gen)
        if retry:
            futs = {}
            for conn, members in retry:
                if hasattr(conn, "call_future"):
                    self._count_rpc("unary", len(members) * len(rows))
                    futs[pool.submit(fetch_unary_channel, conn, members)] = (
                        "unary", (conn, members))
                else:
                    for name, est in members:
                        self._count_rpc("unary", len(rows))
                        futs[pool.submit(fetch_single, name, est)] = ("single", name)
            done, not_done = _fwait(futs, timeout=remaining())
            for f in not_done:
                f.cancel()
            for f in done:
                kind, meta = futs[f]
                try:
                    result = f.result()
                except Exception:  # noqa: BLE001
                    failed(kind, meta, f)
                    continue
                if kind == "unary":
                    for name, vals in result.items():
                        merge_vals(name, vals, None)
                else:
                    vals, gen = result
                    merge_vals(meta, vals, gen)

    def _memoize(self, name, prof_keys, values, gen) -> None:
        if gen is not None and self._gen.get(name) not in (None, int(gen)):
            # the server's snapshot moved between our last fetch and this
            # partial one: entries OUTSIDE this response are at the old
            # generation — drop them so they re-fetch
            self._drop_cluster(name)
        self._epoch += 1
        for key, val in zip(prof_keys, values):
            self._memo[(name, key)] = int(val)
        if gen is not None:
            self._gen[name] = int(gen)
        else:
            # fallback server: no generation protocol — entries stay valid
            # until the next invalidate() epoch, then re-fetch
            self._gen.pop(name, None)
        self._confirm(name)


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
