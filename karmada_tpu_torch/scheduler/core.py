"""TensorScheduler: the batched Filter/Score/Select/Assign pipeline.

Counterpart of ``karmada_tpu/scheduler/core.py``. Re-architecture of the
reference's per-binding pipeline (core/generic_scheduler.go:70-115 —
findClustersThatFit -> prioritizeClusters -> SelectClusters ->
AssignReplicas) as tensor programs over [bindings, clusters] arrays, on two
routes, chosen per row exactly as the JAX engine chooses:

- the fleet path (``scheduler/fleet.py``): a batch with at least
  ``fleet_threshold`` fleet-eligible rows (single affinity term, no
  effective spread constraint, no eviction tasks, at most K_PREV previous
  sites, at most MAX_REPLICAS_FAST replicas unless Duplicated) schedules
  those rows through the device-resident ``FleetTable``: K1's table form
  per interned request profile, then per chunk K3 (masks), K2 (division)
  and K4 (resident diff), K5 (wire), and phase B where needed. Spread-
  constraint rows ride it too: their host group selection is interned as a
  derived placement (``_derive_spread_selections``). Re-passing the same
  problem objects against the same snapshot takes the batch-identity fast
  path, which skips the host prologue;
- the host general path for every other row: chunked mask packing on the
  host in numpy (Filter), the estimator (``ops.estimate_merge``, K1),
  spread selection on the host (Select), and the division
  (``ops.divide_replicas``, K2). A chunk with ``padded * C <= 2**16`` is
  answered on the host by the numpy divider, the JAX engine's own rule.

Multi-term ClusterAffinities rows without spread constraints take the
ranked path (``_schedule_ranked``): each row's first fitting group picked
on the device by K17 (``ops.masks.first_fit_group``) from the row's base
mask, its placement's term masks and the merged availability, and one
solve per chunk. Multi-term rows with spread constraints take the per-round
loop.

The quota plane (``set_quota`` with a ``scheduler.quota.QuotaSnapshot``)
admits each wave before the solve: one launch of K12 (``ops.quota_admit``)
partitions the wave, denied rows answer ``QUOTA_EXCEEDED_ERROR`` unsolved,
and the admitted demand is debited from the working remaining after the
solve returns. Static-assignment caps reach every route: K13's fold form
(``ops.quota_caps_fold``) over the fleet's profile table, K13's per-row
form (``ops.quota_cluster_caps``) beside the summary estimate in K1's merge
form on the general route, and ``ops.cluster_caps_np`` on the tiny-batch
host path.

The two armed-only planes wrap the solve in ``schedule()``, in the JAX
engine's order: the solve, then the preemption pass, then the provenance
capture, each in a log-and-continue ``try`` (losing either must never lose
the wave's results). The preemption plane (``set_preemption`` with a
victim source) turns the wave's priority > 0 rows that answered
``INSUFFICIENT_ERROR`` into demanders: one launch of K15
(``ops.preempt_select``) selects victims over the demanders and the
resident pool, and the demanders re-solve in the same pass against the
capacity the victims free (``_resolve_boosted``); the verdict lands in
``last_preemption``. Provenance (``set_explain`` with an
``utils.explainstore.ExplainStore``, or ``KARMADA_TPU_EXPLAIN=1`` when the
engine is built) composes each stage's mask on the host per chunk and
launches K14 (``ops.explain_pass``) once per chunk; the captures land in
the store under the tracer's current wave. ``schedule()`` opens a wave
when none is open and closes it after (in the JAX package the control
plane's worker and detector open the waves; the port has neither yet), so
the store's ring, whose cap counts waves, evicts.

What is not ported yet, and where the port raises ``NotImplementedError``
instead of answering differently from the JAX engine: a device mesh. The
kernels take any cluster count, any number of quota dims and any number of
out-of-tree estimators beside the static-assignment caps. ``dirty_keys`` is
accepted; the JAX delta pass it feeds is result-identical to a full pass,
and the port runs the full pass. The JAX delta admission
(``_quota_admission_delta``) is not result-identical to a full admission
(a full admission charges the unchanged rows again), so the port keeps it.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field
from typing import Optional, Sequence

import numpy as np
import torch

from ..api.policy import Placement
from ..ops.divide import (
    AGGREGATED, DUPLICATED, DYNAMIC_WEIGHT, divide_replicas,
)
from ..models.modeling import estimate_by_models_np, model_overlay
from ..ops.estimate import (
    MAX_INT32,
    estimate_merge,
    estimate_merge_table,
    profile_table,
)
from ..ops.quota import (
    UNLIMITED,
    cluster_caps_np,
    quota_admit,
    quota_caps_fold,
    quota_cluster_caps,
)
from ..utils.features import CUSTOMIZED_CLUSTER_RESOURCE_MODELING, feature_gate
from .quota import QUOTA_EXCEEDED_ERROR
from .snapshot import ClusterSnapshot, CompiledPlacement, compile_placement


def kernel_variant(
    avail_max: int, static_max: int, prev_max: int, max_n: int, c: int
) -> tuple[bool, Optional[tuple]]:
    """Choose the divide specialization from host-known bounds, exactly as
    the JAX engine chooses it (karmada_tpu/scheduler/core.py:43).

    Returns ``(wide, fast)`` for divide_replicas: int32 arithmetic when every
    weight x target product and per-row weight sum provably fits 31 bits,
    and the packed-key dispense when the (weight, lastReplicas, index) key
    fits 31 bits with a small remainder rank. The port's divide computes the
    wide form under every choice (the forms are identical under these
    gates); the choice is kept so both engines report the same variant."""
    max_w = max(avail_max + prev_max, static_max, 1)
    narrow = max_w * max(max_n, 1) < 2**31 and max_w * c < 2**31
    fast = None
    if narrow:
        w_bits = max(1, max_w.bit_length())
        l_bits = max(1, int(prev_max).bit_length())
        i_bits = max(1, (c - 1).bit_length())
        k_top = min(c, 1 << max(1, max(1, max_n) - 1).bit_length())
        div_f32 = max_w * max(max_n, 1) < 2**24 and max_n < 2**22
        if k_top <= 1024:
            if w_bits + l_bits + i_bits <= 31:
                for l_tier in (4, 8, 12, 16):
                    if l_bits <= l_tier and w_bits <= 31 - i_bits - l_tier:
                        l_bits = l_tier
                        w_bits = 31 - i_bits - l_tier
                        break
                fast = (w_bits, l_bits, k_top, div_f32, True)
            elif w_bits + l_bits <= 31:
                for l_tier in (4, 8, 12, 16):
                    if l_bits <= l_tier and w_bits <= 31 - l_tier:
                        l_bits = l_tier
                        w_bits = 31 - l_tier
                        break
                fast = (w_bits, l_bits, k_top, div_f32, False)
    return (not narrow), fast


def host_profile_table(
    snapshot, uniq: np.ndarray, models_active: bool = False
) -> np.ndarray:
    """numpy mirror of the estimator over unique request profiles:
    int64[U, C], MAX_INT32 sentinel where nothing is requested or the cluster
    gives no summary (ops/estimate.py general_estimate), with the resource-
    model estimator over the summary answer where applicable when
    ``models_active``. The tiny-batch path reads it through
    ``TensorScheduler._availability_np``. Values are clamped
    to the sentinel before comparison, so an absurd-but-legal ratio above
    2^31-1 reads as "no answer -> clamp to spec.Replicas"."""
    mi = MAX_INT32
    cap = np.maximum(np.asarray(snapshot.available_cap), 0)
    table = np.full((uniq.shape[0], cap.shape[0]), mi, np.int64)
    for d in range(uniq.shape[1]):
        req = uniq[:, d]
        ratio = cap[None, :, d] // np.maximum(req[:, None], 1)
        table = np.where((req > 0)[:, None], np.minimum(table, ratio), table)
    table = np.minimum(table, mi)
    if models_active:
        # the model answer replaces the summary answer where applicable,
        # capped by allowed pods, exactly like the device form (K7's
        # overlay form): the pods column is no model dimension
        mp = snapshot.model_pack
        pods_dim = snapshot.dim_index("pods")
        req_models = np.asarray(uniq)
        if pods_dim is not None:
            req_models = req_models.copy()
            req_models[:, pods_dim] = 0
        model_avail, applicable = estimate_by_models_np(
            np.asarray(mp.min_bounds), np.asarray(mp.counts),
            np.asarray(mp.covered), req_models,
        )
        model_avail = model_avail.astype(np.int64)
        if pods_dim is not None:
            allowed = np.minimum(np.maximum(cap[:, pods_dim], 0), mi)
            model_avail = np.minimum(model_avail, allowed[None, :])
        use_model = np.asarray(mp.has_models)[None, :] & applicable
        table = np.where(use_model, model_avail, table)
    return np.where(np.asarray(snapshot.has_summary)[None, :], table, mi)


@dataclass
class BindingProblem:
    """Engine-level scheduling unit (decoupled from the API object; the
    scheduler process builds these from ResourceBindings)."""

    key: str
    placement: Optional[Placement] = None
    replicas: int = 0
    requests: dict[str, int] = dc_field(default_factory=dict)
    gvk: str = ""
    prev: dict[str, int] = dc_field(default_factory=dict)  # spec.clusters
    evict_clusters: tuple[str, ...] = ()  # graceful-eviction tasks
    fresh: bool = False  # reschedule triggered
    namespace: str = ""  # quota-admission namespace ("" = not quota'd)
    # preemption plane: the binding's priority class (0 = never preempts,
    # preemptible by any class above it) and the subset of evict_clusters
    # whose eviction task is a preemption (the explain capture's bit 7)
    priority: int = 0
    preempt_clusters: tuple[str, ...] = ()


@dataclass
class ScheduleResult:
    key: str
    clusters: dict[str, int] = dc_field(default_factory=dict)
    feasible: tuple[str, ...] = ()  # post-filter candidates (zero-replica set)
    affinity_name: str = ""
    error: str = ""

    @property
    def success(self) -> bool:
        return not self.error


#: the divider's insufficient-capacity verdict (wire/compat surface); the
#: preemption plane's demander predicate
INSUFFICIENT_ERROR = "clusters available replicas are not enough"


@dataclass
class PreemptionOutcome:
    """One pass's preemption verdict, left on the engine as
    ``last_preemption`` for the controller to act on (victim evictions are
    store writes; the engine never touches API objects)."""

    #: (key, resident placement dict, priority) per selected victim
    victims: list = dc_field(default_factory=list)
    #: demander keys that re-solved successfully against the freed capacity
    #: (their results were replaced)
    placed: list = dc_field(default_factory=list)
    #: demander keys still unschedulable with every victim freed
    still_unschedulable: list = dc_field(default_factory=list)
    #: int64[C, R] capacity the victims free, per cluster column
    freed_caps: Optional[np.ndarray] = None


class _BoostedSnapshot:
    """Capacity-shifted view of a ClusterSnapshot for the preemption
    re-solve: ``available_cap`` reads as ``base + freed_caps``; every other
    attribute delegates. Never cached: the per-profile and selection caches
    key on the real snapshot only."""

    def __init__(self, base, freed_caps):
        self._base = base
        cap = np.asarray(base.available_cap)
        self.available_cap = cap + np.asarray(freed_caps, dtype=cap.dtype)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to karmada_tpu_torch yet; the JAX engine "
        "(karmada_tpu.scheduler.TensorScheduler) serves it"
    )


def _upload(a, dtype, device) -> torch.Tensor:
    """``a`` on ``device`` as a contiguous tensor of ``dtype`` (a numpy
    dtype); a tensor already there passes through."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def unique_placements(compiled, rows: int) -> tuple[np.ndarray, list]:
    """(slot int32[rows], unique compiled placements) of ``compiled``: the
    O(B x C) mask algebra runs once per unique placement and is gathered
    by row. Rows past ``len(compiled)`` (padding) take slot 0."""
    slot_of: dict[int, int] = {}
    unique: list[CompiledPlacement] = []
    idx = np.zeros(rows, np.int32)
    for i, cp in enumerate(compiled):
        slot = slot_of.get(id(cp))
        if slot is None:
            slot = len(unique)
            slot_of[id(cp)] = slot
            unique.append(cp)
        idx[i] = slot
    return idx, unique


def term_stack(unique_cps, c: int) -> tuple[np.ndarray, np.ndarray]:
    """(bool[U, Tmax, C] ClusterAffinities term masks, int32[U] live-term
    counts) of the unique placements; a placement's missing terms are
    empty."""
    tmax = max(len(cp.terms) for cp in unique_cps)
    stack = np.zeros((len(unique_cps), tmax, c), bool)
    live = np.ones(len(unique_cps), np.int32)
    for u, cp in enumerate(unique_cps):
        live[u] = len(cp.terms)
        for t, (_name, mask) in enumerate(cp.terms):
            stack[u, t] = mask
    return stack, live


def gvk_masks(snap, problems) -> tuple[np.ndarray, np.ndarray]:
    """(bool[G, C] API-enablement mask per unique GVK, int32[B] slot per
    row): an unknown GVK is enabled nowhere, an empty one everywhere (and
    any GVK when the snapshot knows none)."""
    slot_of: dict[str, int] = {}
    masks: list[np.ndarray] = []
    idx = np.empty(len(problems), np.int32)
    c = snap.num_clusters
    for i, p in enumerate(problems):
        slot = slot_of.get(p.gvk)
        if slot is None:
            slot = len(masks)
            slot_of[p.gvk] = slot
            gid = snap.gvk_vocab.get(p.gvk) if p.gvk else None
            if gid is None:
                m = (np.zeros(c, bool) if p.gvk and len(snap.gvk_vocab) > 0
                     else np.ones(c, bool))
            else:
                word, bit = gid // 32, gid % 32
                m = (snap.gvk_bits[:, word] >> np.uint32(bit)) & 1 != 0
            masks.append(m)
        idx[i] = slot
    return np.stack(masks), idx


class TensorScheduler:
    """Schedules batches of bindings against one cluster snapshot."""

    PLACEMENT_CACHE_CAP = 8192
    #: minimum eligible-batch size before the device-resident fleet path
    #: engages (the JAX engine's threshold)
    fleet_threshold = 256
    #: cap on interned spread-selection variants
    SELECTION_CACHE_CAP = 8192

    def __init__(
        self,
        snapshot: ClusterSnapshot,
        chunk_size: int = 4096,
        extra_estimators: Sequence = (),
        disabled_plugins: Sequence[str] = (),
        custom_filters: Sequence = (),
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        if mesh is not None:
            raise _not_ported("a device mesh (multi-GPU scheduling)")
        self.device = torch.device(device)
        self.snapshot = snapshot
        self.chunk_size = chunk_size
        # callables (requests[B,R] int64, replicas[B] int32), given tensors
        # on ``device`` -> int32[B,C] availability (numpy or tensor) with -1
        # for "no answer" (accurate estimators plug here)
        self.extra_estimators = list(extra_estimators)
        # --plugins enable/disable list (scheduler.go:243-247)
        self.disabled_plugins = set(disabled_plugins)
        # out-of-tree filter plugins: callables (snapshot, problems) ->
        # bool[B, C] mask AND-composed with the in-tree filters
        self.custom_filters = list(custom_filters)
        # id(placement) -> (placement, compiled), LRU-bounded; the strong
        # reference keeps a recycled id() from aliasing a stale mask
        self._placement_cache: OrderedDict[
            int, tuple[Optional[Placement], CompiledPlacement]
        ] = OrderedDict()
        self._snapshot_gen = 0
        # device copies of the snapshot's estimator inputs, per generation
        self._dev_state: Optional[tuple] = None
        # device copies of the snapshot's model pack, per generation
        self._dev_models: Optional[tuple] = None
        # device-resident fleet table (scheduler.fleet), built on the first
        # batch that reaches fleet_threshold eligible rows
        self._fleet = None
        # (id(base compiled), selection bytes) -> (derived cp, pinned base)
        self._selection_cache: dict = {}
        # batch-identity fast path: id() array of the last all-fleet batch
        # and its (problems, compiled) lists, which pin the problem objects
        # so a recycled id() cannot alias a stale batch
        self._batch_ids: Optional[np.ndarray] = None
        self._batch_gen = -1
        self._batch_cache: Optional[tuple] = None
        self._batch_spread = True  # batch holds derived spread selections
        self._batch_token = None  # snapshot.mask_token at cache time
        # estimator-backed batch-identity fast path: (ids, snapshot gen,
        # estimator ids, confirm tokens, results, pinned problems) of the
        # last host-path batch whose estimators could all prove their memo
        # content via refresh_token
        self._est_batch: Optional[tuple] = None
        # the wave's dirty keys (schedule's dirty_keys), staged per pass
        self._dirty_keys: Optional[set] = None
        # binding key -> (row fingerprint, pinned placement, derived cp | None)
        self._derived_rows: dict = {}
        # request-profile bytes -> availability row [C] (per snapshot gen)
        self._sel_profile_rows: dict = {}
        self._sel_profile_gen = -1
        # batched solves dispatched (host chunks + fleet passes)
        self.solve_batches = 0
        # quota plane (scheduler.quota.QuotaSnapshot | None): admission runs
        # as one K12 launch before the solve; static-assignment caps fold
        # into availability as one more estimator. Disarmed = one `is None`
        # check per schedule() call
        self.quota = None
        # (problem ids, quota generation, admitted sub-list | None, denied
        # results, denied positions, pinned problems) of the last admitted
        # wave: replays the partition of an unchanged wave and keeps the
        # admitted sub-list identity-stable, so the batch-identity fast
        # paths still fire under enforcement
        self._quota_cache: Optional[tuple] = None
        # device copy of the static-assignment cap tensor, per cap_token
        self._caps_dev: Optional[torch.Tensor] = None
        self._caps_dev_token = None
        # host-clock seconds of the last pass's phases (prologue + fleet)
        self.last_breakdown: dict[str, float] = {}
        # placement provenance: when armed, every schedule() pass composes
        # the per-stage masks per chunk and launches K14 once per chunk,
        # depositing the captures in the process-wide ExplainStore;
        # ``KARMADA_TPU_EXPLAIN=1`` arms it here, as in the JAX engine.
        # Disarmed (None) costs one `is None` check per pass
        from ..utils.explainstore import explain_armed, store as _estore

        self.explain = _estore() if explain_armed() else None
        # preemption plane: ``preempt_source(exclude_keys)`` answers the
        # resident victim pool as BindingProblems (the controller arms it
        # per pass); None is the disarmed state
        self.preempt_source = None
        self.last_preemption: Optional[PreemptionOutcome] = None

    # -- compilation -------------------------------------------------------

    def _compiled(self, placement: Optional[Placement]) -> CompiledPlacement:
        key = id(placement) if placement is not None else 0
        hit = self._placement_cache.get(key)
        if hit is not None:
            self._placement_cache.move_to_end(key)
            return hit[1]
        cp = compile_placement(placement, self.snapshot)
        # placement-level half of the fleet-eligibility predicate, computed
        # once per compiled placement (the per-row half is a hot loop)
        from .spread import should_ignore_spread_constraint

        cp.fleet_single_term = len(cp.terms) == 1 and (
            not cp.spread_constraints
            or should_ignore_spread_constraint(cp.placement or Placement())
        )
        self._placement_cache[key] = (placement, cp)
        # the cap must exceed the fleet's live-slot budget, or a storm's
        # cyclic access recompiles (and re-interns) every placement
        cache_cap = self.PLACEMENT_CACHE_CAP
        if self._fleet is not None:
            cache_cap = max(cache_cap, 2 * self._fleet._max_slots())
        if len(self._placement_cache) > cache_cap:
            self._placement_cache.popitem(last=False)
        return cp

    # -- public API --------------------------------------------------------

    def update_snapshot(self, snapshot: ClusterSnapshot) -> bool:
        """Swap in a refreshed snapshot over the SAME cluster set (the
        informer-cache delta case). Returns False when the cluster set or
        resource dims changed — callers must rebuild the engine then.
        Compiled placements survive an availability-only swap (equal
        ``mask_token``)."""
        if (
            snapshot.names != self.snapshot.names
            or snapshot.dims != self.snapshot.dims
        ):
            return False
        if snapshot.mask_token != self.snapshot.mask_token:
            self._placement_cache.clear()
            self._selection_cache.clear()
        self._derived_rows.clear()  # selections depend on capacities
        self.snapshot = snapshot
        self._snapshot_gen += 1
        return True

    def set_quota(self, quota) -> None:
        """Swap in a (re)built QuotaSnapshot (None = enforcement off).

        A changed ``cap_token`` (static-assignment content or cluster
        columns moved) drops the fleet table: cap rows are baked into its
        interned profile slots. A generation-only bump (remaining moved: a
        usage recompute, a quota raise) keeps every packed row; only the
        admission partition recomputes."""
        old = self.quota
        self.quota = quota
        # a quota with no static assignments bakes nothing into the fleet's
        # profile slots: its cap token counts as absent
        new_tok = quota.cap_token if quota is not None and quota.cap_index else None
        old_tok = old.cap_token if old is not None and old.cap_index else None
        if new_tok != old_tok:
            self._fleet = None
            self._batch_ids = None
            self._batch_cache = None
            self._est_batch = None
            self._quota_cache = None
            self._caps_dev = None
            self._caps_dev_token = None
            # derived spread selections rank groups on cap-folded
            # availability
            self._derived_rows.clear()

    def set_explain(self, store) -> None:
        """Arm (an ExplainStore) or disarm (None) provenance capture."""
        self.explain = store

    def set_preemption(self, source) -> None:
        """Arm (``source(exclude_keys)`` answering the resident victim pool)
        or disarm (None) the preemption plane."""
        self.preempt_source = source

    def schedule(
        self,
        problems: Sequence[BindingProblem],
        dirty_keys: Optional[set] = None,
    ) -> list[ScheduleResult]:
        """Schedule one wave: the solve, then (armed) the preemption pass,
        then (armed) the provenance capture, so a re-solved demander's
        capture shows its final placement. Either plane that fails logs and
        leaves the solve's results as they were (a failed preemption pass
        also clears ``last_preemption``: no victims without placed
        demanders). ``dirty_keys`` (binding keys whose problems changed
        since the last wave) turns the batch-identity fast path off for this
        pass, as in the JAX engine; where the JAX engine then runs its delta
        pass (result-identical to a full pass), the port runs the full
        pass. A wave that the caller left open is kept; otherwise the pass
        is a wave of its own."""
        from ..utils.tracing import tracer

        if tracer.open_wave() is not None:
            return self._schedule_wave(problems, dirty_keys)
        tracer.ensure_wave("schedule")
        try:
            return self._schedule_wave(problems, dirty_keys)
        finally:
            tracer.end_wave()

    def _schedule_wave(self, problems, dirty_keys) -> list[ScheduleResult]:
        self.last_preemption = None
        self._dirty_keys = set(dirty_keys) if dirty_keys else None
        try:
            results = self._schedule_quota(problems)
        finally:
            self._dirty_keys = None
        if self.preempt_source is not None and problems:
            try:
                results = self._preempt_pass(list(problems), results)
            except Exception as exc:  # noqa: BLE001 — the remedy is optional
                self.last_preemption = None
                logging.getLogger("karmada_tpu_torch").warning(
                    "preemption pass failed (%s: %s)", type(exc).__name__, exc)
        # a store whose ring is disabled (KARMADA_TPU_EXPLAIN_CAP=0) skips
        # the capture and its launches
        if self.explain is not None and self.explain.enabled and problems:
            try:
                self._capture_explain(list(problems), results)
            except Exception as exc:  # noqa: BLE001 — provenance is telemetry
                logging.getLogger("karmada_tpu_torch").warning(
                    "explain capture failed (%s: %s)", type(exc).__name__, exc)
        return results

    # -- quota plane -------------------------------------------------------

    def _schedule_quota(
        self, problems: Sequence[BindingProblem]
    ) -> list[ScheduleResult]:
        """Quota admission around the solve: when a QuotaSnapshot is set and
        the wave touches quota'd namespaces, one K12 launch partitions the
        wave; denied bindings answer QuotaExceeded unsolved, admitted ones
        ride the unchanged paths. The wave's debit commits only after the
        solve returned, and a failed solve drops the partition cache, so a
        retry re-admits against the uncharged remaining."""
        q = self.quota
        if q is None or not q.active:
            return self._schedule_inner(problems)
        part, debit = self._quota_admission(problems)
        try:
            sub_res = self._schedule_inner(problems if part is None else part[0])
        except BaseException:
            self._quota_cache = None
            raise
        self._apply_quota_debit(debit)
        if part is None:
            return sub_res
        results: list = [None] * len(problems)
        for i, res in part[1]:
            results[i] = res
        it = iter(sub_res)
        for i in range(len(problems)):
            if results[i] is None:
                results[i] = next(it)
        return results

    def _apply_quota_debit(self, debit) -> None:
        """Commit one admitted wave's demand against the working remaining
        (debited within a generation, rebuilt from recomputed usage at the
        next). None = nothing to commit (a replay, or no quota'd row)."""
        if debit is None:
            return
        q = self.quota
        limited = q.remaining < UNLIMITED
        q.remaining = np.where(limited, np.maximum(q.remaining - debit, 0), q.remaining)

    def _quota_admission(self, problems):
        """One admission pass over the wave: ``(partition, pending_debit)``.
        ``partition`` is None when no binding is quota'd or every row is
        admitted, else (admitted sub-list, denied (index, ScheduleResult)
        pairs), identity-stable across unchanged passes through
        ``_quota_cache``. ``pending_debit`` is the wave's admitted demand
        per namespace, committed by the caller after the solve (None on a
        replay: already committed)."""
        q = self.quota
        ns_index = q.ns_index
        b = len(problems)
        ns_ids = np.fromiter(
            (ns_index.get(p.namespace, -1) for p in problems), np.int32, b
        )
        if not (ns_ids >= 0).any():
            return None, None
        cache = self._quota_cache
        ids = np.fromiter(map(id, problems), np.int64, b)
        if (
            cache is not None
            and cache[1] == q.generation
            and len(cache[0]) == b
            and np.array_equal(cache[0], ids)
        ):
            if cache[2] is None:  # cached all-admitted wave
                return None, None
            return (cache[2], cache[3]), None
        out = self._quota_admission_delta(problems, ids, ns_ids, cache)
        if out is not None:
            return out
        admitted, debit = self._admit(ns_ids, self._wave_demand(problems, ns_ids))
        denied_idx = np.flatnonzero(~admitted)
        # an unchanged partition of the same wave reuses the previous
        # admitted sub-list object, so the inner fast paths see the same list
        same = (
            cache is not None
            and cache[2] is not None
            and np.array_equal(cache[4], denied_idx)
            and np.array_equal(cache[0], ids)
        )
        return self._partition(problems, ids, denied_idx, cache[2] if same else None), debit

    def _partition(self, problems, ids, denied_idx, sub):
        """Cache a wave's admission partition and return it as (admitted
        sub-list, denied (index, ScheduleResult) pairs), or None when every
        row is admitted. ``sub`` is the admitted sub-list when the caller
        keeps one, else it is built. The problems list is pinned in the
        cache so a recycled id() cannot alias a stale partition."""
        q = self.quota
        if denied_idx.size == 0:
            self._quota_cache = (ids, q.generation, None, None, denied_idx, list(problems))
            return None
        denied = [
            (int(i), ScheduleResult(key=problems[i].key, error=QUOTA_EXCEEDED_ERROR))
            for i in denied_idx
        ]
        if sub is None:
            admitted = np.ones(len(problems), bool)
            admitted[denied_idx] = False
            sub = [problems[i] for i in np.flatnonzero(admitted)]
        self._quota_cache = (ids, q.generation, sub, denied, denied_idx, list(problems))
        return sub, denied

    def _wave_demand(self, problems, ns_ids) -> np.ndarray:
        """int64[B, R] admission demand: each quota'd row's replica delta
        over its previous placement times its per-replica request, scaled
        in Python ints (``QuotaSnapshot.demand_row``)."""
        q = self.quota
        demand = np.zeros((len(problems), len(q.dims)), np.int64)
        for i in np.flatnonzero(ns_ids >= 0):
            p = problems[i]
            delta = p.replicas - sum(p.prev.values())
            if delta > 0:
                demand[i] = q.demand_row(p.requests, delta)
        return demand

    def _admit(self, ns_ids, demand) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """One K12 launch against the working remaining: (admitted
        bool[B], the admitted demand per namespace or None when it is
        zero). Rows and namespaces are padded to powers of two as in the
        JAX engine (pad rows unquota'd and demand-free, pad namespaces
        unlimited)."""
        q = self.quota
        b = len(ns_ids)
        b_pad = 1 << max(0, (b - 1).bit_length())
        if b_pad > b:
            ns_ids = np.pad(ns_ids, (0, b_pad - b), constant_values=-1)
            demand = np.pad(demand, ((0, b_pad - b), (0, 0)))
        n_pad = 1 << max(2, (q.remaining.shape[0] - 1).bit_length())
        remaining = q.remaining
        if n_pad > remaining.shape[0]:
            remaining = np.pad(
                remaining, ((0, n_pad - remaining.shape[0]), (0, 0)),
                constant_values=UNLIMITED,
            )
        dev = self.device
        admitted, wave_used = quota_admit(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (ns_ids, demand, remaining))
        )
        wu = wave_used.cpu().numpy()[: q.remaining.shape[0]]
        return admitted.cpu().numpy()[:b], (wu if wu.any() else None)

    def _quota_admission_delta(self, problems, ids, ns_ids, cache):
        """Delta admission, the JAX engine's rule
        (karmada_tpu/scheduler/core.py:760-882): a wave whose problem
        objects moved in a minority of positions within the same quota
        generation admits only the changed rows, through a complete K12
        launch over their own sub-batch against the working remaining,
        which already carries every earlier admitted row's debit. Unchanged
        rows replay their cached outcome and are not charged again. Returns
        (partition, debit), or None when the wave does not qualify (the
        caller runs the full admission). ``KARMADA_TPU_DELTA_SOLVE=0``
        turns it off, as in the JAX engine."""
        import os

        q = self.quota
        b = len(problems)
        if (
            cache is None
            or cache[1] != q.generation
            or len(cache[0]) != b
            or os.environ.get("KARMADA_TPU_DELTA_SOLVE", "1") == "0"
        ):
            return None
        ch = np.flatnonzero(ids != cache[0])
        if ch.size == 0 or ch.size * 2 > b:
            return None
        old_denied = cache[4]
        ns_ch = ns_ids[ch]
        demand = self._wave_demand([problems[int(i)] for i in ch], ns_ch)
        if demand.any():
            adm_ch, debit = self._admit(ns_ch, demand)
        else:
            # no changed row carries demand: all admit, nothing is charged
            adm_ch, debit = np.ones(ch.size, bool), None
        new_denied = np.union1d(
            np.setdiff1d(old_denied, ch), ch[~adm_ch]
        ).astype(np.int64)
        sub = None
        if new_denied.size and cache[2] is not None and np.array_equal(old_denied, new_denied):
            # the partition's shape is unchanged: the changed admitted rows
            # take their places in the previous sub-list
            sub = list(cache[2])
            ch_adm = ch[adm_ch]
            for s_i, i in zip(ch_adm - np.searchsorted(new_denied, ch_adm), ch_adm):
                sub[int(s_i)] = problems[int(i)]
        return self._partition(problems, ids, new_denied, sub), debit

    def _quota_cap_rows(self, problems) -> Optional[np.ndarray]:
        """int32[B] row into the cap tensor per binding (-1 = uncapped), or
        None when no binding is in a capped namespace."""
        q = self.quota
        if q is None or not q.has_caps:
            return None
        cap_index = q.cap_index
        rows = np.fromiter(
            (cap_index.get(p.namespace, -1) for p in problems), np.int32,
            len(problems),
        )
        return rows if (rows >= 0).any() else None

    def _quota_caps_np(self, cap_rows, requests) -> np.ndarray:
        """Host mirror of the cap estimate (``ops.cluster_caps_np``)."""
        return cluster_caps_np(self.quota.cluster_caps, cap_rows, requests)

    def _caps_device(self) -> torch.Tensor:
        """Device copy of the static-assignment cap tensor, uploaded again
        only when the quota snapshot's cap content changes."""
        q = self.quota
        if self._caps_dev is None or self._caps_dev_token != q.cap_token:
            self._caps_dev = torch.from_numpy(
                np.ascontiguousarray(q.cluster_caps, np.int64)
            ).to(self.device, copy=True)
            self._caps_dev_token = q.cap_token
        return self._caps_dev

    def _quota_caps_dev(self, cap_rows, requests) -> torch.Tensor:
        """K13's per-row form: int32[B, C] cap answers on ``device``."""
        dev = self.device
        return quota_cluster_caps(
            self._caps_device(),
            torch.from_numpy(np.ascontiguousarray(cap_rows, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(requests, np.int64)).to(dev),
        )

    def _profile_table_quota(
        self, profiles_np: np.ndarray, prof_ns: np.ndarray
    ) -> torch.Tensor:
        """``_profile_table`` with the static-assignment ceiling folded per
        (profile, cap namespace) slot by K13's fold form: the fleet's
        interned profiles carry a cap-namespace id beside the request
        vector, so the fleet divides against cap-bounded availability with
        no change to its kernels. A capped cell becomes min(the table's
        answer, or MAX_INT32 for no summary, and the cap); an uncapped cell
        keeps its answer, -1 included."""
        table = self._profile_table(profiles_np)
        q = self.quota
        prof_ns = np.asarray(prof_ns, np.int32)
        if q is None or not q.has_caps or not (prof_ns >= 0).any():
            return table
        dev = self.device
        return quota_caps_fold(
            table, self._caps_device(),
            torch.from_numpy(np.ascontiguousarray(prof_ns)).to(dev),
            torch.from_numpy(np.ascontiguousarray(profiles_np, np.int64)).to(dev),
        )

    # -- preemption plane ---------------------------------------------------

    _PREEMPT_PAD = 256  # pow2 floor of the padded row count, as in JAX

    def _preempt_pass(self, problems, results) -> list:
        """One armed-only preemption round: demanders are the wave's
        priority > 0 rows whose solve answered INSUFFICIENT_ERROR (a
        quota-denied row never gets here: it answered QUOTA_EXCEEDED);
        victims come from the armed resident pool. One K15 launch selects
        the victims over the demanders and the pool; the freed per-cluster
        capacity re-enters the divide in the same pass (``_resolve_boosted``)
        and the outcome lands in ``last_preemption``.

        Returns the results, as a plain list when a demander's row was
        replaced (the fleet route's lazy result list takes no item
        assignment), else the caller's object."""
        from ..ops.preempt import preempt_select
        from ..utils.tracing import tracer

        # the priority test first: a fleet pass's lazy results are built
        # only for the rows it cannot rule out
        demand_idx = [
            i for i, p in enumerate(problems)
            if p.priority > 0 and results[i].error == INSUFFICIENT_ERROR
        ]
        if not demand_idx:
            return results
        t0 = time.perf_counter()
        wave_keys = {p.key for p in problems}
        victims_pool = [
            v for v in (self.preempt_source(wave_keys) or ())
            if v.prev and sum(v.prev.values()) > 0
        ]
        outcome = PreemptionOutcome()
        self.last_preemption = outcome
        demanders = [problems[i] for i in demand_idx]
        if not victims_pool:
            outcome.still_unschedulable = [p.key for p in demanders]
            return results
        rows = demanders + victims_pool
        inputs, b_key = self._preempt_inputs(demanders, victims_pool)
        if not inputs["demand"].any() or not inputs["victim_ok"].any():
            outcome.still_unschedulable = [p.key for p in demanders]
            return results

        dev = self.device
        victims_dev, freed_caps_dev = preempt_select(
            *(torch.from_numpy(a).to(dev) for a in inputs.values()), b_key=b_key)
        victim_mask = victims_dev.cpu().numpy()
        freed_caps = freed_caps_dev.cpu().numpy()
        if not victim_mask.any():
            outcome.still_unschedulable = [p.key for p in demanders]
            tracer.record("scheduler.preempt", time.perf_counter() - t0,
                          demanders=len(demanders), victims=0)
            return results
        for i in np.flatnonzero(victim_mask):
            p = rows[int(i)]
            outcome.victims.append((p.key, dict(p.prev), int(p.priority)))
        outcome.freed_caps = freed_caps

        # one more batched solve over the demanders alone, against
        # availability on the boosted capacity
        compiled = [self._compiled(p.placement) for p in demanders]
        self.solve_batches += 1
        re_res = self._resolve_boosted(demanders, compiled, freed_caps)
        results = list(results)  # materialises a lazy fleet result list
        for i, res in zip(demand_idx, re_res):
            if res.success:
                results[i] = res
                outcome.placed.append(res.key)
            else:
                outcome.still_unschedulable.append(res.key)
        tracer.record("scheduler.preempt", time.perf_counter() - t0,
                      demanders=len(demanders), victims=len(outcome.victims))
        return results

    def _preempt_inputs(self, demanders, victims_pool) -> tuple[dict, int]:
        """K15's inputs (numpy, in its argument order) over ``demanders +
        victims_pool``, one row each, and the row count its packed sort
        keys are built with: JAX's padded row count, a power of two of at
        least ``_PREEMPT_PAD`` (JAX pads the rows themselves with
        priority-0 rows that demand and free nothing; the port passes the
        count alone). A demander's demand is its shortfall (a fresh row
        re-places everything, a scale-up demands only the delta) times its
        per-replica request; a victim frees its whole assignment."""
        from ..ops.quota import DEMAND_CLAMP
        from .quota import per_replica_vector

        snap = self.snapshot
        dims = list(snap.dims)
        r, c = len(dims), snap.num_clusters
        rows = list(demanders) + list(victims_pool)
        b = len(rows)
        b_key = max(1 << max(0, (b - 1).bit_length()), self._PREEMPT_PAD)
        prio = np.zeros(b, np.int32)
        demand = np.zeros((b, r), np.int64)
        freed = np.zeros((b, r), np.int64)
        victim_ok = np.zeros(b, bool)
        weight = np.zeros(b, np.int32)
        assigned = np.zeros((b, c), np.int32)
        requests = np.zeros((b, r), np.int64)

        def scaled(req_row, count: int) -> np.ndarray:
            # scale in Python ints (the quota demand rule): an absurd request
            # times a large count clamps instead of wrapping
            return np.fromiter((min(int(v) * count, DEMAND_CLAMP) for v in req_row),
                               np.int64, len(req_row))

        n_dem = len(demanders)
        for i, p in enumerate(rows):
            prio[i] = p.priority
            requests[i] = np.minimum(per_replica_vector(p.requests, dims), DEMAND_CLAMP)
            if i < n_dem:
                short = p.replicas - (0 if p.fresh else sum(p.prev.values()))
                if short > 0:
                    demand[i] = scaled(requests[i], int(short))
                continue
            total = 0
            for name, reps in p.prev.items():
                j = snap.index.get(name)
                if j is not None and reps > 0:
                    assigned[i, j] = reps
                    total += int(reps)
            if total > 0:
                weight[i] = min(total, 2**20 - 1)
                victim_ok[i] = True
                freed[i] = scaled(requests[i], total)
        return {"prio": prio, "demand": demand, "freed": freed, "victim_ok": victim_ok,
                "weight": weight, "assigned": assigned, "requests": requests}, b_key

    def _resolve_boosted(self, problems, compiled, freed_caps) -> list[ScheduleResult]:
        """Re-solve a demander batch against capacity boosted by the
        victims' freed resources: the host estimate mirror
        (``host_profile_table``) over ``available_cap + freed_caps``
        (out-of-tree estimators are not consulted: they read live member
        state, which cannot see a victim not yet evicted), static quota
        caps still folded (preemption never lifts a cap), the ordered
        affinity selection (K17 on the uploaded mirror), spread selection,
        and the numpy divider while its key fits int64, else K2."""
        from .spread import select_clusters_batch

        snap = self.snapshot
        boosted = _BoostedSnapshot(snap, freed_caps)
        mi = MAX_INT32
        out: list[ScheduleResult] = []
        for start in range(0, len(problems), self.chunk_size):
            chunk = problems[start : start + self.chunk_size]
            cchunk = compiled[start : start + self.chunk_size]
            base, strategy, replicas, static_w, requests, prev, fresh = (
                self._pack_chunk(chunk, cchunk, 0, with_affinity=False)
            )
            b = len(chunk)
            uniq, inv = np.unique(requests, axis=0, return_inverse=True)
            dense = host_profile_table(
                boosted, uniq, models_active=self._models_active()
            )[inv.reshape(-1)]
            cap_rows = self._quota_cap_rows(chunk)
            if cap_rows is not None:
                dense = np.minimum(dense, self._quota_caps_np(cap_rows, requests))
            reps_col = replicas.astype(np.int64)[:, None]
            avail = np.where(reps_col == 0, mi, dense)
            avail = np.where(avail == mi, reps_col, avail)
            avail = np.minimum(avail, mi).astype(np.int32)

            rank, feasible = self._select_groups(
                cchunk, b, base, avail, replicas, prev, strategy, fresh)
            candidates = select_clusters_batch(
                snap, chunk, cchunk, 0, feasible, avail, prev)
            wmax = int(max(int(avail.max(initial=0)) + int(prev.max(initial=0)),
                           int(static_w.max(initial=0)), 0))
            lmax = int(prev.max(initial=0)) + 1
            if (wmax + 1) * lmax * snap.num_clusters < 2**63:
                from ..refimpl.divider_np import assign_batch_np

                assignment, unschedulable = assign_batch_np(
                    strategy, replicas, candidates, static_w, avail, prev, fresh)
            else:
                res = self._assign(strategy, replicas, candidates, static_w,
                                   torch.from_numpy(avail).to(self.device), prev, fresh)
                assignment = res.assignment.cpu().numpy()
                unschedulable = res.unschedulable.cpu().numpy()
            out.extend(self._unpack(chunk, cchunk, rank, candidates,
                                    assignment, unschedulable))
        return out

    # -- placement provenance -----------------------------------------------

    def _capture_explain(self, problems, results) -> None:
        """One K14 launch per chunk over the host-composed stage masks; the
        captures go to the ExplainStore under the tracer's current wave."""
        from ..utils.tracing import tracer

        t0 = time.perf_counter()
        wave = tracer.current_context().wave
        for start in range(0, len(problems), self.chunk_size):
            chunk = problems[start : start + self.chunk_size]
            res = results[start : start + self.chunk_size]
            self.explain.add(self._explain_chunk(chunk, res, wave))
        tracer.record("scheduler.explain", time.perf_counter() - t0, rows=len(problems))

    def _explain_chunk(self, problems, results, wave: int):
        """One chunk's ExplainCapture: ``_explain_inputs``, then K14."""
        from ..ops.explain import explain_pass, topk_width
        from ..utils.explainstore import ExplainCapture

        inputs, group_rank = self._explain_inputs(problems, results)
        dev = self.device
        mask, topk = explain_pass(
            *(torch.from_numpy(a).to(dev) for a in inputs.values()),
            k=topk_width(self.snapshot.num_clusters),
        )
        return ExplainCapture(
            wave=wave,
            names=self.snapshot.names,
            keys=[p.key for p in problems],
            masks=mask.cpu().numpy(),
            topk=topk.cpu().numpy(),
            group_rank=group_rank,
            errors=[res.error for res in results],
            assignment=inputs["assignment"],
        )

    def _explain_inputs(self, problems, results) -> tuple[dict, np.ndarray]:
        """K14's composed inputs for one chunk (numpy, in its argument
        order) and the selected affinity-group rank per row. The stage masks
        carry the solve's own rules, kept per stage instead of AND-folded:
        already-placed taint/API leniency, evictions folded into the taint
        stage, the spread selection where a derived row exists, pre-cap
        availability (the host mirror, or the device merge when out-of-tree
        estimators answer), the cap stage, the admission stage, and the
        group that K17 (``first_fit_group``) selects on cap-folded
        availability. Out-of-tree custom filters have no stage and are not
        attributed. Every row is composed on its own, so a sub-list of a
        chunk composes to that sub-list's rows."""
        snap = self.snapshot
        disabled = self.disabled_plugins
        compiled = [self._compiled(p.placement) for p in problems]
        b, c = len(problems), snap.num_clusters

        cp_idx, unique_cps = unique_placements(compiled, b)
        spread_pl = np.stack([cp.spread_field_ok for cp in unique_cps])
        taint_pl = np.stack([cp.taint_ok for cp in unique_cps])
        api_gvk, gvk_idx = gvk_masks(snap, problems)

        replicas = np.fromiter((p.replicas for p in problems), np.int32, b)
        fresh = np.fromiter((p.fresh for p in problems), bool, b)
        strategy = np.fromiter((cp.strategy for cp in compiled), np.int32, b)
        r = len(snap.dims)
        prev = np.zeros((b, c), np.int32)
        evict = np.zeros((b, c), bool)
        preempted = np.zeros((b, c), bool)
        requests = np.zeros((b, r), np.int64)
        dim_index = {d: j for j, d in enumerate(snap.dims)}
        pods_dim = dim_index.get("pods")
        for i, p in enumerate(problems):
            for name, reps in p.prev.items():
                j = snap.index.get(name)
                if j is not None:
                    prev[i, j] = reps
            for name in p.evict_clusters:
                j = snap.index.get(name)
                if j is not None:
                    evict[i, j] = True
            for name in p.preempt_clusters:
                j = snap.index.get(name)
                if j is not None:
                    preempted[i, j] = True
            for d, q in p.requests.items():
                j = dim_index.get(d)
                if j is not None:
                    requests[i, j] = q
            if pods_dim is not None and p.replicas > 0:
                requests[i, pods_dim] = max(requests[i, pods_dim], 1)
        prev_mask = prev > 0

        taint_tol = taint_pl[cp_idx] | prev_mask
        if "TaintToleration" in disabled:
            taint_tol = np.ones((b, c), bool)
        if "ClusterEviction" in disabled:
            evict = np.zeros((b, c), bool)
        taint_ok = taint_tol & ~evict
        api_ok = api_gvk[gvk_idx] | (prev_mask & ~snap.complete_enablements[None, :])
        if "APIEnablement" in disabled:
            api_ok = np.ones((b, c), bool)
        spread_ok = spread_pl[cp_idx]
        if "SpreadConstraint" in disabled:
            spread_ok = np.ones((b, c), bool)
        else:
            # spread rows with a derived selection: the Select stage's
            # surviving set is the selection mask
            for i, (p, cp) in enumerate(zip(problems, compiled)):
                if len(cp.terms) == 1 and not cp.fleet_single_term:
                    hit = self._derived_rows.get(p.key)
                    if hit is not None and hit[1] is p.placement and hit[2] is not None:
                        spread_ok[i] = spread_ok[i] & hit[2].terms[0][1]

        def merged(cap_rows):
            if self.extra_estimators:
                return self._availability(requests, replicas, cap_rows).cpu().numpy()
            return self._availability_np(requests, replicas, cap_rows)

        # pre-cap merged availability: the cap is its own stage
        avail = merged(None)
        cap_rows = self._quota_cap_rows(problems)
        caps = (self._quota_caps_np(cap_rows, requests).astype(np.int32)
                if cap_rows is not None else np.full((b, c), MAX_INT32, np.int32))

        dynamic = (strategy == DYNAMIC_WEIGHT) | (strategy == AGGREGATED)
        admitted = np.fromiter((res.error != QUOTA_EXCEEDED_ERROR for res in results), bool, b)
        assignment = np.zeros((b, c), np.int32)
        for i, res in enumerate(results):
            for name, n_assigned in res.clusters.items():
                j = snap.index.get(name)
                if j is not None:
                    assignment[i, j] = n_assigned

        # the selected affinity group, by the ranked path's own predicate
        # on the cap-folded availability the ranked solve ranks on
        tmax = max(len(cp.terms) for cp in unique_cps)
        if tmax > 1 and "ClusterAffinity" not in disabled:
            avail_rank = avail if cap_rows is None else merged(cap_rows)
            # aff_ok is the selected term's mask alone: the other stages
            # keep their own masks
            group_rank, aff_ok = self._select_groups(
                compiled, b, taint_ok & api_ok & spread_ok, avail_rank, replicas,
                prev, strategy, fresh, with_base=False)
        else:
            group_rank = np.zeros(b, np.int32)
            aff_ok = np.stack([cp.terms[0][1] for cp in unique_cps])[cp_idx]
            if "ClusterAffinity" in disabled:
                aff_ok = np.ones((b, c), bool)

        inputs = {
            "aff_ok": aff_ok, "taint_ok": taint_ok, "api_ok": api_ok,
            "spread_ok": spread_ok, "avail": avail.astype(np.int32), "caps": caps,
            "admitted": admitted, "dynamic": dynamic, "replicas": replicas,
            "assignment": assignment, "prev": prev, "preempted": preempted,
        }
        return {k: np.ascontiguousarray(v) for k, v in inputs.items()}, group_rank

    def _schedule_inner(
        self, problems: Sequence[BindingProblem]
    ) -> list[ScheduleResult]:
        import time

        # estimator-backed batch-identity fast path: extra estimators force
        # the host path, but re-scheduling the SAME problem objects against
        # the SAME snapshot generation is pure in (problems, snapshot,
        # estimator answers), and a registry-backed estimator can PROVE its
        # answers unchanged via refresh_token; any unprovable estimator
        # falls through to the full path
        if (
            self._est_batch is not None
            and self.extra_estimators
            and not self.custom_filters
        ):
            ids0, gen0, est_ids0, tokens0, results0, _pinned = self._est_batch
            if (
                gen0 == self._snapshot_gen
                and len(problems) == len(results0)
                and est_ids0 == tuple(map(id, self.extra_estimators))
            ):
                t0 = time.perf_counter()
                ids = np.fromiter(map(id, problems), np.int64, len(problems))
                if np.array_equal(ids, ids0):
                    tokens = self._est_tokens()
                    if None not in tokens and tokens == tokens0:
                        self.last_breakdown = {"compile": time.perf_counter() - t0}
                        return list(results0)

        # batch-identity fast path: re-scheduling the SAME problem objects
        # against the same snapshot generation (or, for spread-free
        # batches, the same filter fields) is pure in those inputs, so one
        # id() sweep replaces compilation, selection and the eligibility
        # partition. Like the fleet's per-row fast path, it assumes problem
        # objects are not mutated in place between passes.
        if (
            self._batch_ids is not None
            and (
                self._batch_gen == self._snapshot_gen
                or (
                    not self._batch_spread
                    and self._batch_token == self.snapshot.mask_token
                )
            )
            and not (self.custom_filters or self.extra_estimators
                     or self.disabled_plugins)
            and len(problems) == len(self._batch_ids)
        ):
            t0 = time.perf_counter()
            ids = np.fromiter(map(id, problems), np.int64, len(problems))
            if np.array_equal(ids, self._batch_ids) and not self._dirty_keys:
                self.last_breakdown = {"compile": time.perf_counter() - t0}
                fp, fc = self._batch_cache
                self.solve_batches += 1
                res = self._fleet.schedule(fp, fc)
                self.last_breakdown.update(self._fleet.last_breakdown)
                return res

        t0 = time.perf_counter()
        compiled = [self._compiled(p.placement) for p in problems]
        self.last_breakdown = {"compile": time.perf_counter() - t0}
        # engine-level features the fleet does not model force the host
        # path for the whole batch
        if not (self.custom_filters or self.extra_estimators or self.disabled_plugins):
            from .fleet import K_PREV, MAX_REPLICAS_FAST

            t0 = time.perf_counter()
            compiled = self._derive_spread_selections(problems, compiled)
            self.last_breakdown["select"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            # THE fleet-eligibility predicate (the JAX engine's, inline: it
            # runs once per row per pass)
            fast_idx = [
                i
                for i, (p, cp) in enumerate(zip(problems, compiled))
                if cp.fleet_single_term
                and not p.evict_clusters
                and len(p.prev) <= K_PREV
                and (cp.strategy == DUPLICATED or p.replicas <= MAX_REPLICAS_FAST)
            ]
            self.last_breakdown["eligible"] = time.perf_counter() - t0
            if len(fast_idx) >= self.fleet_threshold:
                from .fleet import FleetTable

                if self._fleet is not None and self._fleet.slots_exhausted:
                    import sys

                    print("# fleet table rebuild: "
                          + self._fleet.exhaustion_summary(),
                          file=sys.stderr, flush=True)
                    self._fleet = None
                if self._fleet is None:
                    self._fleet = FleetTable(self)
                fp = [problems[i] for i in fast_idx]
                fc = [compiled[i] for i in fast_idx]
                self.solve_batches += 1
                fast_res = self._fleet.schedule(fp, fc)
                self.last_breakdown.update(self._fleet.last_breakdown)
                if len(fast_idx) == len(problems):
                    # all rows rode the fleet: hand back the lazy result
                    # list, and arm the batch-identity fast path (fp/fc are
                    # the list objects the fleet keys its own reuse on)
                    self._batch_ids = np.fromiter(map(id, fp), np.int64, len(fp))
                    self._batch_gen = self._snapshot_gen
                    self._batch_cache = (fp, fc)
                    self._batch_spread = any(
                        getattr(cp, "derived", False) for cp in fc
                    )
                    self._batch_token = self.snapshot.mask_token
                    return fast_res
                results: list = [None] * len(problems)
                for i, res in zip(fast_idx, fast_res):
                    results[i] = res
                slow_idx = [i for i in range(len(problems)) if results[i] is None]
                if slow_idx:
                    slow_res = self._schedule_host(
                        [problems[i] for i in slow_idx],
                        [compiled[i] for i in slow_idx],
                    )
                    for i, res in zip(slow_idx, slow_res):
                        results[i] = res
                return results
        res = self._schedule_host(problems, compiled)
        self._arm_est_batch(problems, res)
        return res

    def _est_tokens(self) -> tuple:
        """One refresh_token probe per extra estimator (None for
        estimators without the protocol)."""
        tokens = []
        for est in self.extra_estimators:
            probe = getattr(est, "refresh_token", None)
            tokens.append(probe() if probe is not None else None)
        return tuple(tokens)

    def _arm_est_batch(self, problems, res) -> None:
        """Arm the estimator-backed batch-identity fast path after a full
        host-path pass: cache the results keyed by problem ids, snapshot
        generation and each estimator's confirm token. The problems list is
        pinned so a recycled id() cannot alias a stale batch."""
        if not self.extra_estimators or self.custom_filters:
            return
        tokens = self._est_tokens()
        if None in tokens:
            self._est_batch = None
            return
        self._est_batch = (
            np.fromiter(map(id, problems), np.int64, len(problems)),
            self._snapshot_gen,
            tuple(map(id, self.extra_estimators)),
            tokens,
            list(res),
            list(problems),
        )

    def _derive_spread_selections(
        self,
        problems: Sequence[BindingProblem],
        compiled: list[CompiledPlacement],
    ) -> list[CompiledPlacement]:
        """Replace each single-term spread-constraint row's compiled
        placement by a DERIVED one whose affinity term is the selected
        candidate set (SelectClusters folded into placement compilation),
        which makes the row fleet-eligible. Selection runs on the host as
        the general path's Select stage does; rows it rejects keep their
        placement and fall through to the host path, which reports the
        failure. Selections are memoized per binding key (pure in snapshot
        generation, placement, replicas, requests and prev) and per
        selection content."""
        from .spread import select_clusters_batch

        spread_idx = [
            i for i, cp in enumerate(compiled)
            if len(cp.terms) == 1 and not cp.fleet_single_term
        ]
        if not spread_idx:
            return compiled
        compiled = list(compiled)
        snap = self.snapshot
        gen = self._snapshot_gen
        cache = self._selection_cache
        row_cache = self._derived_rows
        pending: list[int] = []
        for i in spread_idx:
            p = problems[i]
            fp = (gen, id(p.placement), p.replicas,
                  tuple(p.requests.items()), tuple(p.prev.items()))
            hit = row_cache.get(p.key)
            # hit[1] pins the Placement whose id() the fingerprint embeds
            if hit is not None and hit[0] == fp and hit[1] is p.placement:
                if hit[2] is not None:
                    compiled[i] = hit[2]
                continue  # None = cached FitError: stays on the host path
            pending.append(i)
        if not pending:
            return compiled

        for start in range(0, len(pending), self.chunk_size):
            idx = pending[start : start + self.chunk_size]
            sub_p = [problems[i] for i in idx]
            sub_c = [compiled[i] for i in idx]
            feasible, _strat, replicas, _sw, requests, prev, _fr = (
                self._pack_chunk(sub_p, sub_c, 0)
            )
            avail = self._selection_availability(requests, replicas, gen)
            # static-assignment caps bound the selection's availability too:
            # groups rank on the numbers the divide will see
            cap_rows = self._quota_cap_rows(sub_p)
            if cap_rows is not None:
                avail = np.minimum(
                    avail, self._quota_caps_np(cap_rows, requests)
                ).astype(np.int32)
            candidates = select_clusters_batch(
                snap, sub_p, sub_c, 0, feasible, avail, prev
            )
            for k, i in enumerate(idx):
                p = problems[i]
                fp = (gen, id(p.placement), p.replicas,
                      tuple(p.requests.items()), tuple(p.prev.items()))
                sel = candidates[k]
                if not sel.any():
                    row_cache[p.key] = (fp, p.placement, None)
                    continue
                base = compiled[i]
                key = (id(base), sel.tobytes())
                entry = cache.get(key)
                if entry is None:
                    c = snap.num_clusters
                    derived = CompiledPlacement(
                        placement=base.placement,
                        terms=[(base.terms[0][0], sel.copy())],
                        # selection already ran on the post-filter set;
                        # all-true keeps the fleet's leniency re-composition
                        # idempotent
                        taint_ok=np.ones(c, bool),
                        spread_field_ok=np.ones(c, bool),
                        strategy=base.strategy,
                        static_weights=base.static_weights,
                        spread_constraints=[],
                        fleet_single_term=True,
                    )
                    derived.derived = True  # the fleet keys rows on id(derived)
                    if len(cache) >= self.SELECTION_CACHE_CAP:
                        cache.clear()
                    cache[key] = (derived, base)  # pin base: the key embeds id(base)
                else:
                    derived = entry[0]
                compiled[i] = derived
                row_cache[p.key] = (fp, p.placement, derived)
        if len(row_cache) > 4 * max(len(problems), 1) + 65536:
            row_cache.clear()  # key-churn bound; repopulates next pass
        return compiled

    def _selection_availability(
        self, requests: np.ndarray, replicas: np.ndarray, gen: int
    ) -> np.ndarray:
        """Per-row availability for the Select stage from a per-profile
        cache (one device table fetch per NEW request profile per snapshot
        generation), with merge_estimates' semantics: -1 ignored, the
        sentinel clamped to spec.Replicas, zero-replica rows zero."""
        if self._sel_profile_gen != gen:
            self._sel_profile_gen = gen
            self._sel_profile_rows.clear()
        uniq, inv = np.unique(requests, axis=0, return_inverse=True)
        missing = [
            u for u in range(len(uniq))
            if uniq[u].tobytes() not in self._sel_profile_rows
        ]
        if missing:
            table = (
                self._profile_table(uniq[np.asarray(missing)])
                .cpu().numpy().astype(np.int64)
            )
            for row, u in enumerate(missing):
                self._sel_profile_rows[uniq[u].tobytes()] = table[row]
        dense = np.stack(
            [self._sel_profile_rows[uniq[u].tobytes()] for u in range(len(uniq))]
        )[inv.reshape(-1)]
        reps_col = replicas.astype(np.int64)[:, None]
        avail = np.where(
            dense == MAX_INT32, reps_col, np.where(dense < 0, reps_col, dense)
        )
        avail = np.where(reps_col == 0, 0, avail)
        return np.minimum(avail, MAX_INT32).astype(np.int32)

    def _profile_table(self, profiles_np: np.ndarray) -> torch.Tensor:
        """int32[P, C] general+model availability per unique request
        profile, -1 where the cluster gives no answer: K1's table form on
        ``device``, then K7's overlay form when the model estimator is
        active. The shared estimator core of the fleet path, spread
        selection and ``_availability``."""
        cap, has_summary = self._device_state()
        profiles = torch.from_numpy(
            np.ascontiguousarray(profiles_np, np.int64)
        ).to(self.device)
        table = profile_table(cap, profiles, has_summary)
        if self._models_active():
            min_bounds, counts, covered, has_models = self._device_models()
            pods_dim = self.snapshot.dim_index("pods")
            model_overlay(table, min_bounds, counts, covered, profiles,
                          has_models, has_summary, cap,
                          -1 if pods_dim is None else pods_dim)
        return table

    def _schedule_host(
        self,
        problems: Sequence[BindingProblem],
        compiled: list[CompiledPlacement],
    ) -> list[ScheduleResult]:
        """Ordered ClusterAffinities dispatch (JAX: _schedule_host_rounds).
        A multi-term batch takes the ranked path: each row's first fitting
        group is selected in one vectorized pass (``first_fit_group``) and
        the chunk solves once. Multi-term rows that also carry spread
        constraints keep the per-round loop; a single-term batch takes the
        one-round path."""
        max_terms = max((len(cp.terms) for cp in compiled), default=1)
        if max_terms <= 1:
            return self._schedule_round_loop(problems, compiled)
        legacy_idx = [
            i for i, cp in enumerate(compiled)
            if len(cp.terms) > 1 and cp.spread_constraints
        ]
        if not legacy_idx:
            return self._schedule_ranked(problems, compiled)
        legacy = set(legacy_idx)
        ranked_idx = [i for i in range(len(problems)) if i not in legacy]
        results: list = [None] * len(problems)
        for idx, solve in ((ranked_idx, self._schedule_ranked),
                           (legacy_idx, self._schedule_round_loop)):
            out = solve([problems[i] for i in idx], [compiled[i] for i in idx])
            for i, res in zip(idx, out):
                results[i] = res
        return results

    def _schedule_ranked(
        self,
        problems: Sequence[BindingProblem],
        compiled: list[CompiledPlacement],
    ) -> list[ScheduleResult]:
        out: list[ScheduleResult] = []
        for start in range(0, len(problems), self.chunk_size):
            out.extend(self._schedule_chunk_ranked(
                list(problems[start : start + self.chunk_size]),
                compiled[start : start + self.chunk_size],
            ))
        return out

    def _schedule_round_loop(
        self,
        problems: Sequence[BindingProblem],
        compiled: list[CompiledPlacement],
    ) -> list[ScheduleResult]:
        results: list[Optional[ScheduleResult]] = [None] * len(problems)
        max_terms = max((len(cp.terms) for cp in compiled), default=1)

        pending = list(range(len(problems)))
        for term_round in range(max_terms):
            if not pending:
                break
            in_round = [i for i in pending if term_round < len(compiled[i].terms)]
            if not in_round:
                break
            round_results = self._schedule_round(
                [problems[i] for i in in_round],
                [compiled[i] for i in in_round],
                term_round,
            )
            next_pending = []
            for i, res in zip(in_round, round_results):
                has_more = term_round + 1 < len(compiled[i].terms)
                if res.success or not has_more:
                    results[i] = res
                else:
                    next_pending.append(i)  # FitError -> try next group
            # bindings whose term list was exhausted before this round keep
            # their last failure. A set, not the list: the JAX engine's
            # `i not in in_round` scan (core.py:2128) is O(B^2) — about a
            # minute a pass at 100k rows
            in_round_set = set(in_round)
            for i in pending:
                if i not in in_round_set and results[i] is None:
                    results[i] = ScheduleResult(
                        key=problems[i].key, error="no affinity group fits"
                    )
            pending = next_pending
        for i, res in enumerate(results):
            if res is None:
                results[i] = ScheduleResult(key=problems[i].key, error="not scheduled")
        return results  # type: ignore[return-value]

    # -- internals ---------------------------------------------------------

    def _schedule_round(
        self,
        problems: list[BindingProblem],
        compiled: list[CompiledPlacement],
        term_round: int,
    ) -> list[ScheduleResult]:
        out: list[ScheduleResult] = []
        for start in range(0, len(problems), self.chunk_size):
            chunk = problems[start : start + self.chunk_size]
            cchunk = compiled[start : start + self.chunk_size]
            out.extend(self._schedule_chunk(chunk, cchunk, term_round))
        return out

    def _pack_chunk(
        self,
        problems: list[BindingProblem],
        compiled: list[CompiledPlacement],
        term_round: int,
        with_affinity: bool = True,
    ):
        """Vectorized packing: per-binding work is O(sparse entries); the
        O(B x C) mask algebra happens once per *unique* placement/GVK and is
        gathered by row. ``with_affinity=False`` leaves the affinity term out
        of the mask (the ranked path composes every term itself)."""
        snap = self.snapshot
        b, c, r = len(problems), snap.num_clusters, len(snap.dims)
        dim_index = {d: j for j, d in enumerate(snap.dims)}
        disabled = self.disabled_plugins

        # --- unique placements -> stacked per-placement masks -------------
        cp_idx, unique_cps = unique_placements(compiled, b)
        aff_pl = np.stack(
            [cp.terms[min(term_round, len(cp.terms) - 1)][1] for cp in unique_cps]
        )
        spread_pl = np.stack([cp.spread_field_ok for cp in unique_cps])
        taint_pl = np.stack([cp.taint_ok for cp in unique_cps])
        static_pl = np.stack([cp.static_weights for cp in unique_cps])
        strategy = np.array([cp.strategy for cp in unique_cps], np.int32)[cp_idx]

        # --- unique GVKs -> per-GVK enablement masks ----------------------
        api_gvk, gvk_idx = gvk_masks(snap, problems)

        # --- sparse per-binding state -------------------------------------
        replicas = np.fromiter((p.replicas for p in problems), np.int32, b)
        fresh = np.fromiter((p.fresh for p in problems), bool, b)
        prev = np.zeros((b, c), np.int32)
        evict = np.zeros((b, c), bool)
        requests = np.zeros((b, r), np.int64)
        pods_dim = dim_index.get("pods")
        for i, p in enumerate(problems):
            for name, reps in p.prev.items():
                j = snap.index.get(name)
                if j is not None:
                    prev[i, j] = reps
            for name in p.evict_clusters:
                j = snap.index.get(name)
                if j is not None:
                    evict[i, j] = True
            for d, q in p.requests.items():
                j = dim_index.get(d)
                if j is not None:
                    requests[i, j] = q
            if pods_dim is not None and p.replicas > 0:
                # each replica occupies a pod (getAllowedPodNumber)
                requests[i, pods_dim] = max(requests[i, pods_dim], 1)
        prev_mask = prev > 0

        # --- mask composition (api_enablement.go / taint_toleration.go
        # leniency for already-placed clusters) -----------------------------
        feasible = np.ones((b, c), bool)
        if with_affinity and "ClusterAffinity" not in disabled:
            feasible &= aff_pl[cp_idx]
        if "SpreadConstraint" not in disabled:
            feasible &= spread_pl[cp_idx]
        if "APIEnablement" not in disabled:
            feasible &= api_gvk[gvk_idx] | (
                prev_mask & ~snap.complete_enablements[None, :]
            )
        if "TaintToleration" not in disabled:
            feasible &= taint_pl[cp_idx] | prev_mask
        if "ClusterEviction" not in disabled:
            feasible &= ~evict
        for custom in self.custom_filters:
            feasible &= np.asarray(custom(snap, problems), bool)
        static_w = static_pl[cp_idx]
        return feasible, strategy, replicas, static_w, requests, prev, fresh

    def _models_active(self) -> bool:
        """Whether the resource-model estimator would answer (the JAX
        engine's predicate, core.py:2320)."""
        return bool(
            feature_gate.enabled(CUSTOMIZED_CLUSTER_RESOURCE_MODELING)
            and np.asarray(self.snapshot.model_pack.has_models).any()
        )

    def _availability_np(
        self,
        requests: np.ndarray,
        replicas: np.ndarray,
        cap_rows: Optional[np.ndarray] = None,
        extras: Sequence[np.ndarray] = (),
    ) -> np.ndarray:
        """Host mirror of ``_availability`` for the tiny-batch path: the
        shared ``host_profile_table``, min-merged with the static-assignment
        caps of ``cap_rows`` (``ops.cluster_caps_np``) and with each of
        ``extras`` (int32[B, C], -1 = no answer), plus merge_estimates'
        exact sentinel semantics (no-summary -> no answer -> clamp to
        spec.Replicas; zero-replica short-circuit). The engine passes no
        extras (it never takes this path with estimators); a host check of
        the general route passes their answers."""
        mi = MAX_INT32
        uniq, inv = np.unique(requests, axis=0, return_inverse=True)
        dense = host_profile_table(
            self.snapshot, uniq, models_active=self._models_active()
        )[inv.reshape(-1)]
        if cap_rows is not None:
            dense = np.minimum(dense, self._quota_caps_np(cap_rows, requests))
        for e in extras:
            e = np.asarray(e).astype(np.int64)
            dense = np.where(e == -1, dense, np.minimum(dense, e))
        reps_col = replicas.astype(np.int64)[:, None]
        avail = np.where(reps_col == 0, mi, dense)
        avail = np.where(avail == mi, reps_col, avail)
        return np.minimum(avail, mi).astype(np.int32)

    def _device_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(available_cap int64[C, R], has_summary bool[C]) on the device,
        uploaded once per snapshot generation."""
        st = self._dev_state
        if st is None or st[0] != self._snapshot_gen:
            snap = self.snapshot
            st = (
                self._snapshot_gen,
                torch.from_numpy(np.ascontiguousarray(snap.available_cap, np.int64)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(snap.has_summary, bool)).to(self.device),
            )
            self._dev_state = st
        return st[1], st[2]

    def _device_models(self) -> tuple[torch.Tensor, ...]:
        """(min_bounds int64[C, G, R], counts int32[C, G], covered bool[C, R],
        has_models bool[C]) on the device, uploaded once per snapshot
        generation when the model estimator is active."""
        st = self._dev_models
        if st is None or st[0] != self._snapshot_gen:
            mp = self.snapshot.model_pack
            st = (self._snapshot_gen,) + tuple(
                torch.from_numpy(np.ascontiguousarray(a, dt)).to(self.device)
                for a, dt in ((mp.min_bounds, np.int64), (mp.counts, np.int32),
                              (mp.covered, bool), (mp.has_models, bool))
            )
            self._dev_models = st
        return st[1:]

    def _availability(
        self,
        requests: np.ndarray,
        replicas: np.ndarray,
        cap_rows: Optional[np.ndarray] = None,
    ) -> torch.Tensor:
        """calAvailableReplicas (core/util.go:54-104) on the device: request
        rows are interned host-side (np.unique). With the general estimator
        alone, K1 computes the estimate per unique profile, masks
        no-summary clusters, gathers the rows and merges — one launch. With
        the resource-model estimator, static-assignment caps (``cap_rows``)
        or extra estimators, the profile table (``_profile_table``: K1's
        table form and K7's overlay) is gathered and min-merged with K13's
        cap answer and every extra estimate by K1's merge form. Returns
        int32[B, C] on ``device``."""
        n_extras = len(self.extra_estimators) + (cap_rows is not None)
        profiles, prof_inv = np.unique(requests, axis=0, return_inverse=True)
        dev = self.device
        inv = torch.from_numpy(prof_inv.reshape(-1).astype(np.int32)).to(dev)
        reps = torch.from_numpy(np.ascontiguousarray(replicas, np.int32)).to(dev)
        if not (n_extras or self._models_active()):
            cap, has_summary = self._device_state()
            return estimate_merge(
                cap,
                torch.from_numpy(np.ascontiguousarray(profiles, np.int64)).to(dev),
                inv, has_summary, reps,
            )
        table = self._profile_table(profiles)
        extras = []
        if cap_rows is not None:
            extras.append(self._quota_caps_dev(cap_rows, requests))
        if self.extra_estimators:
            # out-of-tree estimators see the full per-binding requests
            req = torch.from_numpy(np.ascontiguousarray(requests, np.int64)).to(dev)
            for est in self.extra_estimators:
                ans = est(req, reps)
                if not isinstance(ans, torch.Tensor):
                    ans = torch.from_numpy(np.asarray(ans))
                extras.append(ans.to(device=dev, dtype=torch.int32).contiguous())
        return estimate_merge_table(table, inv, tuple(extras), reps)

    def _schedule_chunk(
        self,
        problems: list[BindingProblem],
        compiled: list[CompiledPlacement],
        term_round: int,
    ) -> list[ScheduleResult]:
        padded, (feasible, strategy, replicas, static_w, requests, prev, fresh) = (
            self._pad_chunk(self._pack_chunk(problems, compiled, term_round))
        )
        host_small, avail = self._chunk_availability(problems, requests, replicas, padded)

        from .spread import select_clusters_batch  # local import (cycle-free)

        # avail stays on the device unless a row carries spread constraints
        candidates = select_clusters_batch(
            self.snapshot, problems, compiled, term_round, feasible, avail, prev,
        )
        assignment, unschedulable = self._solve_chunk(
            host_small, strategy, replicas, candidates, static_w, avail, prev, fresh)
        return self._unpack(problems, compiled, term_round, candidates,
                            assignment, unschedulable)

    def _pad_chunk(self, packed: tuple) -> tuple[int, list]:
        """Pad ``_pack_chunk``'s arrays along the binding axis to the next
        power of two (capped at the chunk size); pad rows are no-candidate
        zero-replica bindings. Returns (padded rows, arrays)."""
        b = len(packed[0])
        padded = 1
        while padded < b:
            padded *= 2
        padded = min(padded, self.chunk_size)
        if padded == b:
            return padded, list(packed)
        return padded, [
            np.pad(a, ((0, padded - b),) + ((0, 0),) * (a.ndim - 1)) for a in packed
        ]

    def _chunk_availability(self, problems, requests, replicas, padded):
        """(host_small, avail) of one padded chunk. Tiny batches (``padded *
        C <= 2**16`` with no out-of-tree estimator: the JAX engine's own
        rule) take the numpy mirror, whose placements are identical; the
        others the device. Static-assignment caps of the chunk's rows fold
        in on both."""
        host_small = (
            padded * self.snapshot.num_clusters <= 1 << 16
            and not self.extra_estimators
        )
        cap_rows = self._quota_cap_rows(problems)
        if cap_rows is not None and padded > len(problems):
            cap_rows = np.pad(cap_rows, (0, padded - len(problems)), constant_values=-1)
        if host_small:
            return True, self._availability_np(requests, replicas, cap_rows)
        return False, self._availability(requests, replicas, cap_rows)

    def _solve_chunk(self, host_small, strategy, replicas, candidates, static_w,
                     avail, prev, fresh, prev_dev=None) -> tuple[np.ndarray, np.ndarray]:
        """(assignment, unschedulable) of one padded chunk: the numpy divider
        for a tiny batch whose (weight, last, index) key fits one int64,
        else K2 on the device (uploading a host ``avail`` first, and ``prev``
        unless ``prev_dev`` holds its upload)."""
        if host_small:
            wmax = int(max(int(avail.max(initial=0)) + int(prev.max(initial=0)),
                           int(static_w.max(initial=0)), 0))
            lmax = int(prev.max(initial=0)) + 1
            host_small = (wmax + 1) * lmax * self.snapshot.num_clusters < 2**63
            if not host_small:
                avail = torch.from_numpy(avail).to(self.device)
        self.solve_batches += 1
        if host_small:
            from ..refimpl.divider_np import assign_batch_np

            return assign_batch_np(
                strategy, replicas, candidates, static_w, avail, prev, fresh)
        res = self._assign(strategy, replicas, candidates, static_w, avail, prev, fresh,
                           prev_dev=prev_dev)
        # the chunk's one device->host copy of the result
        return res.assignment.cpu().numpy(), res.unschedulable.cpu().numpy()

    def _schedule_chunk_ranked(
        self,
        problems: list[BindingProblem],
        compiled: list[CompiledPlacement],
    ) -> list[ScheduleResult]:
        """One chunk of the ordered-failover path: each row's first fitting
        affinity group picked on the device by K17 (``ops.masks.
        first_fit_group``, the divider's exact schedulability predicate) from
        the row's base mask, its placement's term masks and the merged
        availability, which stays on the device; then one solve of the
        whole chunk against the selected masks."""
        padded, (base, strategy, replicas, static_w, requests, prev, fresh) = (
            self._pad_chunk(self._pack_chunk(problems, compiled, 0, with_affinity=False))
        )
        host_small, avail = self._chunk_availability(problems, requests, replicas, padded)
        prev_dev = _upload(prev, np.int32, self.device)
        rank, feasible = self._select_groups(
            compiled, padded, base, avail, replicas, prev_dev, strategy, fresh)
        from .spread import select_clusters_batch  # local import (cycle-free)

        # spread selection still narrows single-term spread rows
        candidates = select_clusters_batch(
            self.snapshot, problems, compiled, 0, feasible, avail, prev)
        assignment, unschedulable = self._solve_chunk(
            host_small, strategy, replicas, candidates, static_w, avail, prev, fresh,
            prev_dev=prev_dev)
        return self._unpack(problems, compiled, rank, candidates,
                            assignment, unschedulable)

    def _select_groups(self, compiled, rows, base, avail, replicas, prev, strategy,
                       fresh, with_base=True) -> tuple[np.ndarray, np.ndarray]:
        """(rank int32[rows], selected bool[rows, C]) on the host: K17 on the
        engine's device over ``_group_inputs``."""
        from ..ops.masks import first_fit_group

        rank, _fit, selected = first_fit_group(
            *self._group_inputs(compiled, rows, base, avail, replicas, prev, strategy,
                                fresh),
            with_base=with_base)
        return rank.cpu().numpy(), selected.cpu().numpy()

    def _group_inputs(self, compiled, rows, base, avail, replicas, prev, strategy,
                      fresh) -> tuple[torch.Tensor, ...]:
        """K17's nine inputs on the engine's device, in its argument order:
        the rows' base masks, their placements' ClusterAffinities term masks
        (every term true when the plugin is disabled; rows past
        ``len(compiled)`` take placement 0) and live-term counts, and the
        rows' availability, replicas, previous placements and cohort flags.
        ``avail`` and ``prev`` may already lie on the device; the others are
        uploaded once."""
        cp_idx, unique_cps = unique_placements(compiled, rows)
        terms, term_len = term_stack(unique_cps, self.snapshot.num_clusters)
        if "ClusterAffinity" in self.disabled_plugins:
            terms[:] = True
        dev = self.device
        dynamic = (strategy == DYNAMIC_WEIGHT) | (strategy == AGGREGATED)
        return (
            _upload(base, bool, dev), _upload(terms, bool, dev),
            _upload(cp_idx, np.int32, dev), _upload(term_len, np.int32, dev),
            _upload(avail, np.int32, dev), _upload(replicas, np.int32, dev),
            _upload(prev, np.int32, dev), _upload(dynamic, bool, dev),
            _upload(fresh, bool, dev))

    def _assign(self, strategy, replicas, candidates, static_w, avail, prev, fresh,
                prev_dev=None):
        """K2 over one padded chunk; ``avail`` is already on the device, and
        so is ``prev`` when ``prev_dev`` holds its upload."""
        max_n = int(replicas.max(initial=0))
        c = candidates.shape[1] if candidates.ndim == 2 else 1
        wide, fast = kernel_variant(
            int(avail.max().item()) if avail.numel() else 0,  # device sync
            int(static_w.max(initial=0)),
            int(prev.max(initial=0)),
            max_n,
            c,
        )
        dev = self.device
        return divide_replicas(
            _upload(strategy, np.int32, dev),
            _upload(replicas, np.int32, dev),
            _upload(candidates, bool, dev),
            _upload(static_w, np.int32, dev),
            avail,
            _upload(prev if prev_dev is None else prev_dev, np.int32, dev),
            _upload(fresh, bool, dev),
            has_aggregated=bool((strategy == AGGREGATED).any()),
            wide=wide,
            fast=fast,
        )

    def _unpack(
        self, problems, compiled, term_round, candidates, assignment, unschedulable
    ) -> list[ScheduleResult]:
        """Vectorized result building: one np.nonzero over the whole chunk
        replaces per-binding scans; the feasible-cluster tuple is only
        materialized for zero-replica (non-workload) bindings.
        ``term_round`` is the round's term index, or an int array of each
        row's selected term (the ranked path), which names the row's
        ``affinity_name``."""
        snap = self.snapshot
        names = snap.names
        b = len(problems)
        has_candidates = candidates[:b].any(axis=1)
        rows, cols = np.nonzero(assignment[:b] > 0)
        boundaries = np.searchsorted(rows, np.arange(1, b))
        per_row = np.split(cols, boundaries)
        out = []
        per_row_term = isinstance(term_round, np.ndarray)
        for i, p in enumerate(problems):
            tr = int(term_round[i]) if per_row_term else term_round
            term_idx = min(tr, len(compiled[i].terms) - 1)
            term_name = compiled[i].terms[term_idx][0]
            if not has_candidates[i]:
                out.append(
                    ScheduleResult(
                        key=p.key,
                        affinity_name=term_name,
                        error="no clusters fit the placement",
                    )
                )
                continue
            if unschedulable[i]:
                out.append(
                    ScheduleResult(
                        key=p.key,
                        affinity_name=term_name,
                        error=INSUFFICIENT_ERROR,
                    )
                )
                continue
            row = assignment[i]
            placed = {names[j]: int(row[j]) for j in per_row[i]}
            feasible = (
                tuple(names[j] for j in np.flatnonzero(candidates[i]))
                if p.replicas == 0
                else ()
            )
            out.append(
                ScheduleResult(
                    key=p.key,
                    clusters=placed,
                    feasible=feasible,
                    affinity_name=term_name,
                )
            )
        return out
