"""Scheduler process: binding events -> TensorScheduler -> spec.clusters.

The port's own copy of ``karmada_tpu/controllers/scheduler_controller.py``.
Ref: pkg/scheduler/scheduler.go — the event-driven loop (:295-333), the
should-we-schedule gate (doScheduleBinding :346-414: placement changed /
replicas changed / reschedule triggered / not yet scheduled), result patching
(:598-660) and Scheduled conditions (:827-919).

The port's batched engine (``karmada_tpu_torch.scheduler``, on ``device``)
does the work; this controller packs ResourceBindings into BindingProblems,
keeps the cluster snapshot fresh (cluster events invalidate it), and writes
results and conditions back. The engine options reach every engine it
builds: ``extra_estimators`` (the plane's accurate estimators),
``disabled_plugins`` and ``custom_filters``; ``estimator_registry`` is
invalidated on every cluster event.

``solver=`` routes scheduling to an out-of-process solver sidecar (either
package's ``RemoteSolver``/``HASolver``, or any object with
``sync_clusters(clusters)`` and ``schedule(problems)``): cluster state is
pushed before the first pass after every cluster event, waves with
bindings in a FederatedResourceQuota'd namespace or with priority > 0
reroute to the in-process engine (the sidecar carries neither channel), and
a transport failure serves that pass on the in-process engine on
``device`` (``karmada_tpu_degraded_passes_total{channel="solver"}``) and
re-syncs the sidecar before its next pass. The lease write barrier: after
each engine pass the controller asks ``runtime.beat()``; a plane deposed
during the pass (its heartbeat answers False) writes nothing of it and
puts every key of the batch back on its queue. Still to come: the metrics
server and the tracer's peers (ROADMAP A17), prewarm (A14) and a device
mesh (A15).
"""

from __future__ import annotations

import time
from typing import Optional

from ..api.core import Condition, set_condition
from ..api.work import PREEMPTED, SCHEDULED, ResourceBinding, TargetCluster
from ..scheduler import BindingProblem, ClusterSnapshot, TensorScheduler
from ..utils import DONE, Runtime, Store

DEFAULT_SCHEDULER = "default-scheduler"


def _takes_dirty_keys(engine) -> bool:
    """Whether ``engine.schedule`` is the genuine tensor-engine method
    (which takes the ``dirty_keys`` kwarg) rather than a sidecar proxy or a
    patched-in double with the narrower legacy signature."""
    return (
        isinstance(engine, TensorScheduler)
        and "schedule" not in vars(engine)
        and type(engine).schedule is _TENSOR_SCHEDULE
    )


_TENSOR_SCHEDULE = TensorScheduler.schedule


def _is_transport_error(exc: Exception) -> bool:
    """Solver-channel failures that trigger the in-process fallback (grpc
    is imported lazily, and absent it no exception is a grpc error)."""
    from ..utils.backoff import CircuitBreakerOpen, DeadlineExceeded
    from ..utils.faultinject import FaultError

    if isinstance(
        exc, (CircuitBreakerOpen, DeadlineExceeded, FaultError,
              ConnectionError, TimeoutError)
    ):
        return True
    try:
        import grpc
    except ImportError:
        return False
    return isinstance(exc, grpc.RpcError)


class SchedulerController:
    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        scheduler_name: str = DEFAULT_SCHEDULER,
        extra_estimators=(),
        disabled_plugins=(),
        custom_filters=(),
        clock=None,
        solver=None,
        estimator_registry=None,
        device="cuda",
    ) -> None:
        self.store = store
        self.runtime = runtime
        self.scheduler_name = scheduler_name
        # the plane's EstimatorRegistry (when accurate estimators feed
        # extra_estimators): cluster events invalidate its memoized
        # estimates so the next pass re-queries live member state
        self.estimator_registry = estimator_registry
        # out-of-process solver sidecar: when set, scheduling goes over its
        # channel instead of the in-process engine, with cluster state
        # pushed after cluster events
        self.solver = solver
        self._solver_synced = False
        if solver is not None:
            solver._cluster_source = self._sorted_clusters
        # every engine this controller builds (the in-process engine and
        # the sidecar's fallback) runs on this device
        self.device = device
        # last_scheduled_time is compared against rescheduleTriggeredAt,
        # which other controllers stamp from the plane clock — both sides
        # must share one time base or Fresh triggers silently degrade
        self.clock = clock or time.time
        self._snapshot: Optional[ClusterSnapshot] = None
        self._engine: Optional[TensorScheduler] = None
        self.extra_estimators = list(extra_estimators)
        # --plugins enable/disable list + out-of-tree filter registry
        # (scheduler.go:243-247, framework/runtime/registry.go); both reach
        # the engine on every (re)build so flags apply live
        self.disabled_plugins = tuple(disabled_plugins)
        self.custom_filters = list(custom_filters)
        # id()s of binding objects whose writeback WE are applying right
        # now: the store delivers the echo synchronously with the very same
        # object, so identity marks it (one re-gate queue wave per storm
        # saved). Cleared after the batch.
        self._pending_writeback: set[int] = set()
        # victim key -> kind, refreshed by each armed pass's victim source
        self._victim_kinds: dict[str, str] = {}
        # quota plane: FRQ events bump the quota generation (the engine's
        # batch-identity replay and the denied-binding retry gate both key
        # on it) and re-enqueue ONLY the denied bindings of the touched
        # namespace — a quota raise clears QuotaExceeded without a full
        # re-pack of the fleet
        self._quota_gen = 0
        self._quota_snapshot = None
        self._quota_snap_gen = -1  # generation the cached snapshot is for
        self._quota_denied: dict[tuple, int] = {}  # (kind, key) -> gen
        # _problem_for answers the CACHED problem object when the rebuilt
        # content is equal, so a steady binding keeps one identity across
        # waves and the engine's batch-identity path can diff a wave by
        # id(). Keys whose content DID move accumulate per wave in
        # _dirty_problem_keys — the dirty-row set handed to
        # TensorScheduler.schedule() beside the identity token. Pruned on
        # binding delete.
        self._problem_cache: dict[str, BindingProblem] = {}
        self._dirty_problem_keys: set[str] = set()
        # once-per-transition counter gate: the SHARED dedup behind
        # quota_denied_total AND unschedulable_total — a parked binding
        # re-enqueued across passes within one generation must never
        # double-increment either family
        from ..utils.reasons import TransitionDedup

        self._reason_dedup = TransitionDedup()
        self.worker = runtime.new_worker(
            "scheduler", self._reconcile,
            reconcile_batch=self._reconcile_batch, batch_size=131072,
        )
        store.watch("ResourceBinding", self._on_binding_event)
        store.watch("ClusterResourceBinding", self._on_binding_event)
        store.watch("Cluster", self._on_cluster_event)
        store.watch("FederatedResourceQuota", self._on_quota_event)

    # -- events ------------------------------------------------------------

    def _on_binding_event(self, event) -> None:
        if event.type == "Deleted":
            return
        rb = event.obj
        if rb.spec.scheduler_name != self.scheduler_name:
            return  # scheduler-name filter (event_handler.go:93-113)
        if id(rb) in self._pending_writeback:
            return  # our own writeback echo
        self.worker.enqueue((event.kind, event.key))

    def _on_quota_event(self, event) -> None:
        self._quota_gen += 1
        self._quota_snap_gen = -1  # rebuild the packed snapshot lazily
        ns = event.obj.meta.namespace if event.obj is not None else ""
        for (kind, key), _gen in list(self._quota_denied.items()):
            if not ns or key.split("/", 1)[0] == ns:
                self.worker.enqueue((kind, key))

    def _on_cluster_event(self, event) -> None:
        self._snapshot = None  # invalidate; rebuild lazily
        self._solver_synced = False  # sidecar re-sync before next schedule
        # quota caps pack against the cluster columns: rebuild the quota
        # snapshot against the refreshed cluster snapshot too
        self._quota_snap_gen = -1
        if self.estimator_registry is not None:
            # member state moved: memoized accurate estimates are stale
            # (EstimatorRegistry.invalidate staleness contract)
            self.estimator_registry.invalidate()
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            for rb in self.store.list(kind):
                if rb.spec.scheduler_name == self.scheduler_name:
                    self.worker.enqueue((kind, rb.meta.namespaced_name))

    # -- engine ------------------------------------------------------------

    def _sorted_clusters(self):
        return sorted(self.store.list("Cluster"), key=lambda c: c.name)

    def _get_engine(self):
        if self.solver is not None:
            if not self._solver_synced:
                self.solver.sync_clusters(self._sorted_clusters())
                self._solver_synced = True
            return self.solver
        return self._inproc_engine()

    @staticmethod
    def _quota_enforcement_enabled() -> bool:
        import os

        return os.environ.get(
            "KARMADA_TPU_QUOTA_ENFORCEMENT", "1"
        ).lower() not in ("0", "false", "")

    @staticmethod
    def _preemption_enabled() -> bool:
        """Scarcity-plane kill switch: read live per pass so flipping
        KARMADA_TPU_PREEMPTION=0 disarms without a restart."""
        import os

        return os.environ.get(
            "KARMADA_TPU_PREEMPTION", "1"
        ).lower() not in ("0", "false", "")

    def _quota_namespaces(self) -> set:
        """Namespaces carrying an FRQ when enforcement is on (empty = the
        quota plane is inert for routing purposes)."""
        if not self._quota_enforcement_enabled():
            return set()
        return {
            frq.meta.namespace
            for frq in self.store.list("FederatedResourceQuota")
        }

    def _route_engine_for_quota(self, engine, problems=()):
        """The solver sidecar has no quota channel: a wave that must
        enforce quota falls back to the in-process engine (the same
        degraded-mode seam transport failures use) instead of silently
        scheduling quota'd bindings unbounded. Scoped to the WAVE: only
        waves that actually contain bindings in quota'd namespaces
        reroute."""
        if hasattr(engine, "set_quota"):
            return engine
        quota_ns = self._quota_namespaces()
        if not quota_ns or not any(p.namespace in quota_ns for p in problems):
            return engine
        if not getattr(self, "_quota_solver_warned", False):
            self._quota_solver_warned = True
            print(
                "# scheduler: FederatedResourceQuota enforcement is not "
                "supported over the solver sidecar; quota waves take the "
                "in-proc engine (set KARMADA_TPU_QUOTA_ENFORCEMENT=0 to "
                "route them to the sidecar unenforced)",
                flush=True,
            )
        return self._inproc_engine()

    def _route_engine_for_scarcity(self, engine, problems=()):
        """The solver sidecar has no preemption channel either: a wave
        carrying priority>0 bindings reroutes in-process while preemption
        is armed, scoped exactly like the quota reroute."""
        if hasattr(engine, "set_preemption"):
            return engine
        if not self._preemption_enabled() or not any(
            p.priority > 0 for p in problems
        ):
            return engine
        if not getattr(self, "_preempt_solver_warned", False):
            self._preempt_solver_warned = True
            print(
                "# scheduler: priority preemption is not supported over "
                "the solver sidecar; priority waves take the in-proc "
                "engine (set KARMADA_TPU_PREEMPTION=0 to route them to "
                "the sidecar without preemption)",
                flush=True,
            )
        return self._inproc_engine()

    def _victim_problems(self, exclude_keys):
        """The resident victim pool the engine's preemption pass selects
        from: every BOUND binding of this scheduler (assigned replicas
        on at least one cluster) that is NOT in the current wave — a
        binding being rescheduled this pass has its capacity in flux and
        is never victimized in the same pass. Kind is remembered so the
        eviction writer can find the object again."""
        out = []
        self._victim_kinds = {}
        for kind in ("ResourceBinding", "ClusterResourceBinding"):
            for rb in self.store.list(kind):
                key = rb.meta.namespaced_name
                if (
                    rb.spec.scheduler_name != self.scheduler_name
                    or key in exclude_keys
                    or not rb.spec.clusters
                ):
                    continue
                self._victim_kinds[key] = kind
                out.append(self._problem_for(key, rb, False))
        return out

    def _ensure_engine_quota(self, engine) -> None:
        """Hand the engine a current QuotaSnapshot (None = no FRQs or
        enforcement disabled). In-process engines only: the solver sidecar
        has no quota channel — _route_engine_for_quota sends quota waves
        to the in-process path before this runs."""
        if not hasattr(engine, "set_quota"):
            return
        if not self._quota_enforcement_enabled():
            # live kill switch: the engine's quota hook disarms this pass
            # (the packed snapshot cache survives for a re-enable)
            engine.set_quota(None)
            return
        if self._quota_snap_gen != self._quota_gen:
            from ..scheduler.quota import build_quota_snapshot

            qsnap = None
            frqs = self.store.list("FederatedResourceQuota")
            if frqs:
                qsnap = build_quota_snapshot(
                    frqs, engine.snapshot, self._quota_gen,
                    store=self.store,
                )
            self._quota_snapshot = qsnap
            self._quota_snap_gen = self._quota_gen
        engine.set_quota(self._quota_snapshot)

    def _inproc_engine(self) -> TensorScheduler:
        """The snapshot-backed engine on ``device``, rebuilt lazily after a
        cluster event: the default when no sidecar is configured, and the
        degraded-mode fallback when the sidecar channel is down (its
        breaker open or the RPC failing) — scheduling never stalls on a
        dead solver."""
        if self._snapshot is None:
            clusters = self._sorted_clusters()
            snap = ClusterSnapshot(clusters)
            # same cluster set: swap the snapshot in place so the engine's
            # device-resident binding table survives status heartbeats
            # (the informer-cache delta case); rebuild only on join/leave
            if self._engine is not None and self._engine.update_snapshot(snap):
                self._snapshot = snap
            else:
                self._snapshot = snap
                self._engine = TensorScheduler(
                    self._snapshot,
                    extra_estimators=self.extra_estimators,
                    disabled_plugins=self.disabled_plugins,
                    custom_filters=self.custom_filters,
                    device=self.device,
                )
        return self._engine

    # -- reconcile ---------------------------------------------------------

    def _needs_scheduling(self, rb: ResourceBinding) -> tuple[bool, bool]:
        """(should_schedule, fresh). Mirrors doScheduleBinding
        (scheduler.go:346-414)."""
        if (
            rb.spec.reschedule_triggered_at is not None
            and (
                rb.status.last_scheduled_time is None
                or rb.spec.reschedule_triggered_at > rb.status.last_scheduled_time
            )
        ):
            return True, True
        if rb.status.scheduler_observed_generation != rb.meta.generation:
            return True, False
        sched = next(
            (c for c in rb.status.conditions if c.type == SCHEDULED), None
        )
        if sched is None:
            return True, False  # never attempted
        if not sched.status:
            # unschedulable bindings retry on every re-enqueue (the
            # reference's unschedulable-queue semantics): cluster events
            # re-enqueue the whole plane, so freed capacity re-places a
            # parked binding without any spec change. Quota denials are
            # intercepted BEFORE this gate by the generation-gated
            # _quota_denied park, so a denied binding still retries only
            # on quota movement.
            return True, False
        divided = (
            rb.spec.placement is not None
            and rb.spec.placement.replica_scheduling_type() == "Divided"
        )
        # Duplicated (and non-workload) bindings are always (re)scheduled so
        # cluster-set changes take effect (scheduler.go:393-401); the result
        # write-back below is change-detected, so this stays quiescent.
        if rb.spec.replicas == 0 or not divided:
            return True, False
        # replicas drift vs assignment (scale scheduling)
        assigned = sum(tc.replicas for tc in rb.spec.clusters)
        if rb.spec.clusters and assigned != rb.spec.replicas:
            return True, False
        return False, False

    def _reconcile(self, kind_key) -> Optional[str]:
        results = self._reconcile_batch([kind_key])
        return results.get(kind_key, DONE)

    def _reconcile_batch(self, kind_keys) -> dict:
        """Vectorized drain: gate every queued binding, run ONE engine pass
        over all that need scheduling, write each back. A 100k-binding
        storm becomes chunked kernel batches instead of 100k single-item
        engine invocations."""
        from ..scheduler.quota import QUOTA_EXCEEDED_ERROR
        from ..utils.metrics import (
            e2e_scheduling_duration,
            schedule_attempts,
            scheduler_pass_seconds,
        )
        from ..utils.tracing import tracer

        out: dict = {}
        todo: list[tuple] = []  # (kind_key, rb, problem, fresh)
        for kind_key in kind_keys:
            kind, key = kind_key
            rb = self.store.get(kind, key)
            if rb is None:
                self._quota_denied.pop(kind_key, None)
                # deleted binding: drop its cached problem so the key's
                # identity cannot alias a later re-creation
                self._problem_cache.pop(key, None)
                self._dirty_problem_keys.discard(key)
                out[kind_key] = DONE
                continue
            should, fresh = self._needs_scheduling(rb)
            # quota-denied retry gate: a denied binding re-schedules on
            # the NEXT quota generation (FRQ spec/usage moved), not every
            # queue wave — and it MUST re-schedule then, even when the
            # generic gate sees nothing to do. An explicit Fresh trigger
            # bypasses the gate.
            denied_at = self._quota_denied.get(kind_key)
            if denied_at is not None and not fresh:
                if (
                    denied_at == self._quota_gen
                    and rb.status.scheduler_observed_generation
                    == rb.meta.generation
                ):
                    # same quota generation AND unchanged binding spec:
                    # stay parked. A spec change (e.g. scaled down to fit)
                    # bumps the generation and must retry immediately.
                    out[kind_key] = DONE
                    continue
                should = True  # quota or the binding moved: retry now
            if not should:
                out[kind_key] = DONE
                continue
            todo.append((kind_key, rb, self._problem_for(key, rb, fresh), fresh))
        if not todo:
            return out
        # priority-descending wave ordering: higher priority classes solve
        # — and hit batched FIFO quota admission — first; the sort is
        # STABLE, so arrival order (queue order) is preserved inside each
        # class. Priority-free waves (all 0) keep their exact order.
        if any(p.priority for _, _, p, _ in todo):
            todo.sort(key=lambda item: -item[2].priority)
        start = time.perf_counter()
        # one engine pass = one scheduler.pass span, so a storm wave's
        # solve time decomposes without per-binding bookkeeping
        with tracer.span("scheduler.pass") as sp:
            problems = [p for _, _, p, _ in todo]
            # the wave's dirty-row set: keys whose problem content moved
            # since their cached build. Handed to the engine beside the
            # identity token; reset so the next wave reports only ITS churn.
            wave_dirty = self._dirty_problem_keys
            self._dirty_problem_keys = set()
            sp.attrs["dirty_rows"] = len(wave_dirty)

            def _solve_on(engine):
                """One engine pass with the scarcity plane armed for its
                duration only (dry solves and other callers of the same
                engine must never inherit an armed victim source)."""
                self._ensure_engine_quota(engine)
                armed = (
                    hasattr(engine, "set_preemption")
                    and self._preemption_enabled()
                    and any(p.priority > 0 for p in problems)
                )
                if armed:
                    engine.set_preemption(self._victim_problems)
                try:
                    # dirty keys ride only the genuine tensor engine; a
                    # sidecar proxy or a patched-in test double keeps its
                    # narrower contract
                    if _takes_dirty_keys(engine):
                        results = engine.schedule(problems, dirty_keys=wave_dirty)
                    else:
                        results = engine.schedule(problems)
                    return results, (engine.last_preemption if armed else None)
                finally:
                    if armed:
                        engine.set_preemption(None)

            try:
                engine = self._route_engine_for_scarcity(
                    self._route_engine_for_quota(self._get_engine(), problems),
                    problems,
                )
                results, preemption = _solve_on(engine)
            except Exception as exc:  # noqa: BLE001 — transport triage below
                if self.solver is None or not _is_transport_error(exc):
                    raise
                # degraded mode: a broken solver sidecar fails over to the
                # in-process engine for this pass — the breaker's half-open
                # probe re-admits the sidecar without operator action, and
                # _solver_synced stays False so recovery re-pushes the
                # snapshot first
                from ..utils.metrics import degraded_passes

                degraded_passes.inc(channel="solver")
                self._solver_synced = False
                sp.attrs["degraded"] = "solver-fallback"
                print(
                    "# scheduler: solver sidecar unavailable "
                    f"({type(exc).__name__}); in-proc solve for this pass",
                    flush=True,
                )
                results, preemption = _solve_on(self._inproc_engine())
            sp.attrs["bindings"] = len(todo)
            if preemption is not None and preemption.victims:
                sp.attrs["preempted"] = len(preemption.victims)
        scheduler_pass_seconds.observe(sp.duration)
        per_item = (time.perf_counter() - start) / len(todo)
        # leadership check at the write barrier: a batched engine pass can
        # outlast a lease, and the heartbeat seam only fires BETWEEN work
        # items — one storm batch is one item. A plane deposed during the
        # pass discards its results unwritten (the standby owns the storm
        # now); the keys park for the next leadership. In-process planes
        # have no heartbeat and pass.
        if not self.runtime.beat():
            for kind_key, _, _, _ in todo:
                self.worker.enqueue(kind_key)
                out[kind_key] = DONE
            return out
        changed_rbs = []
        for (kind_key, rb, _, fresh), result in zip(todo, results):
            if result.error == QUOTA_EXCEEDED_ERROR:
                self._quota_denied[kind_key] = self._quota_gen
            else:
                self._quota_denied.pop(kind_key, None)
            if self._write_back(rb, result, fresh):
                changed_rbs.append(rb)
            e2e_scheduling_duration.observe(per_item)
            schedule_attempts.inc(
                result="success" if result.success else "error",
                schedule_type="FreshSchedule" if fresh else "ReconcileSchedule",
            )
            out[kind_key] = DONE
        # batched writeback: one locked sweep + one delivery sweep instead
        # of len(changed) apply calls (storm hot path)
        self._pending_writeback = {id(rb) for rb in changed_rbs}
        try:
            for rb, err in self.store.apply_many(changed_rbs):
                # per-object admission rejection: surface it, the rest of
                # the wave committed
                print(
                    f"# scheduler writeback rejected for "
                    f"{rb.meta.namespaced_name}: {err}",
                    flush=True,
                )
        finally:
            self._pending_writeback.clear()
        if preemption is not None and preemption.victims:
            self._evict_preemption_victims(preemption)
        return out

    def _evict_preemption_victims(self, preemption) -> None:
        """Route the pass's selected victims through graceful eviction:
        each assigned cluster becomes a ``PreemptedByHigherPriority``
        eviction task, the victim gets a ``Preempted`` condition naming its
        displacer, and ``karmada_tpu_preemptions_total`` counts once per
        displacement episode (TransitionDedup). The spec bump re-enqueues
        the victim, which then reschedules with the evicted clusters
        excluded."""
        from ..api.work import EVICTION_PRODUCER_PREEMPTION, EVICTION_REASON_PREEMPTED
        from ..utils.metrics import preemptions_total
        from .cluster import evict_binding

        displacer = next(
            iter(preemption.placed or preemption.still_unschedulable), ""
        )
        now = self.clock()
        changed = []
        for key, placement, _prio in preemption.victims:
            kind = self._victim_kinds.get(key, "ResourceBinding")
            rb = self.store.get(kind, key)
            if rb is None or not rb.spec.clusters:
                continue  # vanished or already displaced: nothing to free
            for cluster in list(placement):
                evict_binding(
                    rb,
                    cluster,
                    reason=EVICTION_REASON_PREEMPTED,
                    producer=EVICTION_PRODUCER_PREEMPTION,
                    message=f"preempted by higher-priority {displacer}",
                    now=now,
                )
            set_condition(
                rb.status.conditions,
                Condition(
                    type=PREEMPTED,
                    status=True,
                    reason=EVICTION_REASON_PREEMPTED,
                    message=f"preempted by higher-priority {displacer}",
                ),
            )
            if self._reason_dedup.observe(
                ("preempt", key), EVICTION_REASON_PREEMPTED, None
            ):
                preemptions_total.inc(reason=EVICTION_REASON_PREEMPTED)
            changed.append(rb)
        for rb, err in self.store.apply_many(changed):
            print(
                f"# scheduler: preemption eviction rejected for "
                f"{rb.meta.namespaced_name}: {err}",
                flush=True,
            )

    def dry_solve(self, problems, dirty_keys=None) -> list:
        """One engine pass with NO store writes and NO scarcity arming —
        the continuous descheduler's scoring seam (the engine still
        enforces quota, so a drift score can never recommend a placement
        admission would deny). A dry pass leaves NO trace on the live
        plane: the quota working ``remaining`` is restored and the
        provenance store is disarmed for its duration. ``dirty_keys``
        threads the caller's known-churn set into the engine. Over a solver
        sidecar the pass goes to the sidecar, unless it must enforce
        quota."""
        engine = self._route_engine_for_quota(self._get_engine(), problems)
        self._ensure_engine_quota(engine)
        q = getattr(engine, "quota", None)
        saved_remaining = q.remaining.copy() if q is not None else None
        saved_explain = getattr(engine, "explain", None)
        if hasattr(engine, "set_explain"):
            engine.set_explain(None)
        try:
            if _takes_dirty_keys(engine):
                return engine.schedule(problems, dirty_keys=dirty_keys)
            return engine.schedule(problems)
        finally:
            if hasattr(engine, "set_explain"):
                engine.set_explain(saved_explain)
            if q is not None:
                q.remaining = saved_remaining

    def _problem_for(self, key: str, rb: ResourceBinding, fresh: bool) -> BindingProblem:
        """Build the engine problem for ``rb`` — answering the CACHED
        object when the rebuilt content is equal (identity <=> content: the
        engine diffs waves by id(), so an unchanged binding must keep ONE
        problem object across waves). A content move replaces the cache
        entry and marks the key dirty for the wave's dirty-row set."""
        p = self._build_problem(key, rb, fresh)
        cached = self._problem_cache.get(key)
        if cached is not None and cached == p:
            return cached
        self._problem_cache[key] = p
        self._dirty_problem_keys.add(key)
        return p

    def _build_problem(self, key: str, rb: ResourceBinding, fresh: bool) -> BindingProblem:
        return BindingProblem(
            key=key,
            placement=rb.spec.placement,
            replicas=rb.spec.replicas,
            requests=(
                rb.spec.replica_requirements.resource_request
                if rb.spec.replica_requirements
                else {}
            ),
            gvk=rb.spec.resource.gvk,
            prev={tc.name: tc.replicas for tc in rb.spec.clusters},
            evict_clusters=tuple(
                t.from_cluster for t in rb.spec.graceful_eviction_tasks
            ),
            fresh=fresh,
            namespace=rb.meta.namespace or "",
            priority=rb.spec.priority,
            preempt_clusters=tuple(
                t.from_cluster
                for t in rb.spec.graceful_eviction_tasks
                if t.reason == "PreemptedByHigherPriority"
            ),
        )

    def _write_back(self, rb: ResourceBinding, result, fresh: bool = False) -> bool:
        """Mutate ``rb`` from the schedule result; returns whether it
        changed (the batch caller owns the store write). Scheduled=False
        conditions carry a REASONS-taxonomy code (the classified
        unschedulability reason, not free text), and every (binding,
        reason, generation) transition increments
        ``karmada_tpu_unschedulable_total{reason}`` exactly once."""
        before = [(tc.name, tc.replicas) for tc in rb.spec.clusters]
        changed = rb.status.scheduler_observed_generation != rb.meta.generation
        if result.success and fresh and (
            rb.status.last_scheduled_time is None
            or (
                rb.spec.reschedule_triggered_at is not None
                and rb.spec.reschedule_triggered_at
                > rb.status.last_scheduled_time
            )
        ):
            # consume the served Fresh trigger even when the result is
            # unchanged (scheduler.go patches lastScheduledTime on every
            # successful run): a lingering trigger re-marks every later
            # pass Fresh
            rb.status.last_scheduled_time = self.clock()
            changed = True
        if result.success:
            if rb.spec.replicas > 0:
                rb.spec.clusters = [
                    TargetCluster(name=n, replicas=r)
                    for n, r in sorted(result.clusters.items())
                ]
            else:
                # non-workload: all feasible clusters, no replica counts
                rb.spec.clusters = [
                    TargetCluster(name=n) for n in sorted(result.feasible)
                ]
            if [(tc.name, tc.replicas) for tc in rb.spec.clusters] != before:
                changed = True
                rb.status.last_scheduled_time = self.clock()
            rb.status.scheduler_observed_generation = rb.meta.generation
            if rb.status.scheduler_observed_affinity_name != result.affinity_name:
                rb.status.scheduler_observed_affinity_name = result.affinity_name
                changed = True
            if rb.status.last_scheduled_time is None:
                rb.status.last_scheduled_time = self.clock()
                changed = True
            if set_condition(
                rb.status.conditions,
                Condition(type=SCHEDULED, status=True, reason="Success"),
            ):
                changed = True
            # a later denial after a successful schedule is a NEW
            # transition and must count again
            self._reason_dedup.forget(("sched", rb.meta.namespaced_name))
            # a successful (re-)placement closes the displacement
            # episode: the next preemption of this binding counts anew,
            # and the Preempted condition resolves
            self._reason_dedup.forget(("preempt", rb.meta.namespaced_name))
            for cond in rb.status.conditions:
                if cond.type == PREEMPTED and cond.status:
                    if set_condition(
                        rb.status.conditions,
                        Condition(
                            type=PREEMPTED,
                            status=False,
                            reason="Success",
                            message="re-placed after displacement",
                        ),
                    ):
                        changed = True
                    break
        else:
            from ..scheduler.quota import QUOTA_EXCEEDED_ERROR
            from ..utils.metrics import quota_denied, unschedulable_total
            from ..utils.reasons import classify_error

            rb.status.scheduler_observed_generation = rb.meta.generation
            quota_hit = result.error == QUOTA_EXCEEDED_ERROR
            reason = classify_error(result.error)
            if set_condition(
                rb.status.conditions,
                Condition(
                    type=SCHEDULED,
                    status=False,
                    reason=reason,
                    message=result.error,
                ),
            ):
                changed = True
            # counter transitions dedup independently of the condition
            # write: a parked binding re-enqueued across passes within one
            # generation of ITS OWN spec increments exactly once
            if self._reason_dedup.observe(
                ("sched", rb.meta.namespaced_name),
                reason,
                rb.meta.generation,
            ):
                unschedulable_total.inc(reason=reason)
                if quota_hit:
                    quota_denied.inc(namespace=rb.meta.namespace or "")
        return changed
