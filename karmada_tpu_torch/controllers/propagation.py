"""Propagation controllers: binding -> Work -> member cluster -> status back.

The port's own copy of ``karmada_tpu/controllers/propagation.py``. Ref:
- binding-controller (pkg/controllers/binding/): ensureWork — ReviseReplica
  for divided placements, override application, suspend/preserve flags,
  orphan-Work cleanup (binding_controller.go:70-165, common.go:43-143).
- execution-controller (pkg/controllers/execution/): Work -> member apply /
  delete via objectwatcher, Applied condition.
- work-status-controller (pkg/controllers/status/work_status_controller.go):
  per-member informers reflect member object status+health into
  Work.Status.ManifestStatuses; recreates deleted-but-desired objects.
- binding-status controllers (status/rb_status_controller.go): aggregate
  manifest statuses into ResourceBinding.Status.AggregatedStatus via the
  interpreter, then the detector writes template status.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from typing import Optional

from ..api.core import Condition, ObjectMeta, Resource, set_condition
from ..api.work import (
    FULLY_APPLIED,
    WORK_APPLIED,
    AggregatedStatusItem,
    ManifestStatus,
    ResourceBinding,
    Work,
    WorkloadTemplate,
    WorkloadTemplateRef,
    WorkSpec,
)
from ..api.policy import DIVIDED
from ..interpreter import ResourceInterpreter
from ..utils import DONE, REQUEUE, Runtime, Store
from ..utils.clone import clone_resource
from ..utils.codec import from_jsonable, to_jsonable
from ..utils.metrics import works_rendered
from ..utils.member import (
    ConflictError,
    MemberClientRegistry,
    MemberEvent,
    ObjectWatcher,
    UnreachableError,
)
from .overridemanager import OverrideManager

log = logging.getLogger("karmada_tpu_torch")

ES_PREFIX = "karmada-es-"
WORK_BINDING_LABEL = "resourcebinding.karmada.io/key"  # value: "<kind>:<key>"

BINDING_KINDS = ("ResourceBinding", "ClusterResourceBinding")

TEMPLATE_DELTA_ENV = "KARMADA_TPU_BUS_TEMPLATE_DELTA"


def template_delta_enabled() -> bool:
    """Template-delta Work rendering kill switch: set
    KARMADA_TPU_BUS_TEMPLATE_DELTA=0 to force full-object rendering
    for every Work (the degraded/compat path)."""
    return os.environ.get(TEMPLATE_DELTA_ENV, "1").lower() not in (
        "0", "false", ""
    )


def binding_ref(kind: str, key: str) -> str:
    return f"{kind}:{key}"


def execution_namespace(cluster: str) -> str:
    return f"{ES_PREFIX}{cluster}"


def cluster_of_execution_namespace(ns: str) -> Optional[str]:
    return ns[len(ES_PREFIX):] if ns.startswith(ES_PREFIX) else None


def binding_namespace_shard(kind_key) -> str:
    """Per-namespace ownership token for worker sharding: drains of
    different namespaces ride different shard queues, so one namespace's
    storm (or poisoned key bisect) never head-of-line-blocks another's
    batch flush."""
    _, key = kind_key
    ns, sep, _ = key.partition("/")
    return ns if sep else ""


def _patch_key(patch: dict) -> tuple:
    return tuple(sorted(patch.items()))


def _work_signature(work: Work):
    ref = work.spec.workload_template
    if ref is not None and ref.digest:
        # template-delta works: content identity is (digest, patch) —
        # the manifest body lives in the content-addressed template
        w_sig = ("tpl", ref.digest, _patch_key(ref.patch))
        labels = None
    else:
        w = work.spec.workload[0] if work.spec.workload else None
        w_sig = w.spec if w else None
        labels = w.meta.labels if w else None
    return (
        w_sig,
        labels,
        work.spec.suspend_dispatching,
        work.spec.preserve_resources_on_deletion,
    )


class TemplateRehydrator:
    """Consumer-side template-delta cache: decodes each WorkloadTemplate
    manifest ONCE (content-addressed — a digest's body never changes) and
    renders each Work's manifest as clone(base) + patch, memoized per
    Work so repeated reconciles hand back the SAME object (the member
    ObjectWatcher's no-op cache pins on manifest identity). Returns None
    when the template has not been mirrored yet — callers REQUEUE and the
    WorkloadTemplate watch unparks them."""

    def __init__(self, store) -> None:
        self.store = store
        self._base: dict[str, Resource] = {}
        # work key -> (digest, patch key, rendered list)
        self._rendered: dict[str, tuple] = {}

    def manifests(self, work: Work) -> Optional[list]:
        ref = work.spec.workload_template
        if ref is None or not ref.digest:
            return work.spec.workload
        pkey = _patch_key(ref.patch)
        hit = self._rendered.get(work.meta.namespaced_name)
        if hit is not None and hit[0] == ref.digest and hit[1] == pkey:
            return hit[2]
        base = self._base.get(ref.digest)
        if base is None:
            tpl = self.store.get("WorkloadTemplate", ref.digest)
            if tpl is None:
                return None  # not mirrored yet: caller requeues
            base = from_jsonable(Resource, tpl.manifest)
            self._base[ref.digest] = base
        out = clone_resource(base)
        if ref.patch:
            out.spec.update(ref.patch)
        rendered = [out]
        self._rendered[work.meta.namespaced_name] = (
            ref.digest, pkey, rendered
        )
        return rendered

    def forget_digest(self, digest: str) -> None:
        self._base.pop(digest, None)

    def forget_work(self, key: str) -> None:
        self._rendered.pop(key, None)


def work_manifests(store, work: Work, rehydrator=None) -> Optional[list]:
    """The manifest list of a Work, rehydrating template-delta Works from
    their WorkloadTemplate (None = template not mirrored yet). One-shot
    helper; long-lived consumers hold a TemplateRehydrator for the
    decode/render caches."""
    return (rehydrator or TemplateRehydrator(store)).manifests(work)


class WorkIndex:
    """Incremental indexes over Work objects, maintained from watch events
    (the informer-indexer analogue). Kills the O(bindings x works) scans
    the binding/status controllers would otherwise pay per reconcile:
    - by binding label (orphan cleanup, status aggregation)
    - by propagated target (cluster, gvk, namespace, name) for member-event
      routing in the work-status controller."""

    def __init__(self, store: Store) -> None:
        self.store = store
        self._by_binding: dict[str, set[str]] = {}
        self._by_target: dict[tuple, str] = {}
        # work key -> (ref, targets, template digest)
        self._work_meta: dict[str, tuple] = {}
        # template digest -> referencing work keys (the template GC's
        # refcount surface: a digest nobody references is collectable)
        self._by_digest: dict[str, set[str]] = {}
        # watch(replay=True) synthesizes Added for Works already in the store,
        # so the index seeds correctly against a populated store.
        store.watch("Work", self._on_event)

    def _on_event(self, event) -> None:
        key = event.key
        old_ref, old_targets, old_digest = self._work_meta.pop(
            key, (None, (), None)
        )
        if old_ref is not None:
            self._by_binding.get(old_ref, set()).discard(key)
        if old_digest is not None:
            refs = self._by_digest.get(old_digest)
            if refs is not None:
                refs.discard(key)
                if not refs:
                    del self._by_digest[old_digest]
        for t in old_targets:
            if self._by_target.get(t) == key:
                del self._by_target[t]
        if event.type == "Deleted":
            return
        work = event.obj
        ref = work.meta.labels.get(WORK_BINDING_LABEL)
        cluster = cluster_of_execution_namespace(work.meta.namespace)
        tref = work.spec.workload_template
        digest = tref.digest if tref is not None and tref.digest else None
        if cluster is None:
            targets = ()
        elif digest is not None:
            # template-delta works carry target identity on the ref —
            # the index never needs the template body
            targets = (
                (cluster, f"{tref.api_version}/{tref.kind}",
                 tref.namespace, tref.name),
            )
        else:
            targets = tuple(
                (cluster, f"{w.api_version}/{w.kind}",
                 w.meta.namespace, w.meta.name)
                for w in work.spec.workload
            )
        if ref:
            self._by_binding.setdefault(ref, set()).add(key)
        if digest is not None:
            self._by_digest.setdefault(digest, set()).add(key)
        for t in targets:
            self._by_target[t] = key
        self._work_meta[key] = (ref, targets, digest)

    def digest_refcount(self, digest: str) -> int:
        return len(self._by_digest.get(digest, ()))

    def works_for(self, binding_ref: str) -> list:
        out = []
        for key in sorted(self._by_binding.get(binding_ref, ())):
            work = self.store.get("Work", key)
            if work is not None:
                out.append(work)
        return out

    def work_for_target(self, cluster: str, gvk: str, namespace: str, name: str):
        key = self._by_target.get((cluster, gvk, namespace, name))
        return self.store.get("Work", key) if key else None


class BindingController:
    """ResourceBinding -> per-target-cluster Work objects."""

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        interpreter: ResourceInterpreter,
        work_index: Optional[WorkIndex] = None,
    ) -> None:
        self.store = store
        self.interpreter = interpreter
        self.work_index = work_index or WorkIndex(store)
        self.overrides = OverrideManager(store)
        # binding ref -> (global fingerprint, {cluster: (replicas,
        # cluster_token)}) of the last ensureWork pass: an incremental storm
        # (scale +1) changes one target's count, so only that Work is
        # rebuilt instead of revising/overriding/cloning the template once
        # per target per reconcile. cluster_token covers the live cluster
        # fields override rules match on (labels/provider/region/zone).
        # Keyed on template (uid, generation) — the plane's spec-change
        # discipline (the scheduler gate relies on generation the same way).
        self._built: dict[str, tuple] = {}
        # (template uid, replica-exclusion flag) -> ((generation,
        # resource_version), content hash): a scale storm bumps every
        # template's generation while changing only the replica fields the
        # per-target revise overwrites anyway, so generation alone would
        # void the build cache fleet-wide each wave
        self._template_hashes: dict[tuple, tuple] = {}
        # Works this controller deleted itself (orphan cleanup): their
        # Deleted events must not void the freshly written cache entry
        self._own_deletes: set[str] = set()
        # template-delta rendering: (binding ref -> ((uid, generation,
        # rv), digest, pruned manifest doc)) content cache — keyed by
        # REF so binding deletion evicts it (a uid key would grow with
        # all-time template churn) — digests already published to the
        # store, binding ref -> digest for GC, and the digests whose
        # refcount must be re-checked after the next flush
        self._tpl_cache: dict[str, tuple] = {}
        self._tpl_published: set[str] = set()
        self._built_digest: dict[str, str] = {}
        self._gc_digests: set[str] = set()
        # per-drain write set: reconciles buffer their Work
        # applies/deletes and the drain flushes them as ONE batched write
        # (store.apply_many -> one lock+delivery sweep)
        self._buffering = False
        self._pending_applies: list = []
        self._pending_deletes: list = []
        self.worker = runtime.new_worker(
            "binding", self._reconcile,
            reconcile_batch=self._reconcile_batch,
            shard_fn=binding_namespace_shard,
        )
        for kind in BINDING_KINDS:
            store.watch(
                kind, lambda e, k=kind: self.worker.enqueue((k, e.key))
            )
        store.watch("OverridePolicy", self._requeue_all)
        store.watch("ClusterOverridePolicy", self._requeue_all)
        # interpreter customizations change revise/retain semantics: the
        # cached build fingerprints are meaningless across such a change
        store.watch(
            "ResourceInterpreterCustomization", self._requeue_all,
            replay=False,
        )
        store.watch("Work", self._on_work_event, replay=False)
        # override rules match live cluster state: a label / topology edit
        # must requeue the bindings whose Works were built against the old
        # state (status heartbeats leave the token unchanged and are cheap)
        store.watch("Cluster", self._on_cluster_event, replay=False)
        self._cluster_tokens: dict[str, tuple] = {}

    @staticmethod
    def _cluster_token(cluster) -> Optional[tuple]:
        """The live cluster fields override rules can match on
        (ClusterAffinity: name/labels, FieldSelector: provider/region/zone).
        Both the build cache and the Cluster watch compare THIS tuple — keep
        them in lockstep via this single constructor."""
        if cluster is None:
            return None
        return (
            tuple(sorted(cluster.meta.labels.items())),
            cluster.spec.provider,
            cluster.spec.region,
            cluster.spec.zone,
        )

    _UNSEEDED = object()

    def _lookup_cluster_token(self, name: str) -> Optional[tuple]:
        """Cached token for cache-hit targets: the Cluster watch keeps the
        map current (synchronous delivery on the applying thread), so
        steady-storm reconciles pay one dict get per target instead of a
        store fetch + label sort. Lazily seeded from the store for clusters
        that have produced no event since startup."""
        tok = self._cluster_tokens.get(name, self._UNSEEDED)
        if tok is self._UNSEEDED:
            tok = self._cluster_token(self.store.get("Cluster", name))
            self._cluster_tokens[name] = tok
        return tok

    def _on_cluster_event(self, event) -> None:
        name = event.key
        if event.type == "Deleted":
            # tombstone (not pop): the post-build race check must see the
            # deletion, and a later re-join overwrites it
            self._cluster_tokens[name] = None
            token = None
        else:
            token = self._cluster_token(event.obj)
            if self._cluster_tokens.get(name) == token:
                return  # status-only change: override matching unaffected
            self._cluster_tokens[name] = token
        for ref, (_fp, built_targets) in list(self._built.items()):
            entry = built_targets.get(name)
            if entry is not None and entry[1] != token:
                kind, _, key = ref.partition(":")
                self.worker.enqueue((kind, key))

    def _on_work_event(self, event) -> None:
        # an externally deleted Work must be rebuilt even though the build
        # cache says nothing changed
        if event.type != "Deleted":
            return
        if event.key in self._own_deletes:
            self._own_deletes.discard(event.key)
            return
        ref = event.obj.meta.labels.get(WORK_BINDING_LABEL)
        if ref and self._built.pop(ref, None) is not None:
            kind, _, key = ref.partition(":")
            self.worker.enqueue((kind, key))

    def _requeue_all(self, _event) -> None:
        self._built.clear()  # override policies changed: full rebuild
        for kind in BINDING_KINDS:
            for rb in self.store.list(kind):
                self.worker.enqueue((kind, rb.meta.namespaced_name))

    def _reconcile_batch(self, kind_keys) -> dict:
        """Batched drain: reconciles buffer their Work writes and ONE
        flush commits the whole drain's write set. Safe under the
        worker's poisoned-key bisect — reconciles are idempotent and the
        signature gate no-ops re-runs of already-flushed work."""
        out: dict = {}
        self._buffering = True
        try:
            for kind_key in kind_keys:
                out[kind_key] = self._reconcile(kind_key)
        finally:
            self._buffering = False
            self._flush()
        return out

    def _apply_work(self, work: Work) -> None:
        if self._buffering:
            self._pending_applies.append(work)
        else:
            self.store.apply(work)

    def _delete_work(self, key: str) -> None:
        self._own_deletes.add(key)
        if self._buffering:
            self._pending_deletes.append(("Work", key))
        else:
            self.store.delete("Work", key)

    def _flush(self) -> None:
        applies, self._pending_applies = self._pending_applies, []
        deletes, self._pending_deletes = self._pending_deletes, []
        for obj, err in self.store.apply_many(applies):
            log.error("binding controller: work apply rejected for %s: %s",
                      obj.meta.namespaced_name, err)
            # the unbatched path RAISED here, skipping the _built update
            # so the worker retried; batched, the fingerprint is already
            # cached — drop it and re-enqueue the binding or the Work is
            # never rewritten until something else changes
            self._requeue_binding_of(obj)
        for kind, key in deletes:
            self.store.delete(kind, key)
        self._gc_templates()

    def _requeue_binding_of(self, work) -> None:
        """A buffered write for this Work failed at the flush: invalidate
        the binding's build fingerprint and re-reconcile it (the batched
        analogue of the raise→REQUEUE the per-object path had)."""
        ref = work.meta.labels.get(WORK_BINDING_LABEL, "")
        kind, sep, key = ref.partition(":")
        if not sep:
            return
        self._built.pop(ref, None)
        self.worker.enqueue((kind, key))

    def _gc_templates(self) -> None:
        """Collect content-addressed templates nothing references any
        more — checked AFTER the flush so a drain that re-pointed works
        at a new digest (bumping the old one to zero) and a drain that
        re-used a candidate digest both see the settled refcounts. Two
        independent liveness proofs must BOTH fail before a delete: the
        work index and the controller's own binding→digest bookkeeping
        (current by construction). A digest either gate calls live stays;
        a stale candidate just re-queues on the binding's next
        transition."""
        if not self._gc_digests:
            return
        digests, self._gc_digests = self._gc_digests, set()
        live = set(self._built_digest.values())
        for digest in digests:
            if digest in live:
                continue
            if self.work_index.digest_refcount(digest) == 0:
                self._tpl_published.discard(digest)
                self.store.delete("WorkloadTemplate", digest)
            else:
                # the index still sees references: a true revival —
                # re-check after the next flush
                self._gc_digests.add(digest)

    def _ensure_template(self, ref: str, template: Resource) -> str:
        """Digest + publish of the content-addressed WorkloadTemplate for
        this template's current content. The manifest doc is pruned
        exactly like the Work admission mutator prunes full-rendered
        manifests (status/uid/resourceVersion/creationTimestamp), so
        rehydration is byte-equivalent to full rendering."""
        ver = (
            template.meta.uid,
            template.meta.generation,
            template.meta.resource_version,
        )
        cached = self._tpl_cache.get(ref)
        if cached is not None and cached[0] == ver:
            digest, doc = cached[1], cached[2]
        else:
            doc = to_jsonable(template)
            doc["status"] = {}
            meta = doc.get("meta") or {}
            meta["uid"] = ""
            meta["resource_version"] = 0
            meta["creation_timestamp"] = 0.0
            digest = hashlib.blake2b(
                json.dumps(doc, sort_keys=True, separators=(",", ":"))
                .encode(), digest_size=16,
            ).hexdigest()
            self._tpl_cache[ref] = (ver, digest, doc)
        if digest not in self._tpl_published:
            if self.store.get("WorkloadTemplate", digest) is None:
                # published DIRECTLY (never buffered): the template must
                # be in the store before any buffered Work referencing it
                # flushes
                self.store.apply(WorkloadTemplate(
                    meta=ObjectMeta(name=digest), manifest=doc
                ))
            self._tpl_published.add(digest)
        return digest

    def _template_patch(
        self, template: Resource, rb: ResourceBinding, divided: bool,
        replicas: int,
    ) -> Optional[dict]:
        """The per-cluster spec patch for template-delta rendering, or
        None when this target is not templatable (custom revise hook —
        the hook may derive arbitrary fields from the count)."""
        if not divided or rb.spec.replicas <= 0:
            return {}
        patch = self.interpreter.revise_patch(template, replicas)
        if patch is None:
            return None
        if template.kind == "Job" and "completions" in template.spec:
            total = int(template.spec["completions"])
            patch["completions"] = math.ceil(
                total * replicas / max(rb.spec.replicas, 1)
            )
        return patch

    def _reconcile(self, kind_key) -> Optional[str]:
        kind, key = kind_key
        ref = binding_ref(kind, key)
        rb = self.store.get(kind, key)
        if rb is None:
            self._built.pop(ref, None)
            self._cleanup_works(ref, keep_clusters=set())
            self._forget_digest(ref)
            if not self._buffering:
                self._flush()
            return DONE
        template = self.store.get("Resource", rb.spec.resource.namespaced_key)
        if template is None:
            self._built.pop(ref, None)
            self._forget_digest(ref)
            if not self._buffering:
                self._flush()
            return DONE
        # target set: scheduled clusters + clusters still draining eviction
        # tasks (their Works must survive until eviction completes,
        # binding_controller.go:145-165)
        targets = {tc.name: tc.replicas for tc in rb.spec.clusters}
        evicting = {t.from_cluster for t in rb.spec.graceful_eviction_tasks}
        # RequiredBy snapshots extend the target set: dependencies follow
        # their dependers (binding/common.go mergeTargetClusters)
        for snap in rb.spec.required_by:
            for tc in snap.clusters:
                targets.setdefault(tc.name, 0)
        divided = (
            rb.spec.placement is not None
            and rb.spec.placement.replica_scheduling_type() == DIVIDED
        )
        fp_global = (
            template.meta.uid,
            self._template_token(template, divided),
            divided,
            # the binding's TOTAL replicas only shape a target's manifest
            # through the Job completions split; for every other kind the
            # manifest depends on the per-target count alone, and a scale
            # storm must not void every target's cache entry
            rb.spec.replicas
            if (template.kind == "Job" and "completions" in template.spec)
            else 0,
            rb.spec.suspend_dispatching,
            tuple(sorted(rb.spec.suspend_dispatching_on_clusters or ())),
            rb.spec.preserve_resources_on_deletion,
            rb.spec.conflict_resolution,
            # rendering MODE is part of the build identity: flipping the
            # template-delta kill switch must rebuild every Work in the
            # other representation
            template_delta_enabled(),
        )
        prev_global, prev_targets = self._built.get(ref, (None, None))
        unchanged = prev_global == fp_global and prev_targets is not None
        built_targets: dict[str, tuple] = {}
        # template-delta rendering: one content-addressed template for
        # the whole workload family, per-cluster Works carry only (digest,
        # replica patch) — the full manifest never clones once per
        # target. Per-TARGET fallback: a
        # custom revise hook or a matching override rule makes that
        # target full-render while the rest of the fleet stays delta.
        tpl_mode = template_delta_enabled() and isinstance(
            template.spec, dict
        )
        tpl_digest: Optional[str] = None
        fell_back_full = False  # some target REBUILT full this pass
        for cluster_name, replicas in targets.items():
            # apply_overrides matches rules against LIVE cluster state
            # (name / labels / provider / region / zone), so the per-target
            # cache entry carries a token over those fields: a cluster label
            # edit that flips an override rule's match rebuilds exactly the
            # Works on that cluster instead of going stale forever
            cluster_token = self._lookup_cluster_token(cluster_name)
            if unchanged and prev_targets.get(cluster_name) == (
                replicas,
                cluster_token,
            ):
                built_targets[cluster_name] = (replicas, cluster_token)
                continue  # this target's Work is already up to date
            cluster_obj = self.store.get("Cluster", cluster_name)
            built_targets[cluster_name] = (
                replicas, self._cluster_token(cluster_obj),
            )
            patch = (
                self._template_patch(template, rb, divided, replicas)
                if tpl_mode
                else None
            )
            if patch is not None and cluster_obj is not None:
                # override probe: any matching rule transforms the
                # manifest per cluster — that target must full-render.
                # Match-only (no clone, no overrider application): the
                # fallback path below runs the real transform once.
                if self.overrides.overrides_match(template, cluster_obj):
                    patch = None
            if patch is not None:
                if tpl_digest is None:
                    tpl_digest = self._ensure_template(ref, template)
                self._create_or_update_work(
                    rb, kind, cluster_name, None,
                    template_ref=WorkloadTemplateRef(
                        digest=tpl_digest,
                        api_version=template.api_version,
                        kind=template.kind,
                        namespace=template.meta.namespace,
                        name=template.meta.name,
                        patch=patch,
                    ),
                )
                continue
            fell_back_full = True
            # full-render fallback: every transform below (revise_replica,
            # apply_overrides) returns a fresh object, so the template is
            # cloned lazily — exactly ONE copy per Work, never three (the
            # redundant deepcopy chain dominated propagation-storm wall
            # time before the delta path existed)
            workload = template
            if divided and rb.spec.replicas > 0:
                workload = self.interpreter.revise_replica(workload, replicas)
                if workload is template:
                    workload = clone_resource(template)
                # Job completions division (binding/common.go:287-299)
                if workload.kind == "Job" and "completions" in workload.spec:
                    total = int(workload.spec["completions"])
                    workload.spec["completions"] = math.ceil(
                        total * replicas / max(rb.spec.replicas, 1)
                    )
            if cluster_obj is not None:
                workload = self.overrides.apply_overrides(workload, cluster_obj)
            if workload is template:
                workload = clone_resource(template)
            self._create_or_update_work(rb, kind, cluster_name, workload)
        self._cleanup_works(ref, keep_clusters=set(targets) | evicting)
        self._built[ref] = (fp_global, built_targets)
        # template GC bookkeeping: a binding whose content digest moved
        # (or went full-render) queues its OLD digest for a post-flush
        # refcount check
        if tpl_digest is not None:
            prev_digest = self._built_digest.get(ref)
            if prev_digest is not None and prev_digest != tpl_digest:
                self._gc_digests.add(prev_digest)
            self._built_digest[ref] = tpl_digest
        elif not tpl_mode:
            # genuinely full-rendered now (kill switch flipped, or the
            # workload stopped being templatable): drop the ref and let
            # the refcount check collect the orphaned template
            self._forget_digest(ref)
        elif fell_back_full and not any(
            w.spec.workload_template is not None
            and w.spec.workload_template.digest
            == self._built_digest.get(ref)
            for w in self.work_index.works_for(ref)
        ):
            # delta mode, no digest this pass, and some target REBUILT
            # full (e.g. an override rule now matches every cluster) —
            # and the indexed works no longer carry the old digest: the
            # binding has genuinely left delta rendering, so drop the
            # bookkeeping and let the refcount check collect the orphan.
            # The fell_back_full gate keeps a steady all-unchanged pass
            # (whose works still reference the digest, however laggy the
            # index) from dropping LIVE bookkeeping; the index gate keeps
            # the transition pass itself from racing its own flush.
            self._forget_digest(ref)
        else:
            # delta mode, every target signature-unchanged (or the index
            # still shows delta works): the digest stays live — queue a
            # harmless post-flush re-check and KEEP the bookkeeping
            prev_digest = self._built_digest.get(ref)
            if prev_digest is not None:
                self._gc_digests.add(prev_digest)
        if not self._buffering:
            self._flush()
        # close the build/event race: a Cluster event landing mid-build found
        # no _built entry to requeue against, and this reconcile may have
        # built against the pre-event object — re-check the freshly written
        # tokens against the watch-maintained map and requeue on divergence
        for name, (_reps, tok) in built_targets.items():
            cur = self._cluster_tokens.get(name, self._UNSEEDED)
            if cur is not self._UNSEEDED and cur != tok:
                self.worker.enqueue((kind, key))
                break
        return DONE

    # replica fields the per-target ReviseReplica pass overwrites; a
    # template change confined to them cannot alter an unchanged target's
    # manifest (its value is re-derived from the binding's division)
    _REPLICA_FIELDS = ("replicas", "parallelism", "completions")

    def _template_token(self, template: Resource, divided: bool) -> int:
        """Build-cache content token for the template. A hash over the
        manifest-shaping fields (spec + labels + annotations) rather than
        the generation: metadata-only edits don't bump generation, and
        resource_version bumps on status-only writes — neither is a valid
        cache key alone. For divided bindings whose kind has no custom
        ReviseReplica hook the top-level replica fields are excluded, so a
        fleet-wide scale storm (only replica counts change) keeps unchanged
        targets cached; custom-revise kinds hash the full spec (their hooks
        may derive arbitrary fields from the template's replica count)."""
        gvk = f"{template.api_version}/{template.kind}"
        exclude = divided and not self.interpreter.has_custom_revise(gvk)
        key = (template.meta.uid, exclude)
        ver = (template.meta.generation, template.meta.resource_version)
        cached = self._template_hashes.get(key)
        if cached is not None and cached[0] == ver:
            return cached[1]
        spec_view = (
            {
                k: v
                for k, v in template.spec.items()
                if k not in self._REPLICA_FIELDS
            }
            if exclude
            else template.spec
        )
        token = hash(
            (
                repr(spec_view),
                repr(sorted(template.meta.labels.items())),
                repr(sorted(template.meta.annotations.items())),
            )
        )
        self._template_hashes[key] = (ver, token)
        return token

    def _create_or_update_work(
        self,
        rb: ResourceBinding,
        kind: str,
        cluster: str,
        workload: Optional[Resource],
        *,
        template_ref: Optional[WorkloadTemplateRef] = None,
    ) -> None:
        ns = execution_namespace(cluster)
        name = f"{rb.meta.namespace + '.' if rb.meta.namespace else ''}{rb.meta.name}"
        key = f"{ns}/{name}"
        # per-target suspension: global flag OR the cluster is listed in
        # DispatchingOnClusters (binding/common.go:305-318)
        suspended = rb.spec.suspend_dispatching or (
            cluster in (rb.spec.suspend_dispatching_on_clusters or ())
        )
        if template_ref is not None:
            desired_sig = (
                ("tpl", template_ref.digest, _patch_key(template_ref.patch)),
                None,
            )
        else:
            desired_sig = (workload.spec, workload.meta.labels)
        existing = self.store.get("Work", key)
        if existing is not None and _work_signature(existing) == (
            desired_sig
            + (suspended, rb.spec.preserve_resources_on_deletion)
        ):
            return  # no semantic change — avoid churn (idempotent reconcile)
        work = existing or Work(meta=ObjectMeta(name=name, namespace=ns))
        work.meta.labels[WORK_BINDING_LABEL] = binding_ref(
            kind, rb.meta.namespaced_name
        )
        work.spec = WorkSpec(
            workload=[workload] if workload is not None else [],
            workload_template=template_ref,
            suspend_dispatching=suspended,
            preserve_resources_on_deletion=rb.spec.preserve_resources_on_deletion,
            conflict_resolution=rb.spec.conflict_resolution,
        )
        self._apply_work(work)
        # only SEMANTIC creates/updates count (the signature gate above
        # returned on no-ops): the work-render throughput of a wave
        works_rendered.inc()

    def _forget_digest(self, binding_key: str) -> None:
        self._tpl_cache.pop(binding_key, None)
        digest = self._built_digest.pop(binding_key, None)
        if digest is not None:
            self._gc_digests.add(digest)

    def _cleanup_works(self, binding_key: str, keep_clusters: set[str]) -> None:
        for work in self.work_index.works_for(binding_key):
            cluster = cluster_of_execution_namespace(work.meta.namespace)
            if cluster not in keep_clusters:
                self._delete_work(work.meta.namespaced_name)


class ExecutionController:
    """Work -> member cluster apply/delete (pkg/controllers/execution/)."""

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        members: MemberClientRegistry,
        interpreter: ResourceInterpreter,
    ) -> None:
        self.store = store
        self.members = members
        self.watcher = ObjectWatcher(members, interpreter)
        self.rehydrator = TemplateRehydrator(store)
        # deletes parked while a cluster is unreachable; retried when the
        # cluster comes back (the asynchronous-retry analogue — burning
        # requeue budget against a dead cluster helps nobody)
        self._pending_deletes: dict[str, set[tuple[str, str, str]]] = {}
        # work keys parked on a template that is not in the store yet;
        # the WorkloadTemplate watch unparks them
        self._awaiting_template: dict[str, set] = {}
        # per-drain write set: Work condition updates flush as one batch
        self._buffering = False
        self._pending_applies: list = []
        self.worker = runtime.new_worker(
            "execution", self._reconcile,
            reconcile_batch=self._reconcile_batch,
        )
        store.watch("Work", self._on_work_event)
        store.watch("Cluster", self._on_cluster_event)
        store.watch("WorkloadTemplate", self._on_template_event, replay=False)

    def _on_cluster_event(self, event) -> None:
        pending = self._pending_deletes.pop(event.key, None)
        if pending:
            self.worker.enqueue(("delete", event.key, tuple(sorted(pending))))

    def _on_template_event(self, event) -> None:
        if event.type == "Deleted":
            self.rehydrator.forget_digest(event.key)
            return
        parked = self._awaiting_template.pop(event.key, None)
        if parked:
            for item in parked:
                self.worker.enqueue(item)

    def _on_work_event(self, event) -> None:
        if event.type == "Deleted":
            # the Work is gone from the store; carry what we need to delete
            # the propagated objects (honoring PreserveResourcesOnDeletion,
            # execution_controller.go:229-257)
            work: Work = event.obj
            self.rehydrator.forget_work(event.key)
            # a Work deleted while parked on a never-arriving template
            # must not leak its parked entry
            for parked in self._awaiting_template.values():
                parked.discard(("apply", event.key, None))
            cluster = cluster_of_execution_namespace(work.meta.namespace)
            if cluster is None or work.spec.preserve_resources_on_deletion:
                return
            tref = work.spec.workload_template
            if tref is not None and tref.digest:
                # template-delta works carry target identity on the ref
                targets = (
                    (f"{tref.api_version}/{tref.kind}",
                     tref.namespace, tref.name),
                )
            else:
                targets = tuple(
                    (f"{w.api_version}/{w.kind}",
                     w.meta.namespace, w.meta.name)
                    for w in work.spec.workload
                )
            self.worker.enqueue(("delete", cluster, targets))
        else:
            self.worker.enqueue(("apply", event.key, None))

    def _reconcile_batch(self, items) -> dict:
        out: dict = {}
        self._buffering = True
        try:
            for item in items:
                out[item] = self._reconcile(item)
        finally:
            self._buffering = False
            self._flush()
        return out

    def _apply_status(self, work: Work) -> None:
        if self._buffering:
            self._pending_applies.append(work)
        else:
            self.store.apply(work)

    def _flush(self) -> None:
        applies, self._pending_applies = self._pending_applies, []
        for work, _err in self.store.apply_many(applies):
            # rejected status write: retry the Work (the unbatched path
            # raised and the worker requeued)
            self.worker.enqueue(("apply", work.meta.namespaced_name, None))

    def _reconcile(self, item) -> Optional[str]:
        action, key_or_cluster, targets = item
        if action == "delete":
            for gvk, ns, name in targets:
                try:
                    self.watcher.delete(key_or_cluster, gvk, ns, name)
                except UnreachableError:
                    self._pending_deletes.setdefault(key_or_cluster, set()).add(
                        (gvk, ns, name)
                    )
            return DONE
        key = key_or_cluster
        work = self.store.get("Work", key)
        cluster = cluster_of_execution_namespace(key.split("/", 1)[0])
        if work is None or cluster is None:
            return DONE
        cluster_obj = self.store.get("Cluster", cluster)
        if cluster_obj is not None and cluster_obj.spec.sync_mode == "Pull":
            return DONE  # the in-cluster agent applies Pull-mode works
        if work.spec.suspend_dispatching:
            if set_condition(
                work.status.conditions,
                Condition(
                    type="Dispatching", status=False, reason="SuspendDispatching"
                ),
            ):
                self._apply_status(work)
            return DONE
        manifests = self.rehydrator.manifests(work)
        if manifests is None:
            # template not mirrored yet: park on its digest (the watch
            # unparks) AND requeue under backoff as a belt-and-braces
            self._awaiting_template.setdefault(
                work.spec.workload_template.digest, set()
            ).add(item)
            return REQUEUE
        try:
            for workload in manifests:
                self.watcher.create_or_update(
                    cluster, workload,
                    conflict_resolution=work.spec.conflict_resolution,
                )
        except ConflictError as e:
            if set_condition(
                work.status.conditions,
                Condition(
                    type=WORK_APPLIED, status=False,
                    reason="ResourceConflict", message=str(e),
                ),
            ):
                self._apply_status(work)
            return DONE  # permanent until the member object changes
        except UnreachableError:
            if set_condition(
                work.status.conditions,
                Condition(type=WORK_APPLIED, status=False, reason="ClusterUnreachable"),
            ):
                self._apply_status(work)
            return REQUEUE
        if set_condition(
            work.status.conditions,
            Condition(type=WORK_APPLIED, status=True, reason="AppliedSuccessful"),
        ):
            self._apply_status(work)
        return DONE


class WorkStatusController:
    """Member object events -> Work.Status.ManifestStatuses (+ recreation of
    deleted-but-desired objects)."""

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        members: MemberClientRegistry,
        interpreter: ResourceInterpreter,
        work_index: Optional[WorkIndex] = None,
    ) -> None:
        self.store = store
        self.members = members
        self.interpreter = interpreter
        self.work_index = work_index or WorkIndex(store)
        self.rehydrator = TemplateRehydrator(store)
        # member-event keys parked on a template that has not mirrored
        # yet (the recreate path needs the rehydrated manifest); the
        # WorkloadTemplate watch unparks them — REQUEUE alone drops the
        # key after MAX_RETRIES in cooperative mode
        self._awaiting_template: dict[str, set] = {}
        self.worker = runtime.new_worker("work-status", self._reconcile)
        # rehydrator eviction: without these the decode/render caches
        # grow with ALL-TIME work/template churn
        store.watch("Work", self._on_work_event, replay=False)
        store.watch(
            "WorkloadTemplate", self._on_template_event, replay=False
        )
        for name in members.names():
            client = members.get(name)
            if client is not None:
                client.watch(self._on_member_event)

    def watch_member(self, member) -> None:
        member.watch(self._on_member_event)

    def _on_member_event(self, event: MemberEvent) -> None:
        self.worker.enqueue(
            (event.cluster, event.gvk, event.namespace, event.name, event.type)
        )

    def _find_work(self, cluster: str, gvk: str, namespace: str, name: str):
        """(work, desired manifest | None) for a member target. For
        template-delta works the identity check rides the ref and the
        manifest rehydrates lazily; a missing template answers (work,
        None) so the recreate path can REQUEUE instead of dropping."""
        work = self.work_index.work_for_target(cluster, gvk, namespace, name)
        if work is None:
            return None, None
        tref = work.spec.workload_template
        if tref is not None and tref.digest:
            if (
                f"{tref.api_version}/{tref.kind}" == gvk
                and tref.namespace == namespace
                and tref.name == name
            ):
                manifests = self.rehydrator.manifests(work)
                return work, manifests[0] if manifests else None
            return None, None
        for workload in work.spec.workload:
            if (
                f"{workload.api_version}/{workload.kind}" == gvk
                and workload.meta.namespace == namespace
                and workload.meta.name == name
            ):
                return work, workload
        return None, None

    def _on_work_event(self, event) -> None:
        if event.type == "Deleted":
            self.rehydrator.forget_work(event.key)

    def _on_template_event(self, event) -> None:
        if event.type == "Deleted":
            self.rehydrator.forget_digest(event.key)
            return
        parked = self._awaiting_template.pop(event.key, None)
        if parked:
            for key in parked:
                self.worker.enqueue(key)

    def _reconcile(self, key) -> Optional[str]:
        cluster, gvk, namespace, name, event_type = key
        work, desired = self._find_work(cluster, gvk, namespace, name)
        if work is None:
            return DONE
        member = self.members.get(cluster)
        if member is None:
            return DONE
        try:
            observed = member.get(gvk, namespace, name)
        except UnreachableError:
            return REQUEUE
        if observed is None:
            # recreate deleted-but-desired (work_status_controller.go:311)
            if not work.spec.preserve_resources_on_deletion:
                if desired is None:
                    # template not mirrored yet: park on the digest (the
                    # watch unparks) AND requeue as a belt-and-braces
                    self._awaiting_template.setdefault(
                        work.spec.workload_template.digest, set()
                    ).add(key)
                    return REQUEUE
                try:
                    ObjectWatcher(self.members, self.interpreter).create_or_update(
                        cluster, desired
                    )
                except UnreachableError:
                    return REQUEUE
            return DONE
        status = self.interpreter.reflect_status(observed)
        # health is Unknown until the member reports any status — a fresh
        # object is not "Unhealthy" (failover must not fire on it)
        if status is None:
            health = "Unknown"
        else:
            health = (
                "Healthy" if self.interpreter.interpret_health(observed) else "Unhealthy"
            )
        identifier = observed.object_reference()
        updated = False
        for ms in work.status.manifest_statuses:
            if (
                ms.identifier.gvk == identifier.gvk
                and ms.identifier.namespaced_key == identifier.namespaced_key
            ):
                if ms.status != status or ms.health != health:
                    ms.status = status
                    ms.health = health
                    updated = True
                break
        else:
            work.status.manifest_statuses.append(
                ManifestStatus(identifier=identifier, status=status, health=health)
            )
            updated = True
        if updated:
            self.store.apply(work)
        return DONE


class BindingStatusController:
    """Work.Status -> ResourceBinding.Status.AggregatedStatus (+ FullyApplied
    condition), then template status write-back via the detector."""

    def __init__(
        self,
        store: Store,
        runtime: Runtime,
        detector,
        work_index: Optional[WorkIndex] = None,
    ) -> None:
        self.store = store
        self.detector = detector
        self.work_index = work_index or WorkIndex(store)
        # per-drain write set: binding status updates flush as one batch
        # (then write back template statuses for exactly those bindings)
        self._buffering = False
        self._pending: list = []
        self.worker = runtime.new_worker(
            "binding-status", self._reconcile,
            reconcile_batch=self._reconcile_batch,
        )
        store.watch("Work", self._on_work_event)

    def _on_work_event(self, event) -> None:
        key = event.obj.meta.labels.get(WORK_BINDING_LABEL)
        if key:
            self.worker.enqueue(key)

    def _reconcile_batch(self, refs) -> dict:
        out: dict = {}
        self._buffering = True
        try:
            for ref in refs:
                out[ref] = self._reconcile(ref)
        finally:
            self._buffering = False
            self._flush()
        return out

    def _commit(self, rb) -> None:
        if self._buffering:
            self._pending.append(rb)
            return
        self.store.apply(rb)
        if self.detector is not None:
            self.detector.write_back_status(rb)

    def _flush(self) -> None:
        pending, self._pending = self._pending, []
        if not pending:
            return
        failed: set[int] = set()
        for rb, _err in self.store.apply_many(pending):
            failed.add(id(rb))
            # rejected status write: re-aggregate this binding (the
            # unbatched path raised and the worker requeued)
            self.worker.enqueue(binding_ref(type(rb).KIND, rb.meta.namespaced_name))
        if self.detector is not None:
            for rb in pending:
                if id(rb) not in failed:
                    self.detector.write_back_status(rb)

    def _reconcile(self, ref: str) -> Optional[str]:
        kind, _, key = ref.partition(":")
        if kind not in BINDING_KINDS:
            return DONE
        rb = self.store.get(kind, key)
        if rb is None:
            return DONE
        items: list[AggregatedStatusItem] = []
        applied_clusters = set()
        for work in self.work_index.works_for(ref):
            cluster = cluster_of_execution_namespace(work.meta.namespace)
            if cluster is None:
                continue
            applied_cond = next(
                (c for c in work.status.conditions if c.type == WORK_APPLIED),
                None,
            )
            applied = applied_cond is not None and applied_cond.status
            if applied:
                applied_clusters.add(cluster)
            if work.status.manifest_statuses:
                for ms in work.status.manifest_statuses:
                    items.append(
                        AggregatedStatusItem(
                            cluster_name=cluster,
                            status=ms.status,
                            applied=applied,
                            health=ms.health,
                        )
                    )
            elif applied_cond is not None and not applied:
                # a Work that failed to apply (conflict, unreachable) never
                # reports manifest statuses — the failure must still be
                # visible in the binding aggregation (the reference emits
                # per-manifest items with Applied=false + AppliedMessage)
                items.append(
                    AggregatedStatusItem(
                        cluster_name=cluster,
                        status=None,
                        applied=False,
                        health="Unknown",
                        applied_message=applied_cond.message,
                    )
                )
        items.sort(key=lambda i: i.cluster_name)
        target_clusters = {tc.name for tc in rb.spec.clusters}
        status_changed = rb.status.aggregated_status != items
        rb.status.aggregated_status = items
        cond_changed = set_condition(
            rb.status.conditions,
            Condition(
                type=FULLY_APPLIED,
                status=bool(target_clusters) and target_clusters <= applied_clusters,
                reason="FullyAppliedSuccess"
                if target_clusters <= applied_clusters
                else "FullyAppliedFailed",
            ),
        )
        if status_changed or cond_changed:
            self._commit(rb)
        return DONE
