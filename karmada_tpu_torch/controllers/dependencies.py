"""DependenciesDistributor: propagate a workload's dependencies alongside it.

The port's own copy of ``karmada_tpu/controllers/dependencies.py``. Ref: pkg/dependenciesdistributor/dependencies_distributor.go:333-595 — when
a policy sets propagateDeps, the interpreter's GetDependencies (configmaps,
secrets, PVCs, service accounts) produces *attached* ResourceBindings that
shadow the independent binding's schedule result (RequiredBy snapshots), so
dependencies land wherever the workload lands.
"""

from __future__ import annotations

from typing import Optional

from ..api.core import ObjectMeta
from ..api.work import BindingSnapshot, ResourceBinding, ResourceBindingSpec
from ..interpreter import ResourceInterpreter
from ..utils import DONE, Runtime, Store

DEPENDED_BY_LABEL = "resourcebinding.karmada.io/depended-by"


def attached_binding_name(dep_kind: str, dep_name: str) -> str:
    return f"{dep_name}-{dep_kind.lower()}"


class DependenciesDistributor:
    def __init__(
        self, store: Store, runtime: Runtime, interpreter: ResourceInterpreter
    ) -> None:
        self.store = store
        self.interpreter = interpreter
        self.worker = runtime.new_worker("dependencies", self._reconcile)
        # parent binding key -> attached binding keys; an informer-style
        # index replacing the full-store scans the cleanup paths ran per
        # reconcile (O(bindings) per event drowned propagation storms).
        # Pre-existing attachments are seeded by the watch's replay of
        # ADDED events (informer initial-list semantics). The reverse map
        # prunes the index when a binding loses or changes its depended-by
        # label (adoption / re-parenting), so cleanup never deletes a
        # binding that is no longer attached.
        self._attached: dict[str, set[str]] = {}
        self._attached_parent: dict[str, str] = {}
        store.watch("ResourceBinding", self._on_binding_event)

    def _on_binding_event(self, event) -> None:
        rb = event.obj
        # attached bindings don't drive themselves, but they feed the index;
        # everything else may need (re)distribution or cleanup (e.g.
        # propagateDeps turned off)
        parent = rb.meta.labels.get(DEPENDED_BY_LABEL)
        old = self._attached_parent.get(event.key)
        if old is not None and (event.type == "Deleted" or old != parent):
            self._attached.get(old, set()).discard(event.key)
            del self._attached_parent[event.key]
        if parent is not None:
            if event.type != "Deleted":
                self._attached.setdefault(parent, set()).add(event.key)
                self._attached_parent[event.key] = parent
            return
        self.worker.enqueue(event.key)

    def _reconcile(self, key: str) -> Optional[str]:
        rb = self.store.get("ResourceBinding", key)
        if rb is None or not rb.spec.propagate_deps:
            self._cleanup_attached(key)
            return DONE
        if not rb.spec.clusters:
            return DONE  # nothing scheduled yet
        template = self.store.get("Resource", rb.spec.resource.namespaced_key)
        if template is None:
            return DONE
        deps = self.interpreter.get_dependencies(template)
        seen_keys = set()
        for dep in deps:
            dep_template = self.store.get(
                "Resource", f"{dep.namespace}/{dep.name}" if dep.namespace else dep.name
            )
            if dep_template is None or dep_template.kind != dep.kind:
                continue  # dependency not present on the control plane
            name = attached_binding_name(dep.kind, dep.name)
            akey = f"{dep.namespace}/{name}" if dep.namespace else name
            seen_keys.add(akey)
            existing = self.store.get("ResourceBinding", akey)
            snapshot = BindingSnapshot(
                namespace=rb.meta.namespace,
                name=rb.meta.name,
                clusters=list(rb.spec.clusters),
            )
            if existing is not None and DEPENDED_BY_LABEL in existing.meta.labels:
                changed = self._merge_required_by(existing, snapshot)
                if changed:
                    self._sync_clusters(existing)
                    self.store.apply(existing)
                continue
            if existing is not None:
                # independent binding already exists for the dependency; the
                # reference merges RequiredBy into it (suppressed schedule)
                changed = self._merge_required_by(existing, snapshot)
                if changed:
                    self.store.apply(existing)
                continue
            attached = ResourceBinding(
                meta=ObjectMeta(
                    name=name,
                    namespace=dep.namespace,
                    labels={DEPENDED_BY_LABEL: rb.meta.namespaced_name},
                ),
                spec=ResourceBindingSpec(
                    resource=dep_template.object_reference(),
                    replicas=0,
                    required_by=[snapshot],
                    # attached bindings shadow the parent's schedule; the
                    # scheduler must not re-place them
                    scheduler_name="",
                ),
            )
            self._sync_clusters(attached)
            self.store.apply(attached)
        # drop stale attachments no longer in the dependency set
        for akey in list(self._attached.get(key, ())):
            if akey not in seen_keys:
                self.store.delete("ResourceBinding", akey)
        return DONE

    def _merge_required_by(self, binding: ResourceBinding, snap: BindingSnapshot) -> bool:
        for i, existing in enumerate(binding.spec.required_by):
            if (
                existing.namespace == snap.namespace
                and existing.name == snap.name
            ):
                if [
                    (c.name, c.replicas) for c in existing.clusters
                ] != [(c.name, c.replicas) for c in snap.clusters]:
                    binding.spec.required_by[i] = snap
                    self._sync_clusters(binding)
                    return True
                return False
        binding.spec.required_by.append(snap)
        self._sync_clusters(binding)
        return True

    def _sync_clusters(self, binding: ResourceBinding) -> None:
        """Attached bindings aggregate the union of all RequiredBy cluster
        sets as their own schedule result (zero-replica placement)."""
        if DEPENDED_BY_LABEL not in binding.meta.labels and binding.spec.clusters:
            return  # independent binding keeps its own schedule
        from ..api.work import TargetCluster

        clusters: dict[str, int] = {}
        for snap in binding.spec.required_by:
            for tc in snap.clusters:
                clusters.setdefault(tc.name, 0)
        binding.spec.clusters = [
            TargetCluster(name=n) for n in sorted(clusters)
        ]

    def _cleanup_attached(self, parent_key: str) -> None:
        for akey in list(self._attached.get(parent_key, ())):
            self.store.delete("ResourceBinding", akey)
