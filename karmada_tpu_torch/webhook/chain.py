"""Admission chain: per-kind mutators then validators, run on store.apply.

The port's own copy of ``karmada_tpu/webhook/chain.py`` for the kinds the
port's plane stores: propagation and override policies (both scopes),
ResourceBinding and ClusterResourceBinding, Work and Cluster,
FederatedResourceQuota and WorkloadRebalancer, FederatedHPA and
CronFederatedHPA, MultiClusterService and MultiClusterIngress, and deletion
protection on every kind. The validators of the interpreter configurations
come with the interpreter's configuration managers (ROADMAP A7b).
"""

from __future__ import annotations

import re
import uuid
from typing import Any, Callable

from ..api.cluster import MAX_INT64, default_resource_models, standardize_resource_models
from ..api.policy import (
    DIVIDED,
    DUPLICATED,
    WEIGHTED,
    AGGREGATED,
    PropagationPolicy,
)
from ..utils.clone import clone_resource
from ..utils.cron import _parse_field
from ..utils.features import CUSTOMIZED_CLUSTER_RESOURCE_MODELING, feature_gate

PERMANENT_ID_ANNOTATION = "policy.karmada.io/permanent-id"
PERMANENT_ID_LABEL = "work.karmada.io/permanent-id"
DELETION_PROTECTION_LABEL = "resourcetemplate.karmada.io/deletion-protected"
DELETION_PROTECTION_ALWAYS = "Always"


class ValidationError(Exception):
    """Admission rejection (webhook validate deny)."""


Mutator = Callable[[Any], None]
Validator = Callable[[Any], None]


class AdmissionChain:
    def __init__(self) -> None:
        self._mutators: dict[str, list[Mutator]] = {}
        self._validators: dict[str, list[Validator]] = {}
        self._delete_validators: dict[str, list[Validator]] = {}

    def register_mutator(self, kind: str, fn: Mutator) -> None:
        self._mutators.setdefault(kind, []).append(fn)

    def register_validator(self, kind: str, fn: Validator) -> None:
        self._validators.setdefault(kind, []).append(fn)

    def register_delete_validator(self, kind: str, fn: Validator) -> None:
        """Delete-operation admission ('*' = every kind); ref:
        resourcedeletionprotection/validating.go handles only Delete."""
        self._delete_validators.setdefault(kind, []).append(fn)

    def admit(self, kind: str, obj: Any) -> None:
        for fn in self._mutators.get(kind, []):
            fn(obj)
        for fn in self._validators.get(kind, []):
            fn(obj)

    def admit_delete(self, kind: str, obj: Any) -> None:
        for fn in self._delete_validators.get(kind, []) + self._delete_validators.get(
            "*", []
        ):
            fn(obj)


# --- mutators (defaulting; ref: pkg/webhook/*/mutating.go) -------------------


def mutate_propagation_policy(policy: PropagationPolicy) -> None:
    if PERMANENT_ID_ANNOTATION not in policy.meta.annotations:
        policy.meta.annotations[PERMANENT_ID_ANNOTATION] = str(uuid.uuid4())
    pl = policy.spec.placement
    for sc in pl.spread_constraints:
        if sc.min_groups <= 0:
            sc.min_groups = 1  # webhook defaults minGroups to 1
    if not policy.spec.scheduler_name:
        policy.spec.scheduler_name = "default-scheduler"
    if not policy.spec.conflict_resolution:
        policy.spec.conflict_resolution = "Abort"


def mutate_override_policy(policy) -> None:
    """Default resource-selector namespaces to the policy's namespace
    (overridepolicy/mutating.go)."""
    for sel in policy.spec.resource_selectors:
        if not getattr(sel, "namespace", "") and policy.meta.namespace:
            sel.namespace = policy.meta.namespace


def mutate_work(work) -> None:
    """Permanent-ID label + prune runtime fields from manifests
    (work/mutating.go: uuid label, prune.RemoveIrrelevantFields)."""
    if not work.meta.labels.get(PERMANENT_ID_LABEL):
        work.meta.labels[PERMANENT_ID_LABEL] = str(uuid.uuid4())
    # prune on copies: controllers may alias live store objects into
    # spec.workload, and mutating those in place would corrupt the store.
    # Already-pruned manifests (every re-apply of an existing Work — e.g.
    # condition updates) skip the copy entirely: nothing would change, so
    # there is nothing to protect. This runs on EVERY Work apply and the
    # deepcopy was the single largest cost of a propagation storm.
    pruned = []
    for manifest in work.spec.workload:
        if (
            not manifest.status
            and not manifest.meta.uid
            and manifest.meta.resource_version == 0
            and manifest.meta.creation_timestamp == 0.0
        ):
            pruned.append(manifest)
            continue
        manifest = clone_resource(manifest)
        manifest.status = {}
        manifest.meta.uid = ""
        manifest.meta.resource_version = 0
        manifest.meta.creation_timestamp = 0.0
        pruned.append(manifest)
    work.spec.workload = pruned


def mutate_binding_permanent_id(rb) -> None:
    """resourcebinding/clusterresourcebinding mutating.go."""
    if not rb.meta.labels.get(PERMANENT_ID_LABEL):
        rb.meta.labels[PERMANENT_ID_LABEL] = str(uuid.uuid4())


def mutate_multicluster_service(mcs) -> None:
    """multiclusterservice/mutating.go: permanent-ID label."""
    if not mcs.meta.labels.get(PERMANENT_ID_LABEL):
        mcs.meta.labels[PERMANENT_ID_LABEL] = str(uuid.uuid4())


def mutate_federated_hpa(hpa) -> None:
    """federatedhpa/mutating.go → lifted.SetDefaultsFederatedHPA: default
    only nil fields — an explicit invalid 0 must reach the validator."""
    if hpa.spec.min_replicas is None:
        hpa.spec.min_replicas = 1
    if hpa.spec.stabilization_window_seconds is None:
        hpa.spec.stabilization_window_seconds = 300


# --- validators (ref: pkg/webhook/*/validating.go) ---------------------------


def _validate_field_selector(aff) -> None:
    """util/validation.ValidatePolicyFieldSelector: only the cluster
    provider/region/zone fields are matchable, with In/NotIn."""
    if aff is None or aff.field_selector is None:
        return
    for req in aff.field_selector.match_expressions:
        if req.key not in ("provider", "region", "zone"):
            raise ValidationError(
                f"unsupported fieldSelector key {req.key!r} "
                "(only provider/region/zone)"
            )
        if req.operator not in ("In", "NotIn"):
            raise ValidationError(
                f"unsupported fieldSelector operator {req.operator!r}"
            )


def validate_placement(pl) -> None:
    if pl is None:
        return
    if pl.cluster_affinity is not None and pl.cluster_affinities:
        raise ValidationError(
            "clusterAffinity and clusterAffinities are mutually exclusive"
        )
    _validate_field_selector(pl.cluster_affinity)
    for term in pl.cluster_affinities:
        _validate_field_selector(term)
    names = [t.affinity_name for t in pl.cluster_affinities]
    if len(names) != len(set(names)):
        raise ValidationError("clusterAffinities names must be unique")
    if any(not n for n in names):
        raise ValidationError("clusterAffinities entries need affinityName")
    by_field = {}
    for sc in pl.spread_constraints:
        if sc.spread_by_field and sc.spread_by_label:
            raise ValidationError(
                "spreadByField and spreadByLabel are mutually exclusive"
            )
        if sc.spread_by_field:
            if sc.spread_by_field not in ("cluster", "zone", "region", "provider"):
                raise ValidationError(
                    f"invalid spreadByField {sc.spread_by_field!r}"
                )
            if sc.spread_by_field in by_field:
                raise ValidationError(
                    f"duplicate spread constraint for {sc.spread_by_field}"
                )
            by_field[sc.spread_by_field] = sc
        if sc.max_groups and sc.max_groups < sc.min_groups:
            raise ValidationError("maxGroups must be >= minGroups")
        if sc.max_groups < 0 or sc.min_groups < 0:
            raise ValidationError("spread constraint groups must be >= 0")
    # a region/provider/zone constraint requires cluster-or-region selection
    # support (select_clusters.go:58)
    rs = pl.replica_scheduling
    if rs is not None:
        if rs.replica_scheduling_type not in ("", DUPLICATED, DIVIDED):
            raise ValidationError(
                f"invalid replicaSchedulingType {rs.replica_scheduling_type!r}"
            )
        if rs.replica_scheduling_type == DIVIDED and rs.replica_division_preference:
            if rs.replica_division_preference not in (AGGREGATED, WEIGHTED):
                raise ValidationError(
                    f"invalid replicaDivisionPreference "
                    f"{rs.replica_division_preference!r}"
                )
        wp = rs.weight_preference
        if wp is not None:
            for entry in wp.static_weight_list:
                if entry.weight < 1:
                    raise ValidationError("static weights must be >= 1")
            if wp.dynamic_weight and wp.dynamic_weight != "AvailableReplicas":
                raise ValidationError(
                    f"invalid dynamicWeight factor {wp.dynamic_weight!r}"
                )


def validate_propagation_policy(policy: PropagationPolicy) -> None:
    if not policy.spec.resource_selectors:
        raise ValidationError("resourceSelectors must not be empty")
    # kubebuilder enum on ActivationPreference (propagation_types.go:176)
    if getattr(policy.spec, "activation_preference", "") not in ("", "Lazy"):
        raise ValidationError(
            f"invalid activationPreference "
            f"{policy.spec.activation_preference!r} (must be Lazy or empty)"
        )
    validate_placement(policy.spec.placement)
    fo = policy.spec.failover
    if fo is not None and fo.application is not None:
        app = fo.application
        if app.decision_conditions_toleration_seconds < 0:
            raise ValidationError("tolerationSeconds must be >= 0")
        if app.purge_mode not in ("Immediately", "Graciously", "Never"):
            raise ValidationError(f"invalid purgeMode {app.purge_mode!r}")


def validate_override_policy(policy) -> None:
    for rule in policy.spec.override_rules:
        for po in rule.overriders.plaintext:
            if po.operator not in ("add", "remove", "replace"):
                raise ValidationError(f"invalid plaintext operator {po.operator!r}")
            if not po.path.startswith("/"):
                raise ValidationError("plaintext path must start with '/'")
        for io in rule.overriders.image_overrider:
            if io.component not in ("Registry", "Repository", "Tag"):
                raise ValidationError(f"invalid image component {io.component!r}")
        for fo in getattr(rule.overriders, "field_overrider", []):
            # one instance processes either JSON or YAML, never both
            # (override_types.go:270)
            if fo.json and fo.yaml:
                raise ValidationError(
                    "fieldOverrider carries either json or yaml operations, "
                    "not both"
                )
            if not fo.field_path.startswith("/"):
                raise ValidationError("fieldOverrider fieldPath must start with '/'")
            for op in fo.json + fo.yaml:
                if op.operator not in ("add", "remove", "replace"):
                    raise ValidationError(
                        f"invalid fieldOverrider operator {op.operator!r}"
                    )


def validate_federated_resource_quota(frq) -> None:
    for assignment in frq.spec.static_assignments:
        for res, v in assignment.hard.items():
            if v < 0:
                raise ValidationError("quota values must be >= 0")
            if res not in frq.spec.overall:
                raise ValidationError(
                    f"static assignment resource {res!r} missing from overall"
                )
    totals: dict[str, int] = {}
    for assignment in frq.spec.static_assignments:
        for res, v in assignment.hard.items():
            totals[res] = totals.get(res, 0) + v
    for res, total in totals.items():
        if total > frq.spec.overall.get(res, 0):
            raise ValidationError(
                f"static assignments for {res!r} exceed the overall quota"
            )
    # quota-shrink guard (the reference validates spec updates against
    # live usage): an update that CHANGES overall — spec.overall differs
    # from the last-reconciled status.overall — must not drop any tracked
    # resource below current status.overall_used. The status controller's
    # own writes always carry status.overall == spec.overall (it syncs
    # them in the same reconcile), so recording over-usage that predates a
    # quota (bindings bound before the FRQ existed) is never blocked.
    used = frq.status.overall_used or {}
    for res, limit in frq.spec.overall.items():
        if (
            frq.status.overall.get(res) != limit
            and used.get(res, 0) > limit
        ):
            raise ValidationError(
                f"cannot shrink overall[{res!r}] to {limit} below current "
                f"usage {used[res]}"
            )


def validate_resource_binding(rb) -> None:
    if rb.spec.replicas < 0:
        raise ValidationError("replicas must be >= 0")
    validate_placement(rb.spec.placement)


def validate_federated_hpa(hpa) -> None:
    if hpa.spec.min_replicas < 1:
        raise ValidationError("minReplicas must be >= 1")
    if hpa.spec.max_replicas < hpa.spec.min_replicas:
        raise ValidationError("maxReplicas must be >= minReplicas")
    if not hpa.spec.scale_target_ref.name:
        raise ValidationError("scaleTargetRef.name is required")
    for m in hpa.spec.metrics:
        if (
            m.target_average_utilization is not None
            and not 1 <= m.target_average_utilization <= 100
        ):
            raise ValidationError("targetAverageUtilization must be in [1, 100]")


def validate_cron_federated_hpa(cron) -> None:
    names = [r.name for r in cron.spec.rules]
    if len(names) != len(set(names)):
        raise ValidationError("rule names must be unique")
    for rule in cron.spec.rules:
        fields = rule.schedule.split()
        if len(fields) != 5:
            raise ValidationError(f"invalid cron schedule {rule.schedule!r}")
        try:
            for f, lo, hi in zip(fields, (0, 0, 1, 1, 0), (59, 23, 31, 12, 6)):
                _parse_field(f, lo, hi)
        except (ValueError, IndexError) as e:
            raise ValidationError(f"invalid cron schedule {rule.schedule!r}: {e}")
        if (
            rule.target_replicas is None
            and rule.target_min_replicas is None
            and rule.target_max_replicas is None
        ):
            raise ValidationError(
                f"rule {rule.name!r} must set targetReplicas or min/max bounds"
            )


def validate_multicluster_service(mcs) -> None:
    valid_types = {"CrossCluster", "LoadBalancer"}
    for t in mcs.spec.types:
        if t not in valid_types:
            raise ValidationError(f"invalid exposure type {t!r}")


def validate_multicluster_ingress(mci) -> None:
    """multiclusteringress/validating.go: ingress rule sanity."""
    for rule in mci.spec.rules:
        for path in (rule.get("http") or {}).get("paths", []):
            # unset pathType defaults to ImplementationSpecific (k8s default)
            ptype = path.get("pathType") or "ImplementationSpecific"
            if ptype not in ("Exact", "Prefix", "ImplementationSpecific"):
                raise ValidationError(f"invalid pathType {ptype!r}")
            if ptype in ("Exact", "Prefix") and not str(
                path.get("path", "")
            ).startswith("/"):
                raise ValidationError("ingress path must be absolute")
            backend = path.get("backend") or {}
            if not (backend.get("service") or {}).get("name"):
                raise ValidationError("ingress backend service name required")


def validate_deletion_protection(obj) -> None:
    """resourcedeletionprotection/validating.go: deny Delete while the
    protection label is Always."""
    labels = getattr(obj.meta, "labels", None) or {}
    if labels.get(DELETION_PROTECTION_LABEL) == DELETION_PROTECTION_ALWAYS:
        raise ValidationError(
            "this resource is protected, remove the label "
            f"{DELETION_PROTECTION_LABEL} to delete it"
        )


def validate_workload_rebalancer(rebalancer) -> None:
    if not rebalancer.spec.workloads:
        raise ValidationError("workloads must not be empty")


def validate_work(work) -> None:
    ref = getattr(work.spec, "workload_template", None)
    if not work.spec.workload and not (ref is not None and ref.digest):
        # template-delta works carry (digest, patch) instead of a full
        # manifest — either representation satisfies the invariant
        raise ValidationError("work must carry at least one manifest")
    if work.spec.conflict_resolution not in ("Overwrite", "Abort"):
        raise ValidationError(
            f"invalid conflictResolution {work.spec.conflict_resolution!r}"
        )


def mutate_cluster(cluster) -> None:
    """Cluster defaulting (apis/cluster/mutation/mutation.go): when the
    CustomizedClusterResourceModeling gate is on, an empty resourceModels
    gets the nine default cpu/memory grades; declared models standardize
    (grade-sorted, first min 0, last max open)."""
    if not feature_gate.enabled(CUSTOMIZED_CLUSTER_RESOURCE_MODELING):
        return
    if not cluster.spec.resource_models:
        cluster.spec.resource_models = default_resource_models()
    else:
        standardize_resource_models(cluster.spec.resource_models)


def validate_cluster(cluster) -> None:
    """Cluster invariants (apis/cluster/validation/validation.go): DNS-ish
    name <= 48 chars, a supported sync mode, and a contiguous gapless model
    ladder (same resource set per grade, max > min, each min = previous
    max, first mins 0, last maxes MaxInt64). Runs after mutate_cluster, so
    standardized/defaulted models must pass."""
    name = cluster.meta.name
    if not name or len(name) > 48 or not re.fullmatch(
        r"[a-z0-9]([-a-z0-9]*[a-z0-9])?", name
    ):
        raise ValidationError(
            f"invalid cluster name {name!r} (DNS-1123 label, max 48 chars)"
        )
    if cluster.spec.sync_mode not in ("Push", "Pull"):
        raise ValidationError(
            f"invalid syncMode {cluster.spec.sync_mode!r} (Push or Pull)"
        )
    models = cluster.spec.resource_models
    for i, model in enumerate(models):
        if i and model.grade == models[i - 1].grade:
            raise ValidationError("model grades must be distinct")
        if i and len(models[i - 1].ranges) != len(model.ranges):
            raise ValidationError("models must cover the same resource count")
        for j, rng in enumerate(model.ranges):
            if rng.max <= rng.min:
                raise ValidationError("model range max must exceed min")
            if i == 0:
                if rng.min != 0:
                    raise ValidationError("first grade minimums must be 0")
            else:
                prev = models[i - 1].ranges[j]
                if prev.name != rng.name:
                    raise ValidationError(
                        "models must cover the same resources in order"
                    )
                if prev.max != rng.min:
                    raise ValidationError(
                        "model intervals must be contiguous and non-overlapping"
                    )
            if i == len(models) - 1 and rng.max != MAX_INT64:
                raise ValidationError("last grade maximums must be MaxInt64")


def default_admission_chain() -> AdmissionChain:
    """The reference handler set for the ported kinds
    (cmd/webhook/app/webhook.go:161-183)."""
    chain = AdmissionChain()
    chain.register_mutator("Cluster", mutate_cluster)
    chain.register_validator("Cluster", validate_cluster)
    for kind in ("PropagationPolicy", "ClusterPropagationPolicy"):
        chain.register_mutator(kind, mutate_propagation_policy)
        chain.register_validator(kind, validate_propagation_policy)
    chain.register_mutator("OverridePolicy", mutate_override_policy)
    for kind in ("OverridePolicy", "ClusterOverridePolicy"):
        chain.register_validator(kind, validate_override_policy)
    chain.register_validator("FederatedResourceQuota", validate_federated_resource_quota)
    for kind in ("ResourceBinding", "ClusterResourceBinding"):
        chain.register_mutator(kind, mutate_binding_permanent_id)
        chain.register_validator(kind, validate_resource_binding)
    chain.register_mutator("FederatedHPA", mutate_federated_hpa)
    chain.register_validator("FederatedHPA", validate_federated_hpa)
    chain.register_validator("CronFederatedHPA", validate_cron_federated_hpa)
    chain.register_mutator("MultiClusterService", mutate_multicluster_service)
    chain.register_validator("MultiClusterService", validate_multicluster_service)
    chain.register_validator("MultiClusterIngress", validate_multicluster_ingress)
    chain.register_validator("WorkloadRebalancer", validate_workload_rebalancer)
    chain.register_mutator("Work", mutate_work)
    chain.register_validator("Work", validate_work)
    chain.register_delete_validator("*", validate_deletion_protection)
    return chain
