"""Multi-version API surface + conversion seam: the port's own copy of
``karmada_tpu/api/versioning.py``.

Ref: pkg/apis/work/v1alpha1 + v1alpha2 — the reference serves BOTH
binding versions simultaneously: v1alpha1 nests the replica count and
per-replica resource requirements INSIDE ``spec.resource`` while the hub
(v1alpha2) hoists them to ``spec.replicas`` /
``spec.replicaRequirements.resourceRequest``
(binding_types_conversion.go:77-129), and a CRD conversion webhook
(/convert, ConversionReview contract) translates on demand. That version
-skew story is what makes operator upgrades real: an old client or a
stored legacy object keeps working against a new control plane.

Design here (hub-and-spoke over WIRE DICTS): the current dataclasses are
the hub; each legacy version registers ``(to_hub, from_hub)`` functions
over the codec's jsonable form. Three consumers share this registry —
the bus (legacy-shaped applies upgrade before decode), the webhook
server's ``/convert`` endpoint (ConversionReview in/out), and the CLI's
``apply`` (a v1alpha1 manifest lands as a hub object). Down-conversion
is lossy exactly where the reference's is (hub-only fields drop), and
up-conversion fills hub defaults.
"""

from __future__ import annotations

from typing import Callable, Optional

GROUP = "work.karmada.io"
HUB_VERSION = f"{GROUP}/v1alpha2"
LEGACY_VERSION = f"{GROUP}/v1alpha1"


class ConversionError(Exception):
    """Unknown (kind, version) pair or malformed payload."""


# (kind, version) -> (to_hub, from_hub); the hub itself is implicit
_REGISTRY: dict[tuple[str, str], tuple[Callable, Callable]] = {}
# kind -> hub apiVersion string
_HUBS: dict[str, str] = {}


def register(
    kind: str, version: str, to_hub: Callable[[dict], dict],
    from_hub: Callable[[dict], dict], hub_version: str = HUB_VERSION,
) -> None:
    _REGISTRY[(kind, version)] = (to_hub, from_hub)
    _HUBS[kind] = hub_version


def served_versions(kind: str) -> list[str]:
    """Versions this plane serves for ``kind`` (hub first)."""
    out = [_HUBS[kind]] if kind in _HUBS else []
    out += [v for (k, v) in _REGISTRY if k == kind]
    return out


def hub_version_of(kind: str) -> Optional[str]:
    return _HUBS.get(kind)


def convert(doc: dict, kind: str, to_version: str) -> dict:
    """Convert a wire doc of ``kind`` to ``to_version``. The doc's own
    version comes from its apiVersion field (hub assumed when absent).
    Hub-and-spoke: legacy -> hub -> legacy'."""
    from_version = doc.get("apiVersion") or doc.get("api_version") or (
        _HUBS.get(kind, to_version)
    )
    if from_version == to_version:
        return doc
    hub_doc = doc
    if from_version != _HUBS.get(kind):
        pair = _REGISTRY.get((kind, from_version))
        if pair is None:
            raise ConversionError(
                f"{kind} version {from_version!r} is not served"
            )
        hub_doc = pair[0](doc)
        hub_doc["apiVersion"] = _HUBS.get(kind, to_version)
    if to_version == _HUBS.get(kind):
        return hub_doc
    pair = _REGISTRY.get((kind, to_version))
    if pair is None:
        raise ConversionError(f"{kind} version {to_version!r} is not served")
    out = pair[1](hub_doc)
    out["apiVersion"] = to_version
    return out


def maybe_upgrade(kind: str, doc: dict) -> dict:
    """Upgrade a wire doc to the hub version when its apiVersion marks a
    registered legacy version; pass through otherwise. The bus and CLI
    call this before decoding, so legacy clients keep working against a
    hub store."""
    ver = doc.get("apiVersion") or doc.get("api_version")
    if ver and (kind, ver) in _REGISTRY:
        return convert(doc, kind, _HUBS[kind])
    return doc


# --------------------------------------------------------------------------
# work/v1alpha1 bindings (the reference's live multi-version pair)
# --------------------------------------------------------------------------


def _get(d: dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


def _binding_to_hub(doc: dict) -> dict:
    """v1alpha1 -> hub: hoist spec.resource.{replicas,
    replicaResourceRequirements} to spec.{replicas, replica_requirements}
    (ConvertBindingSpecToHub, binding_types_conversion.go:77-95)."""
    out = dict(doc)
    spec = dict(_get(doc, "spec", default={}) or {})
    res = dict(_get(spec, "resource", default={}) or {})
    reps = res.pop("replicas", 0)
    rrr = res.pop(
        "replicaResourceRequirements", None
    ) or res.pop("replica_resource_requirements", None)
    spec["resource"] = res
    spec["replicas"] = reps
    if rrr:
        rr = dict(_get(spec, "replica_requirements", default={}) or {})
        rr["resource_request"] = rrr
        spec["replica_requirements"] = rr
    out["spec"] = spec
    # status: conditions + aggregated items carry over field-for-field
    # (the hub's extra aggregated fields default)
    return out


def _binding_from_hub(doc: dict) -> dict:
    """hub -> v1alpha1: push spec.replicas / replica_requirements
    .resource_request back under spec.resource; hub-only spec fields the
    legacy schema cannot express are DROPPED (lossy, like the
    reference's ConvertBindingSpecFromHub which simply does not map
    them)."""
    out = dict(doc)
    spec = dict(_get(doc, "spec", default={}) or {})
    res = dict(_get(spec, "resource", default={}) or {})
    res["replicas"] = spec.pop("replicas", 0)
    rr = spec.pop("replica_requirements", None)
    if rr and _get(rr, "resource_request"):
        res["replicaResourceRequirements"] = _get(rr, "resource_request")
    # legacy schema: resource + clusters (+ the shared eviction-free core)
    legacy_spec = {"resource": res}
    if "clusters" in spec:
        legacy_spec["clusters"] = spec["clusters"]
    out["spec"] = legacy_spec
    status = dict(_get(doc, "status", default={}) or {})
    if status:
        legacy_status = {}
        if "conditions" in status:
            legacy_status["conditions"] = status["conditions"]
        if "aggregated_status" in status:
            legacy_status["aggregated_status"] = [
                {
                    k: v
                    for k, v in dict(item).items()
                    if k in (
                        "cluster_name", "status", "applied",
                        "applied_message",
                    )
                }
                for item in status["aggregated_status"]
            ]
        out["status"] = legacy_status
    return out


for _kind in ("ResourceBinding", "ClusterResourceBinding"):
    register(_kind, LEGACY_VERSION, _binding_to_hub, _binding_from_hub)


# --------------------------------------------------------------------------
# ConversionReview (the CRD conversion-webhook wire contract)
# --------------------------------------------------------------------------


def handle_conversion_review(review: dict) -> dict:
    """Serve a ConversionReview request dict -> response dict (the
    /convert contract a CRD with strategy: Webhook uses; the webhook
    server mounts this). Objects that fail to convert fail the whole
    review, matching the apiserver's all-or-nothing semantics."""
    req = review.get("request") or {}
    uid = req.get("uid", "")
    desired = req.get("desiredAPIVersion", "")
    converted = []
    try:
        for obj in req.get("objects") or []:
            kind = obj.get("kind", "")
            converted.append(convert(obj, kind, desired))
    # a malformed object must still produce an HTTP-200 ConversionReview
    # with result.status=Failure — the apiserver treats anything else as
    # an unrecognized response, not a reported conversion failure
    except Exception as exc:  # noqa: BLE001 — wire surface
        return {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "response": {
                "uid": uid,
                "result": {"status": "Failure", "message": str(exc)},
            },
        }
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "ConversionReview",
        "response": {
            "uid": uid,
            "convertedObjects": converted,
            "result": {"status": "Success"},
        },
    }
