"""The port's API versioning (``api/versioning.py``) against the JAX
package on the CPU.

- the cases of ``tests/test_api_versioning.py`` run on the port
  (``port_cases``): the pure conversions, the bus's upgrade of a legacy
  payload and the ConversionReview through the port's TLS webhook process.
  ``TestCliManifest.test_apply_of_legacy_manifest_lands_hub_typed`` is
  left out: it reaches ``karmada_tpu.cli._manifest_to_obj``, and the CLI
  is not ported yet (ROADMAP A7c);
- seeded legacy and hub ``ResourceBinding`` / ``ClusterResourceBinding``
  documents converted up, down and round trip by both packages: equal
  documents; ``served_versions``, ``maybe_upgrade`` and
  ``handle_conversion_review`` (a review of many objects, one with an
  unserved version, one malformed) equal;
- the bus codec over a legacy payload: ``decode_object`` upgrades it in
  both packages, and ``encode_object`` of the results gives the same bytes.

Tolerance: exact equality."""

import copy
import json

import numpy as np
import pytest

import karmada_tpu.api.versioning as JV
import karmada_tpu.bus.service as JS
import karmada_tpu_torch.api.versioning as TV
import karmada_tpu_torch.bus.service as TS
from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)

globals().update(port_cases("test_api_versioning", leave_out=(
    "TestCliManifest.test_apply_of_legacy_manifest_lands_hub_typed",)))

KINDS = ("ResourceBinding", "ClusterResourceBinding")


def seeded_doc(rng, kind: str, i: int, legacy: bool) -> dict:
    """A wire document of ``kind`` in the legacy (v1alpha1) or the hub
    schema, its fields drawn from ``rng`` (some optional ones left out)."""
    n = int(rng.integers(0, 4))
    clusters = [{"name": f"member{j}", "replicas": int(rng.integers(0, 9))} for j in range(n)]
    reps = int(rng.integers(0, 20))
    req = {"cpu": int(rng.integers(1, 4000)), "memory": int(rng.integers(1, 1 << 20))}
    resource = {"api_version": "apps/v1", "kind": "Deployment", "name": f"app{i}"}
    if kind == "ResourceBinding":
        resource["namespace"] = "default"
    spec: dict = {"resource": resource}
    if n:
        spec["clusters"] = clusters
    if legacy:
        resource["replicas"] = reps
        if rng.random() < 0.7:
            key = "replicaResourceRequirements" if rng.random() < 0.5 \
                else "replica_resource_requirements"
            resource[key] = req
    else:
        spec["replicas"] = reps
        if rng.random() < 0.7:
            spec["replica_requirements"] = {"resource_request": req,
                                            "priority_class_name": f"pc{i}"}
        if rng.random() < 0.5:
            spec["graceful_eviction_tasks"] = [{"from_cluster": "member0"}]
    doc = {"kind": kind, "meta": {"name": f"app{i}-deployment"}, "spec": spec}
    if kind == "ResourceBinding":
        doc["meta"]["namespace"] = "default"
    if rng.random() < 0.8:
        doc["apiVersion"] = TV.LEGACY_VERSION if legacy else TV.HUB_VERSION
    if rng.random() < 0.7:
        doc["status"] = {
            "conditions": [{"type": "Scheduled", "status": bool(rng.random() < 0.5),
                            "last_transition_time": float(rng.integers(1, 1 << 30))}],
            "aggregated_status": [
                {"cluster_name": c["name"], "applied": bool(rng.random() < 0.5),
                 "applied_message": "ok", "health": "Healthy", "status": {"ready": 1}}
                for c in clusters],
        }
    return doc


def both(fn_name: str, *args):
    """``fn_name`` of each package on its own deep copy of ``args``: (JAX,
    port), each a result or the raised exception's type name and text."""
    out = []
    for mod in (JV, TV):
        try:
            out.append(getattr(mod, fn_name)(*copy.deepcopy(args)))
        except Exception as exc:  # noqa: BLE001 — compared across packages
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conversions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for i in range(40):
        kind = KINDS[i % 2]
        for legacy in (True, False):
            doc = seeded_doc(rng, kind, i, legacy)
            for to in (TV.HUB_VERSION, TV.LEGACY_VERSION, "work.karmada.io/v9"):
                j, t = both("convert", doc, kind, to)
                assert j == t, (kind, legacy, to)
            j, t = both("maybe_upgrade", doc, kind)
            assert j == t
            down = JV.convert(copy.deepcopy(doc), kind, JV.LEGACY_VERSION)
            j, t = both("convert", down, kind, TV.HUB_VERSION)
            assert j == t


def test_served_versions_equal_jax():
    for kind in KINDS + ("Deployment", "Work"):
        assert TV.served_versions(kind) == JV.served_versions(kind)
        assert TV.hub_version_of(kind) == JV.hub_version_of(kind)


@pytest.mark.parametrize("desired", ["work.karmada.io/v1alpha2", "work.karmada.io/v1alpha1",
                                     "work.karmada.io/v9"])
def test_conversion_review_equal_jax(desired):
    rng = np.random.default_rng(7)
    objects = [seeded_doc(rng, KINDS[i % 2], i, legacy=i % 3 != 0) for i in range(12)]
    reviews = [
        {"request": {"uid": "u1", "desiredAPIVersion": desired, "objects": objects}},
        {"request": {"uid": "u2", "desiredAPIVersion": desired,
                     "objects": objects[:3] + [dict(objects[3], apiVersion="x/v0")]}},
        {"request": {"uid": "u3", "desiredAPIVersion": desired, "objects": [{"kind": 3}]}},
        {"request": {"uid": "u4", "desiredAPIVersion": desired, "objects": [None]}},
        {},
    ]
    for review in reviews:
        j, t = both("handle_conversion_review", review)
        assert j == t


@pytest.mark.parametrize("seed", [3, 4])
def test_bus_codec_upgrades_legacy_payloads_like_jax(seed):
    rng = np.random.default_rng(seed)
    for i in range(30):
        kind = KINDS[i % 2]
        doc = seeded_doc(rng, kind, i, legacy=True)
        doc["apiVersion"] = TV.LEGACY_VERSION
        payload = json.dumps(doc)
        jax_obj, port_obj = JS.decode_object(kind, payload), TS.decode_object(kind, payload)
        assert TS.encode_object(port_obj) == JS.encode_object(jax_obj)
