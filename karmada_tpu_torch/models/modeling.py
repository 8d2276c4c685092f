"""Resource-model grade estimation: the plain torch function, its numpy
mirror and the K7 kernel's overlay form (``csrc/model_estimate.cu``).

Counterpart of ``karmada_tpu/models/modeling.py``. Semantics
(general.go:195-249 + modeling.go):
- each cluster declares G model grades; grade g covers nodes whose capacity
  falls in [min, max) per resource; the cluster status reports how many
  allocatable nodes sit in each grade (AllocatableModelings).
- for a request, the minimum compliant grade per resource is the first grade
  whose *min* boundary covers the request; the overall index is the max
  across requested resources; no compliant grade for any resource -> 0
  replicas.
- every node of grade >= index contributes min over requested dims of
  floor(grade_min / request) replicas, floored at 1 (general.go:226-231).
- a requested resource absent from the models entirely makes the model path
  inapplicable (the caller falls back to the summary path;
  general.go:127-135).

The JAX program runs in int64 with wrap-around (``counts x per_node`` and
its sum over grades), then clamps to 2^31-1 and truncates to int32; the
plain version and the kernel reproduce both.

The kernel, ``model_overlay``, writes the model answer over the engine's
general profile table in place, as the JAX engine's ``_profile_table`` does
(karmada_tpu/scheduler/core.py:2263-2293); ``model_overlay_ref`` is its
plain version, over ``estimate_by_models``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import native

MAX_INT32 = 2**31 - 1
#: the per-node sentinel of a request with no requested dim
_SENTINEL = 2**62


@dataclass
class ModelPack:
    """Packed model grades for a fleet. G = max grades across clusters;
    clusters with fewer grades pad with counts 0."""

    min_bounds: np.ndarray  # int64[C, G, R]; -1 where grade/resource undefined
    counts: np.ndarray  # int32[C, G] allocatable nodes per grade
    has_models: np.ndarray  # bool[C]
    covered: np.ndarray  # bool[C, R] resource present in the cluster's models


def pack_models(clusters: Sequence, dims: Sequence[str]) -> ModelPack:
    c, r = len(clusters), len(dims)
    g_max = max(
        (len(cl.spec.resource_models) for cl in clusters), default=0
    )
    g_max = max(g_max, 1)
    min_bounds = np.full((c, g_max, r), -1, np.int64)
    counts = np.zeros((c, g_max), np.int32)
    has_models = np.zeros(c, bool)
    covered = np.zeros((c, r), bool)
    dim_idx = {d: j for j, d in enumerate(dims)}
    for i, cl in enumerate(clusters):
        models = cl.spec.resource_models
        modelings = cl.status.resource_summary.allocatable_modelings
        if not models or not modelings:
            continue
        has_models[i] = True
        count_by_grade = {m.grade: m.count for m in modelings}
        for g, model in enumerate(sorted(models, key=lambda m: m.grade)):
            counts[i, g] = count_by_grade.get(model.grade, 0)
            for rng_ in model.ranges:
                j = dim_idx.get(rng_.name)
                if j is not None:
                    min_bounds[i, g, j] = rng_.min
                    covered[i, j] = True
    return ModelPack(
        min_bounds=min_bounds, counts=counts, has_models=has_models, covered=covered
    )


def estimate_by_models(
    min_bounds: torch.Tensor,  # int64[C, G, R]
    counts: torch.Tensor,  # int32[C, G]
    covered: torch.Tensor,  # bool[C, R]
    requests: torch.Tensor,  # int64[B, R]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (replicas int32[B, C], applicable bool[B, C]); the model
    answer of K7's plain version, ``model_overlay_ref``.

    applicable=False means the model path cannot answer for that
    (binding, cluster) — requested resource not covered — and the caller
    falls back to the summary estimate. The JAX program builds
    [B, C, G, R] arrays; this one walks the grades, [B, C, R] at a time,
    with the same integer results."""
    mb = min_bounds.to(torch.int64)
    req = requests.to(torch.int64)
    c_n, g_n, r_n = mb.shape
    b_n = req.shape[0]
    is_req = (req > 0)[:, None, :]  # [B,1,R]
    req3 = req[:, None, :]
    # first compliant grade per resource (G if none): jnp.argmax of a bool
    first = torch.full((b_n, c_n, r_n), g_n, dtype=torch.int64, device=mb.device)
    for g in range(g_n):
        mg = mb[None, :, g, :]  # [1,C,R]
        compliant = (mg >= req3) & (mg >= 0)
        first = torch.where((first == g_n) & compliant, g, first)
    # overall minimum compliant index = max over requested dims (0 if none)
    idx = torch.where(is_req, first, 0).amax(dim=-1)  # [B,C]
    no_grade = idx >= g_n
    safe_req = req3.clamp_min(1)
    total = torch.zeros((b_n, c_n), dtype=torch.int64, device=mb.device)
    counts64 = counts.to(torch.int64)
    for g in range(g_n):
        per_dim = torch.div(
            mb[None, :, g, :].clamp_min(0), safe_req, rounding_mode="floor"
        )  # [B,C,R], both operands >= 0
        per_node = torch.where(is_req, per_dim, _SENTINEL).amin(dim=-1)  # [B,C]
        # degenerate all-zero request -> one pod per node
        per_node = torch.where(per_node >= _SENTINEL, 0, per_node).clamp_min(1)
        # int64 products and sums wrap, as in the JAX program
        total = total + torch.where(idx <= g, counts64[None, :, g] * per_node, 0)
    total = torch.where(no_grade, 0, total)
    total = total.clamp_max(MAX_INT32).to(torch.int32)
    applicable = torch.where(is_req, covered[None, :, :], True).all(dim=-1)
    return total, applicable


def estimate_by_models_np(
    min_bounds: "np.ndarray",  # int64[C, G, R]
    counts: "np.ndarray",  # int32[C, G]
    covered: "np.ndarray",  # bool[C, R]
    requests: "np.ndarray",  # int64[B, R]
) -> tuple:
    """numpy mirror of ``estimate_by_models`` — bit-identical (all exact
    int64 arithmetic, same argmax/first-compliant-grade semantics). The
    tiny-batch host fast path consumes it
    (``scheduler.core.host_profile_table``)."""
    c_n, g_n, r_n = min_bounds.shape
    req = requests[:, None, None, :]  # [B,1,1,R]
    is_req = req > 0
    mb = min_bounds[None, :, :, :]  # [1,C,G,R]
    compliant = (mb >= req) & (mb >= 0)  # [B,C,G,R]
    first = np.where(
        compliant.any(axis=2), np.argmax(compliant, axis=2), g_n
    )  # [B,C,R]
    idx = np.max(np.where(is_req[:, :, 0, :], first, 0), axis=-1)  # [B,C]
    no_grade = idx >= g_n
    safe_req = np.maximum(req, 1)
    per_dim = np.where(mb >= 0, mb, 0) // safe_req
    per_node = np.min(
        np.where(is_req, per_dim, np.int64(2**62)), axis=-1
    )  # [B,C,G]
    per_node = np.where(per_node >= 2**62, 0, per_node)
    per_node = np.maximum(per_node, 1)
    grade_ids = np.arange(g_n)[None, None, :]
    usable = grade_ids >= idx[:, :, None]
    total = np.sum(
        np.where(usable, counts[None, :, :].astype(np.int64) * per_node, 0),
        axis=-1,
    )
    total = np.where(no_grade, 0, total)
    total = np.minimum(total, np.int64(2**31 - 1)).astype(np.int32)
    applicable = np.all(
        np.where(is_req[:, :, 0, :], covered[None, :, :], True), axis=-1
    )
    return total, applicable


def _check_pack(name, min_bounds, counts, covered, requests) -> tuple[int, int, int, int]:
    native.check(
        name, min_bounds=(min_bounds, torch.int64), counts=(counts, torch.int32),
        covered=(covered, torch.bool), requests=(requests, torch.int64))
    c, g, r = min_bounds.shape
    u = requests.shape[0]
    if counts.shape != (c, g) or covered.shape != (c, r) or requests.shape[1] != r:
        raise ValueError(f"{name}: inconsistent shapes")
    if u > _MAX_ROWS:
        raise ValueError(f"{name}: {u} profiles not supported")
    return c, g, r, u


_MAX_ROWS = 65535  # grid.y limit: one block row per profile


def model_overlay_ref(
    table: torch.Tensor,  # int32[U, C] general estimate, -1 without summary
    min_bounds: torch.Tensor,  # int64[C, G, R]
    counts: torch.Tensor,  # int32[C, G]
    covered: torch.Tensor,  # bool[C, R]
    requests: torch.Tensor,  # int64[U, R]
    has_models: torch.Tensor,  # bool[C]
    has_summary: torch.Tensor,  # bool[C]
    available_cap: torch.Tensor,  # int64[C, R]
    pods_dim: int,  # the pods column, -1 when the dims have none
) -> torch.Tensor:
    """Plain version of K7's overlay form; writes ``table`` in place and
    returns it: ``has_summary ? (has_models & applicable ? min(model,
    allowed_pods) : table) : -1``. The requests' pods column counts as 0 —
    models never declare the implicit pods dimension, so it must not
    defeat applicability — and allowed pods cap the model answer instead
    (karmada_tpu/scheduler/core.py:2269-2293)."""
    req = requests
    if pods_dim >= 0:
        req = requests.clone()
        req[:, pods_dim] = 0
    model, applicable = estimate_by_models(min_bounds, counts, covered, req)
    if pods_dim >= 0:
        allowed = available_cap[:, pods_dim].clamp(0, MAX_INT32).to(torch.int32)
        model = torch.minimum(model, allowed[None, :])
    use_model = has_models[None, :] & applicable
    out = torch.where(
        has_summary[None, :], torch.where(use_model, model, table), -1
    )
    table.copy_(out)
    return table


def model_overlay(
    table: torch.Tensor,
    min_bounds: torch.Tensor,
    counts: torch.Tensor,
    covered: torch.Tensor,
    requests: torch.Tensor,
    has_models: torch.Tensor,
    has_summary: torch.Tensor,
    available_cap: torch.Tensor,
    pods_dim: int,
) -> torch.Tensor:
    """K7: ``model_overlay_ref`` as one kernel launch, in place on
    ``table``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``model_overlay.launches`` counts kernel launches."""
    args = (table, min_bounds, counts, covered, requests, has_models,
            has_summary, available_cap)
    if native.on_cpu(args):
        return model_overlay_ref(*args, pods_dim)
    c, g, r, u = _check_pack("model_overlay", min_bounds, counts, covered, requests)
    native.check(
        "model_overlay", table=(table, torch.int32),
        has_models=(has_models, torch.bool), has_summary=(has_summary, torch.bool),
        available_cap=(available_cap, torch.int64))
    if (table.shape != (u, c) or has_models.shape != (c,)
            or has_summary.shape != (c,) or available_cap.shape != (c, r)
            or not -1 <= pods_dim < r):
        raise ValueError("model_overlay: inconsistent shapes")
    if u and c:
        native.launch(model_overlay, "model_estimate", "model_overlay_launch",
                      table.device, min_bounds, counts, covered, c, g, r,
                      requests, u, has_models, has_summary, available_cap,
                      pods_dim, table)
    return table


model_overlay.launches = 0
