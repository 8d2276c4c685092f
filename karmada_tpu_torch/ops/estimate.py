"""Capacity estimation: MaxAvailableReplicas as batched integer math.

General estimator (ref: pkg/estimator/client/general.go:96-196): per cluster,
available = allocatable - allocated - allocating; max replicas = min over
requested resource dims of floor(available / request). Each replica occupies
one pod, so the pods dimension carries an implicit request of 1, which
reproduces getAllowedPodNumber (general.go:96-114) as just another dimension.

Counterpart of ``karmada_tpu/ops/estimate.py``. The plain torch functions
(``general_estimate``, ``general_estimate_interned``, ``merge_estimates``)
keep the JAX signatures; ``estimate_merge`` is the engine's fused form of the
three, launched as the hand-written kernel K1 (``csrc/estimate_merge.cu``) on
CUDA tensors and computed by ``estimate_merge_ref`` on CPU tensors. K1 has
two more forms: ``profile_table`` (the estimate per request profile) and
``estimate_merge_table`` (the row gather of a profile table merged with
extra estimates).
"""

from __future__ import annotations

import ctypes

import torch

from .. import native

MAX_INT32 = 2**31 - 1
UNAUTHENTIC = -1  # estimator "no answer" (client/interface.go:30)


def general_estimate(
    available_cap: torch.Tensor,  # int64[C, R]: allocatable-allocated-allocating
    requests: torch.Tensor,  # int64[B, R]: per-replica requests (0 = not requested)
) -> torch.Tensor:
    """int32[B, C] max available replicas (>= 0); MAX_INT32 when the binding
    requests nothing at all (best-effort) — callers clamp the sentinel."""
    cap = available_cap.to(torch.int64).clamp_min(0)  # negative -> 0 replicas
    requests = requests.to(torch.int64)
    best = torch.full(
        (requests.shape[0], cap.shape[0]), MAX_INT32,
        dtype=torch.int64, device=cap.device,
    )
    for r in range(requests.shape[1]):
        req_r = requests[:, r : r + 1]  # [B, 1]
        # both operands are non-negative here, so floor == truncation
        ratio = torch.div(cap[None, :, r], req_r.clamp_min(1), rounding_mode="floor")
        best = torch.where(req_r > 0, torch.minimum(best, ratio), best)
    return best.clamp_max(MAX_INT32).to(torch.int32)


def _clip_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row indices as a jnp gather reads them: negative ones count from the
    end, the rest clamp into [0, n). Torch indexing would raise instead."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def general_estimate_interned(
    available_cap: torch.Tensor,  # int64[C, R]
    profiles: torch.Tensor,  # int64[U, R]: unique request rows
    prof_idx: torch.Tensor,  # int32[B]: row i uses profiles[prof_idx[i]]
) -> torch.Tensor:
    """int32[B, C] — ``general_estimate`` per unique request profile, then a
    row gather. The JAX package gathers by a one-hot f32 matmul
    (``gather_profile_rows``), exact only without TF32; the port indexes."""
    per_profile = general_estimate(available_cap, profiles)  # [U, C]
    return per_profile[_clip_rows(prof_idx, per_profile.shape[0])]


def merge_estimates(
    replicas: torch.Tensor,  # int32[B]
    estimates: tuple[torch.Tensor, ...],  # each int32[B, C]; -1 = no answer
) -> torch.Tensor:
    """core/util.go:54-104: min across estimators ignoring UNAUTHENTIC,
    then clamp an untouched MAX_INT32 sentinel to spec.Replicas, and
    short-circuit zero-replica (non-workload) bindings to the sentinel path."""
    reps = replicas.to(torch.int32)[:, None]
    out = torch.full_like(estimates[0], MAX_INT32, dtype=torch.int32)
    for est in estimates:
        out = torch.where(est == UNAUTHENTIC, out, torch.minimum(out, est))
    out = torch.where(reps == 0, MAX_INT32, out)
    return torch.where(out == MAX_INT32, reps, out)


def estimate_merge_ref(
    available_cap: torch.Tensor,  # int64[C, R]
    profiles: torch.Tensor,  # int64[U, R]
    prof_idx: torch.Tensor,  # int32[B]
    has_summary: torch.Tensor,  # bool[C]
    replicas: torch.Tensor,  # int32[B]
) -> torch.Tensor:
    """Plain torch version of K1: int32[B, C] merged availability of the
    general estimator alone, no-summary clusters giving no answer."""
    table = general_estimate(available_cap, profiles)
    table = torch.where(has_summary[None, :], table, UNAUTHENTIC)
    return merge_estimates(replicas, (table[_clip_rows(prof_idx, table.shape[0])],))


def estimate_merge(
    available_cap: torch.Tensor,
    profiles: torch.Tensor,
    prof_idx: torch.Tensor,
    has_summary: torch.Tensor,
    replicas: torch.Tensor,
) -> torch.Tensor:
    """K1: ``estimate_merge_ref`` as one kernel launch on CUDA tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``estimate_merge.launches`` counts kernel launches."""
    args = (available_cap, profiles, prof_idx, has_summary, replicas)
    if native.on_cpu(args):
        return estimate_merge_ref(*args)
    native.check(
        "estimate_merge", available_cap=(available_cap, torch.int64),
        profiles=(profiles, torch.int64), prof_idx=(prof_idx, torch.int32),
        has_summary=(has_summary, torch.bool), replicas=(replicas, torch.int32))
    dev = available_cap.device
    c, r = available_cap.shape
    u = profiles.shape[0]
    b = prof_idx.shape[0]
    if profiles.shape[1] != r or has_summary.shape != (c,) or replicas.shape != (b,):
        raise ValueError("estimate_merge: inconsistent shapes")
    if b and not u:
        raise ValueError(f"estimate_merge: {b} rows over no profiles")
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b and c:
        native.launch(estimate_merge, "estimate_merge", "estimate_merge_launch",
                      dev, available_cap, c, r, profiles, u, prof_idx,
                      has_summary, replicas, b, out)
    return out


estimate_merge.launches = 0


def profile_table_ref(
    available_cap: torch.Tensor,  # int64[C, R]
    profiles: torch.Tensor,  # int64[U, R]
    has_summary: torch.Tensor,  # bool[C]
) -> torch.Tensor:
    """Plain torch version of K1's table form: int32[U, C] general estimate
    per request profile, -1 (no answer) where the cluster has no summary —
    the general branch of the JAX engine's ``_profile_table``
    (karmada_tpu/scheduler/core.py:2256)."""
    table = general_estimate(available_cap, profiles)
    return torch.where(has_summary[None, :], table, UNAUTHENTIC).to(torch.int32)


def profile_table(
    available_cap: torch.Tensor,
    profiles: torch.Tensor,
    has_summary: torch.Tensor,
) -> torch.Tensor:
    """K1 table form: ``profile_table_ref`` as one launch of K1's
    row-streaming kernel in its table form (row u is profile u; no gather,
    no merge).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``profile_table.launches`` counts kernel launches."""
    args = (available_cap, profiles, has_summary)
    if native.on_cpu(args):
        return profile_table_ref(*args)
    native.check(
        "profile_table", available_cap=(available_cap, torch.int64),
        profiles=(profiles, torch.int64), has_summary=(has_summary, torch.bool))
    dev = available_cap.device
    c, r = available_cap.shape
    u = profiles.shape[0]
    if profiles.shape[1] != r or has_summary.shape != (c,):
        raise ValueError("profile_table: inconsistent shapes")
    out = torch.empty((u, c), dtype=torch.int32, device=dev)
    if u and c:
        native.launch(profile_table, "estimate_merge", "profile_table_launch",
                      dev, available_cap, c, r, profiles, u, has_summary, out)
    return out


profile_table.launches = 0


#: extra estimates one launch of K1's merge form takes (MAX_EXTRAS in
#: ``csrc/estimate_merge.cu``: the pointers of a group travel by value in
#: the kernel's parameters); more take one launch per group
MERGE_GROUP = 32


def estimate_merge_table_ref(
    table: torch.Tensor,  # int32[U, C]: per-profile answers, -1 = no answer
    prof_inv: torch.Tensor,  # int32[B]: row b uses table[prof_inv[b]]
    extras: tuple[torch.Tensor, ...],  # each int32[B, C]; -1 = no answer
    replicas: torch.Tensor,  # int32[B]
) -> torch.Tensor:
    """Plain version of K1's merge form: ``merge_estimates`` over the
    gathered profile table and the extra estimates — the JAX engine's
    ``_availability`` with models or extra estimators
    (karmada_tpu/scheduler/core.py:2376-2385)."""
    gathered = table[_clip_rows(prof_inv, table.shape[0])]
    return merge_estimates(replicas, (gathered, *extras))


def estimate_merge_table(
    table: torch.Tensor,
    prof_inv: torch.Tensor,
    extras: tuple[torch.Tensor, ...],
    replicas: torch.Tensor,
) -> torch.Tensor:
    """K1 merge form: ``estimate_merge_table_ref`` on CUDA tensors, for any
    number of extra estimates. The entry point launches the kernel once per
    group of ``MERGE_GROUP`` extras (once up to ``MERGE_GROUP``), each group
    after the first continuing the running minimum of the one before it
    through a scratch buffer.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``estimate_merge_table.launches`` counts calls of the entry
    point."""
    extras = tuple(extras)
    if native.on_cpu((table, prof_inv, *extras, replicas)):
        return estimate_merge_table_ref(table, prof_inv, extras, replicas)
    native.check(
        "estimate_merge_table", table=(table, torch.int32),
        prof_inv=(prof_inv, torch.int32), replicas=(replicas, torch.int32),
        **{f"extras[{e}]": (x, torch.int32) for e, x in enumerate(extras)})
    u, c = table.shape
    b = prof_inv.shape[0]
    if replicas.shape != (b,) or any(x.shape != (b, c) for x in extras):
        raise ValueError("estimate_merge_table: inconsistent shapes")
    if b and not u:
        raise ValueError(f"estimate_merge_table: {b} rows over no profiles")
    out = torch.empty((b, c), dtype=torch.int32, device=table.device)
    if b and c:
        scratch = torch.empty_like(out) if len(extras) > MERGE_GROUP else None
        ptrs = (ctypes.c_void_p * max(len(extras), 1))(*(x.data_ptr() for x in extras))
        native.launch(estimate_merge_table, "estimate_merge",
                      "estimate_merge_table_launch", table.device, table, u, c,
                      prof_inv, ptrs, len(extras), replicas, b, scratch, out)
    return out


estimate_merge_table.launches = 0
