"""Quota enforcement as tensor constraints: FederatedResourceQuota admission
and static-assignment caps.

Counterpart of ``karmada_tpu/ops/quota.py`` (ref:
federatedresourcequota_types.go and the scheduling-side enforcement behind
FederatedQuotaEnforcement). Two functions, each a plain torch version, a
kernel and a wrapper that takes the plain version on CPU tensors and
launches the kernel on CUDA tensors:

- ``quota_admit`` (K12, ``csrc/quota_admit.cu``): FIFO admission of one
  wave per namespace. A binding is admitted iff the inclusive running demand
  of its namespace's bindings, in arrival order, fits the namespace's
  remaining quota on every dim; a denied binding's demand still holds its
  place in line. Returns the admitted flags and the admitted demand per
  namespace.
- ``quota_cluster_caps`` (K13, ``csrc/quota_caps.cu``): per (binding,
  cluster) the ceiling ``min over requested dims of floor(cap / request)``
  that a namespace's static assignments put on the cluster, estimator-shaped
  (int32[B, C], MAX_INT32 = no constraint). ``quota_caps_fold`` is K13's
  fold form: the same ceiling folded in place into the fleet's profile
  table, the rule of the JAX engine's ``_profile_table_quota``.

``cluster_caps_np`` is the numpy mirror the tiny-batch host path uses.
Every integer is int64 except the int32 answers; demand rows are clamped to
``DEMAND_CLAMP`` by the packing layer so a whole wave's sums stay in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

#: per-dimension "no limit" sentinel in the remaining/caps tensors, with
#: headroom below int64 overflow for a wave's running sums
UNLIMITED = 2**62

#: per-binding per-dimension demand clamp: with at most MAX_ADMIT_ROWS rows a
#: segment sum stays below 2^44 * 2^17 = 2^61 < UNLIMITED < 2^63
DEMAND_CLAMP = 2**44
MAX_ADMIT_ROWS = 1 << 17

MAX_INT32 = 2**31 - 1


def _check_admit(ns_ids, demand, remaining) -> tuple[int, int, int]:
    b = ns_ids.shape[0]
    if b > MAX_ADMIT_ROWS:
        # the DEMAND_CLAMP headroom holds only up to this many rows (the JAX
        # program asserts it at trace time)
        raise ValueError(f"quota_admit: {b} rows, at most {MAX_ADMIT_ROWS}")
    n, r = remaining.shape
    if ns_ids.dim() != 1 or demand.shape != (b, r):
        raise ValueError("quota_admit: inconsistent shapes")
    return b, n, r


def quota_admit_ref(
    ns_ids: torch.Tensor,  # int32[B]: namespace id, -1 = not quota'd
    demand: torch.Tensor,  # int64[B, R]: delta demand (>= 0, clamped)
    remaining: torch.Tensor,  # int64[N, R]: limit - used (UNLIMITED = no cap)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12: ``(admitted bool[B], wave_used int64[N, R])``,
    the JAX program step by step — a stable sort by ``ns * B + row``, one
    cumsum, the segment bases by a running max, the all-dims compare and the
    per-namespace scatter-add. Negative ids sort into a pad segment compared
    with UNLIMITED; ids at or above N read the UNLIMITED pad row (a jnp
    gather clamps) and their adds are dropped."""
    b, n, r = _check_admit(ns_ids, demand, remaining)
    dev = demand.device
    ns64 = ns_ids.to(torch.int64)
    ns_safe = torch.where(ns64 < 0, n, ns64)
    key = ns_safe * b + torch.arange(b, dtype=torch.int64, device=dev)
    order = torch.argsort(key, stable=True)
    ns_s = ns_safe[order]
    d_s = demand.to(torch.int64)[order]
    cum = torch.cumsum(d_s, dim=0)
    cum_excl = cum - d_s
    first = torch.ones(b, dtype=torch.bool, device=dev)
    if b > 1:
        first[1:] = ns_s[1:] != ns_s[:-1]
    seg_base = torch.where(first[:, None], cum_excl, -1)
    base = torch.cummax(seg_base, dim=0).values if b else seg_base
    seg_cum = cum - base
    rem_pad = torch.cat([
        remaining.to(torch.int64),
        torch.full((1, r), UNLIMITED, dtype=torch.int64, device=dev),
    ])
    ok = (seg_cum <= rem_pad[ns_s.clamp(0, n)]).all(dim=1)
    admitted = torch.zeros(b, dtype=torch.bool, device=dev)
    admitted[order] = ok
    keep = ns_s < n  # the pad segment and ids >= N add nothing
    wave_used = torch.zeros((n, r), dtype=torch.int64, device=dev)
    wave_used.index_add_(0, ns_s[keep], torch.where(ok[:, None], d_s, 0)[keep])
    return admitted, wave_used


#: positions a block of K12's and K15's sorts, and of their scans, owns
#: (``csrc/radix_sort.cuh`` TILE and SCAN_TILE), and the bins of one 8-bit
#: digit
_TILE = 2048
_SCAN_TILE = 1024
_BINS = 256


def quota_admit(
    ns_ids: torch.Tensor,
    demand: torch.Tensor,
    remaining: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K12: ``quota_admit_ref`` behind one C entry point, at any number of
    namespaces and dims: a stable radix partition of the rows by namespace,
    a segmented scan of the demand over it, the compare and the
    per-namespace reduction (see ``csrc/quota_admit.cu``). Demand must keep
    the packing contract (0 <= demand <= DEMAND_CLAMP); under it every row
    whose id lies outside [0, N) is admitted, as in the plain version.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``quota_admit.launches`` counts kernel launches (one per
    call)."""
    args = (ns_ids, demand, remaining)
    if native.on_cpu(args):
        return quota_admit_ref(*args)
    native.check("quota_admit", ns_ids=(ns_ids, torch.int32),
                 demand=(demand, torch.int64), remaining=(remaining, torch.int64))
    b, n, r = _check_admit(*args)
    dev = demand.device
    admitted = torch.empty(b, dtype=torch.bool, device=dev)
    wave_used = torch.empty((n, r), dtype=torch.int64, device=dev)
    native.launch(quota_admit, "quota_admit", "quota_admit_launch", dev,
                  *args, b, n, r, admitted, wave_used, *admit_scratch(b, n, r, dev))
    return admitted, wave_used


def admit_scratch(b: int, n: int, r: int, dev) -> tuple:
    """K12's scratch after its outputs, as ``quota_admit_launch`` takes it:
    the sort's keys (uint32 in the kernel) and rows, both buffers; its
    digit counts; each tile's first and last segment and last segment's
    demand; and the number of 8-bit digits of the segment ids (0..N)."""
    tiles, scan_tiles = -(-b // _TILE), -(-b // _SCAN_TILE)
    ndig = max(1, -(-n.bit_length() // 8))
    return (torch.empty((2, b), dtype=torch.int32, device=dev),
            torch.empty((2, b), dtype=torch.int32, device=dev),
            torch.empty(ndig * _BINS * (1 + tiles), dtype=torch.int32, device=dev),
            torch.empty((scan_tiles, 2), dtype=torch.int32, device=dev),
            torch.empty((scan_tiles, r), dtype=torch.int64, device=dev),
            ndig)


quota_admit.launches = 0


def _cluster_caps_body(xp, caps, ns_rows, requests, floor_div):
    """The cap estimate over one array module (numpy or torch): caps
    int64[N, C, R] with UNLIMITED where uncapped; rows with ``ns_rows < 0``
    answer MAX_INT32 everywhere. ``ns_rows`` at or above N read row N - 1,
    as a jnp gather clamps."""
    n = caps.shape[0]
    rows = xp.where(ns_rows < 0, 0, ns_rows)
    rows = xp.where(rows >= n, n - 1, rows)
    cap_b = caps[rows]  # [B, C, R]
    b_n, c_n = requests.shape[0], caps.shape[1]
    where = {"device": caps.device} if xp is torch else {}
    best = xp.full((b_n, c_n), UNLIMITED, dtype=xp.int64, **where)
    for r in range(requests.shape[-1]):
        req_r = requests[:, r][:, None]  # [B, 1]
        cap_r = cap_b[:, :, r]
        ratio = floor_div(cap_r, xp.where(req_r > 1, req_r, 1))
        # an UNLIMITED cap never constrains, even for huge requests
        ratio = xp.where(cap_r >= UNLIMITED, UNLIMITED, ratio)
        best = xp.where(req_r > 0, xp.minimum(best, ratio), best)
    out = xp.where(best < MAX_INT32, best, MAX_INT32)
    out = xp.where(ns_rows[:, None] < 0, MAX_INT32, out)
    return out


def cluster_caps_np(caps, ns_rows, requests) -> np.ndarray:
    """numpy mirror of ``quota_cluster_caps`` for the host paths:
    int32[B, C]. Rows are independent and an uncapped row answers MAX_INT32
    everywhere, so only the capped rows go through the [rows, C, R] body."""
    caps = np.asarray(caps, np.int64)
    ns_rows = np.asarray(ns_rows, np.int32)
    out = np.full((len(ns_rows), caps.shape[1]), MAX_INT32, np.int32)
    capped = np.flatnonzero(ns_rows >= 0)
    if capped.size:
        out[capped] = _cluster_caps_body(
            np, caps, ns_rows[capped], np.asarray(requests, np.int64)[capped],
            np.floor_divide,
        )
    return out


def cluster_caps_ref(
    caps: torch.Tensor,  # int64[N, C, R]
    ns_rows: torch.Tensor,  # int32[B]: cap-table row, -1 = uncapped
    requests: torch.Tensor,  # int64[B, R]
) -> torch.Tensor:
    """Plain version of K13's per-row form: int32[B, C] max replicas each
    cluster's namespace slice admits (MAX_INT32 = no constraint)."""
    out = _cluster_caps_body(
        torch, caps.to(torch.int64), ns_rows.to(torch.int64),
        requests.to(torch.int64),
        lambda a, q: torch.div(a, q, rounding_mode="floor"),
    )
    return out.to(torch.int32)


def _check_caps(name, caps, ns_rows, requests) -> tuple[int, int, int, int]:
    native.check(name, caps=(caps, torch.int64), ns_rows=(ns_rows, torch.int32),
                 requests=(requests, torch.int64))
    n, c, r = caps.shape
    b = ns_rows.shape[0]
    if requests.shape != (b, r):
        raise ValueError(f"{name}: inconsistent shapes")
    if n == 0:
        raise ValueError(f"{name}: an empty cap tensor (no capped namespace)")
    return n, c, r, b


def quota_cluster_caps(
    caps: torch.Tensor,
    ns_rows: torch.Tensor,
    requests: torch.Tensor,
) -> torch.Tensor:
    """K13, per-row form: ``cluster_caps_ref`` as one kernel launch.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``quota_cluster_caps.launches`` counts kernel launches."""
    args = (caps, ns_rows, requests)
    if native.on_cpu(args):
        return cluster_caps_ref(*args)
    n, c, r, b = _check_caps("quota_cluster_caps", *args)
    out = torch.empty((b, c), dtype=torch.int32, device=caps.device)
    if b and c:
        native.launch(quota_cluster_caps, "quota_caps", "quota_caps_launch",
                      caps.device, caps, n, c, r, ns_rows, requests, b, out)
    return out


quota_cluster_caps.launches = 0


def quota_caps_fold_ref(
    table: torch.Tensor,  # int32[U, C]: profile table, -1 = no answer
    caps: torch.Tensor,  # int64[N, C, R]
    prof_ns: torch.Tensor,  # int32[U]: cap row per profile, -1 = uncapped
    profiles: torch.Tensor,  # int64[U, R]
) -> torch.Tensor:
    """Plain version of K13's fold form, in place on ``table`` (returned):
    where the cap answers below MAX_INT32 the cell becomes the min of the
    cap and the table's answer, a no-summary cell (-1) counting as
    MAX_INT32 — the JAX engine's ``_profile_table_quota``
    (karmada_tpu/scheduler/core.py:2295-2318)."""
    cap = cluster_caps_ref(caps, prof_ns, profiles)
    t = torch.where(table < 0, MAX_INT32, table)
    table.copy_(torch.where(cap < MAX_INT32, torch.minimum(t, cap), table))
    return table


def quota_caps_fold(
    table: torch.Tensor,
    caps: torch.Tensor,
    prof_ns: torch.Tensor,
    profiles: torch.Tensor,
) -> torch.Tensor:
    """K13, fold form: ``quota_caps_fold_ref`` as one kernel launch, in
    place on ``table``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. ``quota_caps_fold.launches`` counts kernel launches."""
    args = (table, caps, prof_ns, profiles)
    if native.on_cpu(args):
        return quota_caps_fold_ref(*args)
    n, c, r, u = _check_caps("quota_caps_fold", caps, prof_ns, profiles)
    native.check("quota_caps_fold", table=(table, torch.int32))
    if table.shape != (u, c):
        raise ValueError("quota_caps_fold: inconsistent shapes")
    if u and c:
        native.launch(quota_caps_fold, "quota_caps", "quota_fold_launch",
                      caps.device, caps, n, c, r, prof_ns, profiles, u, table)
    return table


quota_caps_fold.launches = 0
