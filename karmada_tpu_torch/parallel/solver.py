"""The fused scheduling step: estimate + merge + divide on one device.

Counterpart of ``karmada_tpu/parallel/solver.py`` ``schedule_step`` and
``schedule_step_interned``: estimator availability, no-summary masking,
min-merge and the unified division, as the two kernels of the port, K1
(``ops.estimate_merge``) and K2 (``ops.divide_replicas``). The arguments may
be numpy arrays or tensors; they are placed on ``device`` (the plain
versions run when it is the CPU). ``make_sharded_step`` (the (b, c)-mesh form)
waits for multi-GPU support.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.divide import DivideResult, divide_replicas
from ..ops.estimate import estimate_merge

def _place(x, dtype: torch.dtype, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype).contiguous()


def schedule_step_interned(
    available_cap,  # int64[C, R] cluster capacity
    has_summary,  # bool[C]
    profiles,  # int64[U, R] unique request rows
    prof_idx,  # int32[B]
    strategy,  # int32[B]
    replicas,  # int32[B]
    candidates,  # bool[B, C]
    static_w,  # int32[B, C]
    prev,  # int32[B, C]
    fresh,  # bool[B]
    has_aggregated: bool = True,
    wide: bool = True,
    fast: tuple | None = None,
    device: str | torch.device = "cuda",
) -> DivideResult:
    """``schedule_step`` with request-profile interning: the estimator runs
    per unique profile ([U, C] divisions) and the rows gather from it."""
    i32, i64, bl = torch.int32, torch.int64, torch.bool
    reps = _place(replicas, i32, device)
    avail = estimate_merge(
        _place(available_cap, i64, device),
        _place(profiles, i64, device),
        _place(prof_idx, i32, device),
        _place(has_summary, bl, device),
        reps,
    )
    return divide_replicas(
        _place(strategy, i32, device),
        reps,
        _place(candidates, bl, device),
        _place(static_w, i32, device),
        avail,
        _place(prev, i32, device),
        _place(fresh, bl, device),
        has_aggregated=has_aggregated,
        wide=wide,
        fast=fast,
    )


def schedule_step(
    available_cap,  # int64[C, R] cluster capacity
    has_summary,  # bool[C]
    requests,  # int64[B, R]
    strategy,  # int32[B]
    replicas,  # int32[B]
    candidates,  # bool[B, C]
    static_w,  # int32[B, C]
    prev,  # int32[B, C]
    fresh,  # bool[B]
    has_aggregated: bool = True,
    wide: bool = True,
    fast: tuple | None = None,
    device: str | torch.device = "cuda",
) -> DivideResult:
    """Estimator availability + min-merge + unified division for a batch
    whose every row is its own request profile."""
    b = requests.shape[0]
    return schedule_step_interned(
        available_cap, has_summary, requests, np.arange(b, dtype=np.int32),
        strategy, replicas, candidates, static_w, prev, fresh,
        has_aggregated=has_aggregated, wide=wide, fast=fast, device=device,
    )
