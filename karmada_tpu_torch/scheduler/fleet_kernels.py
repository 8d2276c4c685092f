"""The fleet path's device programs: hand-written kernels K3-K6 and their
plain versions.

Counterparts of the jitted programs of ``karmada_tpu/scheduler/fleet.py``:

===================  ==============================================  =========
wrapper              replaces                                        kernel
===================  ==============================================  =========
``fleet_masks``      ``_unpack_bits`` + ``_row_masks`` (fleet.py:174,  K3
                     184) and the per-chunk state gather, profile-
                     row gather and ``merge_estimates`` of
                     ``_fleet_pass`` (fleet.py:538-569)
``fleet_bits``       ``_fleet_bits`` (fleet.py:788)                   K3 bits
``fleet_diff``       ``_fleet_pass``'s per-chunk tail (fleet.py:574-   K4
                     634): Duplicated zeroing, dense8, meta, the
                     in-place resident diff and the cell deltas
``fleet_entry_rows`` ``_fleet_entries``' per-row stage (fleet.py:736-  K4 rows
                     745)
``fleet_wire``       ``_fleet_pass``'s wire (fleet.py:652-707)         K5
``entry_wire``       ``_fleet_entries``' compaction and wire, with     K5 entries
                     ``_entry_wire``/``_pack21`` (fleet.py:134-166,
                     747-769)
``scatter_rows``     ``_scatter_rows`` (fleet.py:1120)                K6
``gather_meta``      ``_gather_meta`` (fleet.py:828)                  K6 gather
``entry_diff``       ``_fleet_solve``'s per-chunk tail (fleet.py:314-  K16
                     337, 353-376): Duplicated zeroing, the site-
                     ordered entry words, n_placed / unsched /
                     has_cand, the diff against the entry resident
===================  ==============================================  =========

``fleet_pass`` and ``fleet_entries`` chain the kernels exactly as
``_fleet_pass`` and ``_fleet_entries`` compose their stages, and
``fleet_solve`` as ``_fleet_solve`` does (K3 -> K2 -> K16 per chunk, K6
writing the resident, K5's entry wire), with the JAX signatures minus
``mesh``/``shard_c``; K2 (``ops.divide_replicas``) divides between K3 and
K4 or K16. ``fleet_solve_ref`` is ``_fleet_solve`` line by line in plain
torch.

Every wrapper takes its plain version (``*_ref``) on CPU tensors and, on
CUDA tensors, launches its kernel or raises: dtypes, shapes and contiguity
are checked, and ``<wrapper>.launches`` counts launches. The plain versions
follow the JAX programs line by line (sorts where JAX sorts, cumsums where
it scans); the kernels replace the sorts by ordered compactions, which give
the same words because every sorted key is unique per row with the site in
its high bits.

Dtypes are pinned as in the reference: the residents are uint8[cap, C] and
int32[cap], wires are uint8, bitset words are computed in int64 and stored
as int32 (the uint32 bit pattern: ``.numpy().view(np.uint32)``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import native
from ..ops.divide import DUPLICATED, divide_replicas, divide_replicas_ref
from ..ops.estimate import MAX_INT32, merge_estimates

I32, I64, U8, BOOL = torch.int32, torch.int64, torch.uint8, torch.bool


# --------------------------------------------------------------------------
# wire helpers
# --------------------------------------------------------------------------


def _le32(total: torch.Tensor) -> torch.Tensor:
    """uint8[4]: an int32 scalar's little-endian bytes, by shifts."""
    t = total.to(I64)
    return torch.stack([(t >> s) & 0xFF for s in (0, 8, 16, 24)]).to(U8)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bit pattern."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


# --------------------------------------------------------------------------
# K3: row masks
# --------------------------------------------------------------------------


class ChunkMasks(NamedTuple):
    feasible: torch.Tensor  # bool[chunk, C]
    static_w: torch.Tensor  # int32[chunk, C]
    prev: torch.Tensor  # int32[chunk, C]
    avail: torch.Tensor  # int32[chunk, C] merged availability
    replicas: torch.Tensor  # int32[chunk] (0 on padding rows)
    strategy: torch.Tensor  # int32[chunk]
    fresh: torch.Tensor  # bool[chunk] (False on padding rows)


def unpack_bits_ref(bits_u8: torch.Tensor, c: int) -> torch.Tensor:
    """uint8[B, W8] (little bit order) -> bool[B, C]: ``_unpack_bits``."""
    shifts = torch.arange(8, dtype=U8, device=bits_u8.device)
    x = (bits_u8[:, :, None] >> shifts[None, None, :]) & 1
    return x.reshape(bits_u8.shape[0], -1)[:, :c] != 0


def row_masks_ref(cp_bits, cp_static, gvk_bits, incomplete_en, cpc, gvc, psc,
                  pcc, vc, chunk: int, c: int):
    """``_row_masks``: (prev, static_w, feasible) for one chunk of gathered
    slot indices. The previous-assignment scatter accumulates (padding
    pairs (site 0, count 0) add nothing) and drops sites outside [0, C)."""
    ok = (psc >= 0) & (psc < c)
    prev = torch.zeros((chunk, c), dtype=I32, device=cp_static.device)
    prev.scatter_add_(1, torch.where(ok, psc, 0).to(I64),
                      torch.where(ok, pcc, 0).to(I32))
    prev_mask = prev > 0
    cpc, gvc = cpc.to(I64), gvc.to(I64)
    bits = cp_bits[cpc]
    w8 = bits.shape[1] // 2
    aff_ok = unpack_bits_ref(bits[:, :w8], c)
    taint_ok = unpack_bits_ref(bits[:, w8:], c)
    static_w = cp_static[cpc]
    gvk_ok = unpack_bits_ref(gvk_bits[gvc], c)
    feasible = (
        aff_ok
        & (gvk_ok | (prev_mask & incomplete_en[None, :]))
        & (taint_ok | prev_mask)
        & vc[:, None]
    )
    return prev, static_w, feasible


def _scan_rows(rows: torch.Tensor, chunk: int, n_chunks: int) -> torch.Tensor:
    """The rows a JAX scan of ``n_chunks`` chunks of ``chunk`` rows reads."""
    return rows[: chunk * n_chunks] if chunk else rows


def _gather_rows(rows, cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
                 prev_sites, prev_counts):
    """The per-row state of a run of table rows (-1 = padding, read as row
    0 with replicas, fresh and counts zeroed), as _fleet_pass gathers it."""
    valid = rows >= 0
    r = rows.clamp_min(0).to(I64)
    return (
        valid, cp_idx[r], gvk_idx[r], prof_idx[r],
        torch.where(valid, replicas[r], 0).to(I32), strategy[r],
        fresh[r] & valid, prev_sites[r],
        torch.where(valid[:, None], prev_counts[r], 0).to(I32),
    )


def fleet_masks_ref(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en,
                    rows, cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
                    prev_sites, prev_counts) -> ChunkMasks:
    """Plain version of K3 over one chunk of ``rows``."""
    valid, cpc, gvc, pfc, reps, st, fr, psc, pcc = _gather_rows(
        rows, cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
        prev_sites, prev_counts,
    )
    c = cp_static.shape[1]
    prev, static_w, feasible = row_masks_ref(
        cp_bits, cp_static, gvk_bits, incomplete_en, cpc, gvc, psc, pcc,
        valid, rows.shape[0], c,
    )
    avail = merge_estimates(reps, (prof_table[pfc.to(I64)],))
    return ChunkMasks(feasible, static_w, prev, avail, reps, st, fr)


def fleet_bits_ref(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en,
                   rows, cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
                   prev_sites, prev_counts, *, chunk: int = 0,
                   n_chunks: int = 0) -> torch.Tensor:
    """Plain version of K3's bits form: ``_fleet_bits``' feasibility packed
    into 32-bit words (bit j of word w = cluster 32w + j), computed in
    int64 and stored as int32[n, ceil(C/32)], over the first
    ``chunk * n_chunks`` rows as the JAX scan reads them (all rows when
    ``chunk`` is 0)."""
    rows = _scan_rows(rows, chunk, n_chunks)
    valid, cpc, gvc, _, _, _, _, psc, pcc = _gather_rows(
        rows, cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
        prev_sites, prev_counts,
    )
    c = cp_static.shape[1]
    n = rows.shape[0]
    _, _, feasible = row_masks_ref(
        cp_bits, cp_static, gvk_bits, incomplete_en, cpc, gvc, psc, pcc,
        valid, n, c,
    )
    pad = torch.zeros((n, (-c) % 32), dtype=BOOL, device=feasible.device)
    f = torch.cat([feasible, pad], dim=1).reshape(n, -1, 32).to(I64)
    shifts = torch.arange(32, dtype=I64, device=f.device)
    return _wrap32((f << shifts).sum(dim=-1))


_TABLE_DTYPES = (U8, I32, U8, I32, BOOL)
_STATE_DTYPES = (I32, I32, I32, I32, I32, BOOL, I32, I32)
_TABLE_NAMES = ("cp_bits", "cp_static", "gvk_bits", "prof_table", "incomplete_en")
_STATE_NAMES = ("cp_idx", "gvk_idx", "prof_idx", "replicas", "strategy",
                "fresh", "prev_sites", "prev_counts")


def _check_masks_inputs(name, tables, rows, state) -> None:
    native.check(
        name, rows=(rows, I32),
        **{k: (t, d) for k, t, d in zip(_TABLE_NAMES, tables, _TABLE_DTYPES)},
        **{k: (t, d) for k, t, d in zip(_STATE_NAMES, state, _STATE_DTYPES)})
    cp_bits, cp_static, gvk_bits, prof_table, inc = tables
    c = cp_static.shape[1]
    w8 = (c + 7) // 8
    k_prev = state[6].shape[1]
    if (cp_bits.shape[1] != 2 * w8 or gvk_bits.shape[1] != w8
            or prof_table.shape[1] != c or inc.shape != (c,)
            or state[7].shape != state[6].shape or k_prev < 1):
        raise ValueError(f"{name}: inconsistent table or state shapes")


def fleet_masks(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en, rows,
                cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
                prev_sites, prev_counts) -> ChunkMasks:
    """K3: for each row of the chunk (any number of rows, any k_prev),
    resolve its slots, scatter-add its previous sites, unpack the gathered
    affinity/taint/GVK bit planes and write feasible, static weights, prev
    and the merged availability that K2 takes, plus the row's replicas,
    strategy and fresh flag."""
    tables = (cp_bits, cp_static, gvk_bits, prof_table, incomplete_en)
    state = (cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
             prev_sites, prev_counts)
    if native.on_cpu((*tables, rows, *state)):
        return fleet_masks_ref(*tables, rows, *state)
    _check_masks_inputs("fleet_masks", tables, rows, state)
    dev = rows.device
    b, c = rows.shape[0], cp_static.shape[1]
    out = ChunkMasks(
        torch.empty((b, c), dtype=BOOL, device=dev),
        torch.empty((b, c), dtype=I32, device=dev),
        torch.empty((b, c), dtype=I32, device=dev),
        torch.empty((b, c), dtype=I32, device=dev),
        torch.empty((b,), dtype=I32, device=dev),
        torch.empty((b,), dtype=I32, device=dev),
        torch.empty((b,), dtype=BOOL, device=dev),
    )
    if b and c:
        native.launch(fleet_masks, "fleet_masks", "fleet_masks_launch", dev,
                      *tables, c, gvk_bits.shape[1], rows, b, *state,
                      prev_sites.shape[1], *out)
    return out


fleet_masks.launches = 0


def fleet_bits(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en, rows,
               cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
               prev_sites, prev_counts, *, chunk: int = 0,
               n_chunks: int = 0) -> torch.Tensor:
    """K3 bits form: the same feasibility as ``fleet_masks``, packed into
    int32[n, ceil(C/32)] words (one thread per word, one warp per row)."""
    rows = _scan_rows(rows, chunk, n_chunks)
    tables = (cp_bits, cp_static, gvk_bits, prof_table, incomplete_en)
    state = (cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
             prev_sites, prev_counts)
    if native.on_cpu((*tables, rows, *state)):
        return fleet_bits_ref(*tables, rows, *state, chunk=chunk,
                              n_chunks=n_chunks)
    _check_masks_inputs("fleet_bits", tables, rows, state)
    dev = rows.device
    b, c = rows.shape[0], cp_static.shape[1]
    out = torch.empty((b, (c + 31) // 32), dtype=I32, device=dev)
    if b and c:
        native.launch(fleet_bits, "fleet_masks", "fleet_bits_launch", dev,
                      *tables, c, gvk_bits.shape[1], rows, b, *state,
                      prev_sites.shape[1], out)
    return out


fleet_bits.launches = 0


# --------------------------------------------------------------------------
# K4: resident diff (phase A tail) and entry rows (phase B)
# --------------------------------------------------------------------------


class ChunkDiff(NamedTuple):
    changed: torch.Tensor  # bool[chunk]
    meta: torch.Tensor  # int32[chunk]: n_placed | unsched<<8 | has_cand<<9
    dcount: torch.Tensor  # int32[chunk]: changed cells
    deltas: torch.Tensor  # int32[chunk, d_slots]: site<<9 | count+1


def fleet_diff_ref(assignment, unsched, feasible, strategy, rows, res_dense,
                   res_meta, *, all_rows: bool, offset: int,
                   d_slots: int) -> ChunkDiff:
    """Plain version of K4 phase A: ``_fleet_pass``'s body after the divide.
    Writes the chunk's dense rows and meta words into ``res_dense`` and
    ``res_meta`` IN PLACE (the port of the JAX donation): all_rows chunks
    own the contiguous rows [offset, offset + chunk), partial batches write
    their valid rows only (padding is dropped, as ``.at[].set(mode="drop")``
    drops it)."""
    chunk, c = assignment.shape
    valid = rows >= 0
    assignment = torch.where((strategy == DUPLICATED)[:, None], 0, assignment)
    dense8 = (assignment & 0xFF).to(U8)  # counts <= MAX_REPLICAS_FAST
    n_placed = (assignment > 0).sum(dim=1).to(I32)
    has_cand = feasible.any(dim=1)
    meta = n_placed | (unsched.to(I32) << 8) | (has_cand.to(I32) << 9)
    if all_rows:
        sl = slice(offset, offset + chunk)
        old_d = res_dense[sl].clone()
        old_m = res_meta[sl].clone()
        res_dense[sl] = dense8
        res_meta[sl] = meta
    else:
        rc = rows.clamp_min(0).to(I64)
        old_d = res_dense[rc]
        old_m = res_meta[rc]
        keep = rows[valid].to(I64)
        res_dense[keep] = dense8[valid]
        res_meta[keep] = meta[valid]
    cell_changed = (dense8 != old_d) & valid[:, None]
    dcount = cell_changed.sum(dim=1).to(I32)
    changed = (cell_changed.any(dim=1) | (meta != old_m)) & valid
    if d_slots:
        idxs = torch.arange(c, dtype=I32, device=assignment.device)[None, :]
        dp = torch.where(cell_changed, (idxs << 9) | (dense8.to(I32) + 1),
                         MAX_INT32)
        srt = torch.sort(dp, dim=1).values[:, :d_slots]
        deltas = torch.where(srt == MAX_INT32, 0, srt)
    else:
        deltas = torch.zeros((chunk, 0), dtype=I32, device=assignment.device)
    return ChunkDiff(changed, meta, dcount, deltas)


def _into(out, got):
    """``got`` copied into the preallocated ``out`` (views of a pass-wide
    buffer), which is returned; ``got`` itself without ``out``."""
    if out is None:
        return got
    for o, g in zip(out, got):
        o.copy_(g)
    return out


def _check_out(name: str, out, want: tuple) -> None:
    """``out``'s tensors are contiguous, of the dtypes and shapes in
    ``want`` ((dtype, shape) pairs), on the device of the inputs."""
    if len(out) != len(want) or any(
            not o.is_contiguous() or o.dtype != d or tuple(o.shape) != shape
            for o, (d, shape) in zip(out, want)):
        raise ValueError(f"{name}: out= must be contiguous tensors of "
                         f"{[(str(d), s) for d, s in want]}")


def fleet_diff(assignment, unsched, feasible, strategy, rows, res_dense,
               res_meta, *, all_rows: bool, offset: int, d_slots: int,
               out: Optional[ChunkDiff] = None) -> ChunkDiff:
    """K4 phase A: one block per row zeroes Duplicated rows, writes dense8
    and the meta word over the resident IN PLACE, and emits the changed
    flag, the changed-cell count and the first ``d_slots`` cell deltas in
    site order (an ordered compaction in place of the JAX sort, skipped on
    a row with no changed cell). With ``out``, the outputs are written
    into those tensors (a chunk's rows of pass-wide buffers)."""
    args = (assignment, unsched, feasible, strategy, rows, res_dense, res_meta)
    if native.on_cpu(args):
        return _into(out, fleet_diff_ref(*args, all_rows=all_rows, offset=offset,
                                         d_slots=d_slots))
    native.check("fleet_diff", assignment=(assignment, I32),
                 unsched=(unsched, BOOL), feasible=(feasible, BOOL),
                 strategy=(strategy, I32), rows=(rows, I32),
                 res_dense=(res_dense, U8), res_meta=(res_meta, I32))
    b, c = assignment.shape
    cap = res_dense.shape[0]
    if (feasible.shape != (b, c) or res_dense.shape[1] != c
            or res_meta.shape != (cap,)
            or any(t.shape != (b,) for t in (unsched, strategy, rows))
            or not 0 <= d_slots <= min(64, c)
            or (all_rows and not 0 <= offset <= cap - b)):
        raise ValueError("fleet_diff: inconsistent shapes")
    dev = rows.device
    want = ((BOOL, (b,)), (I32, (b,)), (I32, (b,)), (I32, (b, d_slots)))
    if out is None:
        out = ChunkDiff(*(torch.empty(sh, dtype=d, device=dev) for d, sh in want))
    else:
        _check_out("fleet_diff", out, want)
    if b:
        native.launch(fleet_diff, "fleet_diff", "fleet_diff_launch", dev,
                      assignment, unsched, feasible, strategy, rows, b, c,
                      res_dense, res_meta, cap, int(all_rows), offset,
                      d_slots, *out)
    return out


fleet_diff.launches = 0


def fleet_entry_rows_ref(res_dense, rows, k_out: int) -> torch.Tensor:
    """Plain version of K4 phase B: ``_fleet_entries``' per-row stage —
    the site-ascending (site<<8 | count) words of each row's nonzero
    cells, first ``k_out``; rows -1 give zeros."""
    c = res_dense.shape[1]
    vc = rows >= 0
    dense = res_dense[rows.clamp_min(0).to(I64)].to(I32)
    dense = torch.where(vc[:, None], dense, 0)
    idxs = torch.arange(c, dtype=I32, device=res_dense.device)[None, :]
    packed = torch.where(dense > 0, (idxs << 8) | dense, MAX_INT32)
    srt = torch.sort(packed, dim=1).values[:, :k_out]
    return torch.where(srt == MAX_INT32, 0, srt)


def fleet_entry_rows(res_dense, rows, k_out: int) -> torch.Tensor:
    """K4 phase B: one warp per row, an ordered compaction of the row's
    nonzero cells into int32[m, k_out]."""
    if native.on_cpu((res_dense, rows)):
        return fleet_entry_rows_ref(res_dense, rows, k_out)
    native.check("fleet_entry_rows", res_dense=(res_dense, U8),
                 rows=(rows, I32))
    cap, c = res_dense.shape
    if rows.dim() != 1 or not 0 < k_out <= max(c, 1):
        raise ValueError("fleet_entry_rows: inconsistent shapes")
    m = rows.shape[0]
    out = torch.empty((m, k_out), dtype=I32, device=rows.device)
    if m:
        native.launch(fleet_entry_rows, "fleet_diff",
                      "fleet_entry_rows_launch", rows.device, res_dense, cap,
                      c, rows, m, k_out, out)
    return out


fleet_entry_rows.launches = 0


# --------------------------------------------------------------------------
# K5: ordered capped compaction and the wire serialisers
# --------------------------------------------------------------------------


def compact_ref(values: torch.Tensor, flags: torch.Tensor, cap: int,
                fill: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(out[cap], total): the flagged values in input order, the first
    ``cap`` of them (``fill`` beyond the total); ``total`` counts them all.
    The cumsum-and-scatter compaction of fleet.py:388-393/659-662."""
    flags = flags.to(BOOL)
    f32 = flags.to(I32)
    offs = torch.cumsum(f32, 0, dtype=I32) - f32
    total = f32.sum(dtype=I32)
    write = torch.where(flags & (offs < cap), offs, cap).to(I64)
    buf = torch.full((cap + 1,), fill, dtype=I32, device=values.device)
    buf[write[flags]] = values.to(I32)[flags]
    return buf[:cap], total


def pack21_ref(stream: torch.Tensor, e_cap: int) -> torch.Tensor:
    """``_pack21``: int32 values < 2^21 as a 21-bit little-endian bit
    stream, each output byte drawn from at most two adjacent fields
    (computed in int64: the low byte of each shift is the int32 one)."""
    nb = (e_cap * 21 + 7) // 8
    idx = torch.arange(nb, dtype=I64, device=stream.device) * 8
    k1 = idx // 21
    off = idx - 21 * k1
    s_ext = torch.cat([stream.to(I64), torch.zeros(1, dtype=I64, device=stream.device)])
    lo = s_ext[k1] >> off
    hi = s_ext[torch.clamp_max(k1 + 1, e_cap)] << (21 - off)
    return ((lo | hi) & 0xFF).to(U8)


def entry_bytes_ref(stream: torch.Tensor, e_cap: int, pack21: bool) -> torch.Tensor:
    """``_entry_wire``: the 21-bit stream plus 3 pad bytes, or 3 bytes an
    entry."""
    if pack21:
        return torch.cat([pack21_ref(stream, e_cap),
                          torch.zeros(3, dtype=U8, device=stream.device)])
    s = stream.to(I64)
    return torch.stack([s & 0xFF, (s >> 8) & 0xFF, (s >> 16) & 0xFF],
                       dim=-1).to(U8).reshape(-1)


def fleet_wire_ref(changed, meta, dcount, rows, deltas, *, m_cap: int,
                   d_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5's phase-A wire (fleet.py:652-707): (flat uint8,
    rowbuf int32[m_cap]). Layout: 4 B total | changed bitmask n/8 B |
    m_cap x 2 B changed metas (min(dcount, 63) << 10 in the spare bits) |
    when d_cap: 4 B dtotal | d_cap x 3 B cell deltas of changed rows with
    dcount <= 62."""
    n = changed.shape[0]
    changed = changed.to(BOOL)
    wire_meta = meta | (torch.clamp_max(dcount, 63) << 10)
    mstream, total = compact_ref(wire_meta, changed, m_cap)
    rowbuf, _ = compact_ref(rows.clamp_min(0), changed, m_cap, fill=-1)
    bits = changed.reshape(n // 8, 8).to(I64)
    mask_u8 = (bits << torch.arange(8, dtype=I64, device=bits.device)).sum(-1).to(U8)
    ms = mstream.to(I64)
    meta_u8 = torch.stack([ms & 0xFF, (ms >> 8) & 0xFF], dim=-1).to(U8).reshape(-1)
    parts = [_le32(total), mask_u8, meta_u8]
    if d_cap:
        contrib = changed & (dcount <= 62)
        rowv = torch.where(contrib[:, None], deltas, 0).reshape(-1)
        dstream, dtotal = compact_ref(rowv, rowv != 0, d_cap)
        parts += [_le32(dtotal), entry_bytes_ref(dstream, d_cap, False)]
    return torch.cat(parts), rowbuf


def _solve_wire(total_u8_or_i32, meta, body, byte_wire: bool) -> torch.Tensor:
    """``_fleet_solve``'s wire (fleet.py:400-420): total | meta | entries,
    the meta words as 2 little-endian bytes on the byte wire."""
    if byte_wire:
        m = meta.to(I64)
        meta_u8 = torch.stack([m & 0xFF, (m >> 8) & 0xFF], dim=-1).to(U8).reshape(-1)
        return torch.cat([total_u8_or_i32, meta_u8, body])
    return torch.cat([total_u8_or_i32, meta, body])


def entry_wire_ref(entries: torch.Tensor, *, e_cap: int, byte_wire: bool,
                   pack21: bool = False,
                   meta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K5's entry wire (fleet.py:755-769): the positive
    words of ``entries`` in row-major order compacted into ``e_cap``, then
    4 B total + entry bytes (uint8), or int32 [total, stream...] without
    the byte wire. With ``meta``, the metas go between the total and the
    entries (``_fleet_solve``'s wire, fleet.py:400-420)."""
    flat = entries.reshape(-1)
    stream, total = compact_ref(flat, flat > 0, e_cap)
    if byte_wire:
        head, body = _le32(total), entry_bytes_ref(stream, e_cap, pack21)
    else:
        head, body = total.reshape(1), stream
    if meta is None:
        return torch.cat([head, body])
    return _solve_wire(head, meta, body, byte_wire)


#: rows a tile of the phase-A wire, entry words a tile of the entry wire
#: (csrc/fleet_wire.cu ROW_TILE, ENTRY_TILE)
WIRE_ROW_TILE = 256
WIRE_ENTRY_TILE = 8192
_FILL_BYTES = 32768  # tail bytes a fill block writes, at most 1024 blocks


def _wire_launch_args(n_items: int, tile: int, tail_bytes: int, dev) -> tuple:
    """The look-back scratch (the tile counter and a status word a tile,
    zeroed by the launch) and the number of fill blocks for a tail of at
    most ``tail_bytes``."""
    n_tiles = max(1, -(-n_items // tile))
    scratch = torch.empty((1 + n_tiles,), dtype=I64, device=dev)
    return scratch, max(1, min(1024, -(-tail_bytes // _FILL_BYTES)))


def fleet_wire(changed, meta, dcount, rows, deltas, *, m_cap: int,
               d_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 phase-A wire: one single-pass ordered compaction over the rows
    (a memset of its look-back state and one launch): the changed rows'
    metas and table rows, and the delta words of the changed rows with
    dcount <= 62 (only those rows read theirs), written straight into
    the wire with the bitmask and the totals."""
    args = (changed, meta, dcount, rows, deltas)
    if native.on_cpu(args):
        return fleet_wire_ref(*args, m_cap=m_cap, d_cap=d_cap)
    native.check("fleet_wire", changed=(changed, BOOL), meta=(meta, I32),
                 dcount=(dcount, I32), rows=(rows, I32), deltas=(deltas, I32))
    n = changed.shape[0]
    d_slots = deltas.shape[1] if deltas.dim() == 2 else -1
    if (n % 8 or n >= 1 << 24 or any(t.shape != (n,) for t in (meta, dcount, rows))
            or deltas.dim() != 2 or deltas.shape[0] != n or d_slots > 64
            or (d_cap and not d_slots) or m_cap < 0 or d_cap < 0):
        raise ValueError("fleet_wire: inconsistent shapes")
    dev = changed.device
    length = 4 + n // 8 + 2 * m_cap + (4 + 3 * d_cap if d_cap else 0)
    flat = torch.empty((length,), dtype=U8, device=dev)
    rowbuf = torch.empty((m_cap,), dtype=I32, device=dev)
    scratch, fill = _wire_launch_args(n, WIRE_ROW_TILE, 6 * m_cap + 3 * d_cap, dev)
    native.launch(fleet_wire, "fleet_wire", "fleet_wire_launch", dev,
                  changed, meta, dcount, rows, deltas, n, d_slots, m_cap, d_cap,
                  flat, rowbuf, scratch, fill)
    return flat, rowbuf


fleet_wire.launches = 0


def entry_wire(entries: torch.Tensor, *, e_cap: int, byte_wire: bool,
               pack21: bool = False,
               meta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 entry wire: one single-pass ordered compaction of the positive
    entry words (a memset of its look-back state and one launch), each
    written straight into its 3 bytes, its 21 bits or its int32 word;
    with ``meta``, the metas are written in place between the total and
    the entries."""
    ins = (entries,) if meta is None else (entries, meta)
    if native.on_cpu(ins):
        return entry_wire_ref(entries, e_cap=e_cap, byte_wire=byte_wire,
                              pack21=pack21, meta=meta)
    native.check("entry_wire", entries=(entries, I32),
                 **({} if meta is None else {"meta": (meta, I32)}))
    n = entries.numel()
    m = 0 if meta is None else meta.numel()
    if n >= 1 << 31 or e_cap < 0 or (meta is not None and meta.dim() != 1):
        raise ValueError("entry_wire: inconsistent shapes")
    dev = entries.device
    if byte_wire:
        body = ((e_cap * 21 + 7) // 8 + 3) if pack21 else 3 * e_cap
        out = torch.empty((4 + 2 * m + body,), dtype=U8, device=dev)
    else:
        body = 4 * e_cap
        out = torch.empty((1 + m + e_cap,), dtype=I32, device=dev)
    form = (2 if pack21 else 1) if byte_wire else 0
    scratch, fill = _wire_launch_args(n, WIRE_ENTRY_TILE, body, dev)
    native.launch(entry_wire, "fleet_wire", "entry_wire_launch", dev,
                  entries, n, e_cap, form, meta, m, out, scratch, fill)
    return out


entry_wire.launches = 0


# --------------------------------------------------------------------------
# K6: dirty-row upsert and the meta gather
# --------------------------------------------------------------------------


def scatter_rows_ref(state: tuple, rows: torch.Tensor, vals: tuple) -> tuple:
    """Plain version of K6: ``_scatter_rows``, in place — each state array
    takes ``vals`` at ``rows`` (rows outside [0, cap) are dropped)."""
    for a, v in zip(state, vals):
        ok = (rows >= 0) & (rows < a.shape[0])
        a[rows[ok].to(I64)] = v[ok]
    return state


def scatter_rows(state: tuple, rows: torch.Tensor, vals: tuple) -> tuple:
    """K6: one launch writes the dirty rows of every state array in place
    (a warp a group of 32 rows and a field, the kept rows copied in 16-B or
    narrower units). Repeated rows — the pow2 padding repeats the first —
    write identical values."""
    if native.on_cpu((*state, rows, *vals)):
        return scatter_rows_ref(state, rows, vals)
    if len(state) != len(vals) or not 0 < len(state) <= 8:
        raise ValueError("scatter_rows: one value array per state array, at most 8")
    native.check("scatter_rows", rows=(rows, I64))
    k = rows.shape[0]
    cap = state[0].shape[0]
    widths = []
    for a, v in zip(state, vals):
        if (not a.is_contiguous() or not v.is_contiguous() or a.dtype != v.dtype
                or a.shape[0] != cap or v.shape != (k, *a.shape[1:])):
            raise ValueError("scatter_rows: state/value arrays disagree")
        widths.append(a[0].numel() * a.element_size() if cap else 0)
    nf = len(state)
    ptrs = ctypes.c_void_p * 8
    dst = ptrs(*[a.data_ptr() for a in state], *[None] * (8 - nf))
    src = ptrs(*[v.data_ptr() for v in vals], *[None] * (8 - nf))
    wid = (ctypes.c_int * 8)(*widths, *[0] * (8 - nf))
    if k:
        native.launch(scatter_rows, "scatter_rows", "scatter_rows_launch",
                      rows.device, dst, src, wid, nf, rows, k, cap)
    return state


scatter_rows.launches = 0


def gather_meta_ref(res_meta: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``_gather_meta``: the 2-byte wire of the meta words at ``rows``
    (-1 gives 0)."""
    m = torch.where(rows >= 0, res_meta[rows.clamp_min(0).to(I64)], 0).to(I64)
    return torch.stack([m & 0xFF, (m >> 8) & 0xFF], dim=-1).to(U8).reshape(-1)


def gather_meta(res_meta: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """K6 gather: ``gather_meta_ref`` as one launch, a thread per row."""
    if native.on_cpu((res_meta, rows)):
        return gather_meta_ref(res_meta, rows)
    native.check("gather_meta", res_meta=(res_meta, I32), rows=(rows, I32))
    m = rows.shape[0]
    out = torch.empty((2 * m,), dtype=U8, device=rows.device)
    if m:
        native.launch(gather_meta, "scatter_rows", "gather_meta_launch",
                      rows.device, res_meta, res_meta.shape[0], rows, m, out)
    return out


gather_meta.launches = 0


# --------------------------------------------------------------------------
# the two phases, chained as the JAX programs compose their stages
# --------------------------------------------------------------------------


def fleet_pass(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en, rows,
               cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
               prev_sites, prev_counts, res_dense, res_meta, *, chunk: int,
               n_chunks: int, wide: bool, fast: Optional[tuple],
               has_aggregated: bool, all_rows: bool, m_cap: int,
               d_cap: int = 0):
    """Phase A (``_fleet_pass``): per chunk K3 -> K2 -> K4, each chunk's
    K4 writing its rows of pass-wide buffers, then K5 over the whole pass.
    Returns (flat_wire_u8, rowbuf, res_dense, res_meta); the residents are
    updated in place and returned for signature parity."""
    c = cp_static.shape[1]
    d_slots = min(64, c) if d_cap else 0
    tables = (cp_bits, cp_static, gvk_bits, prof_table, incomplete_en)
    state = (cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
             prev_sites, prev_counts)
    n, dev = chunk * n_chunks, rows.device
    diff = ChunkDiff(torch.empty((n,), dtype=BOOL, device=dev),
                     torch.empty((n,), dtype=I32, device=dev),
                     torch.empty((n,), dtype=I32, device=dev),
                     torch.empty((n, d_slots), dtype=I32, device=dev))
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        m = fleet_masks(*tables, rows[sl], *state)
        assignment, unsched = divide_replicas(
            m.strategy, m.replicas, m.feasible, m.static_w, m.avail, m.prev,
            m.fresh, has_aggregated, wide, fast,
        )
        fleet_diff(assignment, unsched, m.feasible, m.strategy, rows[sl],
                   res_dense, res_meta, all_rows=all_rows, offset=i * chunk,
                   d_slots=d_slots, out=ChunkDiff(*(t[sl] for t in diff)))
    flat, rowbuf = fleet_wire(diff.changed, diff.meta, diff.dcount, rows,
                              diff.deltas, m_cap=m_cap, d_cap=d_cap)
    return flat, rowbuf, res_dense, res_meta


def fleet_entries(res_dense, rows, *, chunk: int, n_chunks: int, k_out: int,
                  e_cap: int, byte_wire: bool, pack21: bool = False):
    """Phase B (``_fleet_entries``): K4's entry rows over the first
    ``chunk * n_chunks`` rows (the rows the JAX scan reads; one launch
    takes them all), then K5's entry wire."""
    ents = fleet_entry_rows(res_dense, _scan_rows(rows, chunk, n_chunks), k_out)
    return entry_wire(ents, e_cap=e_cap, byte_wire=byte_wire, pack21=pack21)


# --------------------------------------------------------------------------
# K16: the entry-resident diff, and the single-dispatch solve
# --------------------------------------------------------------------------


class EntryDiff(NamedTuple):
    meta: torch.Tensor  # int32[chunk]: n_placed | unsched<<8 | has_cand<<9 | changed<<10
    entries: torch.Tensor  # int32[chunk, k_res]: the new entry row if changed, else 0
    commit: torch.Tensor  # int64[chunk]: the resident row to write, -1 for none


def _entry_rows_ref(assignment, strategy, k_out: int):
    """``_fleet_solve``'s entry stage (fleet.py:314-334): Duplicated rows
    zeroed, then each row's placed (site<<8 | count) words sorted, the
    first ``k_out`` kept. Returns (entries int32[chunk, k_out], n_placed)."""
    c = assignment.shape[1]
    assignment = torch.where((strategy == DUPLICATED)[:, None], 0, assignment)
    selected = assignment > 0
    n_placed = selected.sum(dim=1).to(I32)
    idxs = torch.arange(c, dtype=I32, device=assignment.device)[None, :]
    packed_full = torch.where(selected, (idxs << 8) | assignment, MAX_INT32)
    srt = torch.sort(packed_full, dim=1).values[:, :k_out]
    return torch.where(srt == MAX_INT32, 0, srt), n_placed


def _pad_cols(entries: torch.Tensor, k_res: int) -> torch.Tensor:
    k_out = entries.shape[1]
    if k_res <= k_out:
        return entries
    return torch.cat([entries, entries.new_zeros((entries.shape[0], k_res - k_out))], 1)


def entry_diff_ref(assignment, unsched, feasible, strategy, rows, resident, *,
                   k_out: int, all_rows: bool, offset: int) -> EntryDiff:
    """Plain version of K16 over one chunk: the chunk's entry rows (zero-
    padded to the resident's width) diffed against the resident as it
    stood before the pass, which is read and not written. all_rows chunks
    own the contiguous rows [offset, offset + chunk) and commit their
    padding rows too (the JAX slice update writes them); partial batches
    read padding rows at row 0 and commit only changed valid rows. A
    changed row's meta word carries bit 10 and its entries ride
    ``entries``; unchanged rows give zeros there."""
    chunk = assignment.shape[0]
    k_res = resident.shape[1]
    valid = rows >= 0
    entries, n_placed = _entry_rows_ref(assignment, strategy, k_out)
    entries = _pad_cols(entries, k_res)
    has_cand = feasible.any(dim=1)
    if all_rows:
        target = torch.arange(offset, offset + chunk, dtype=I64, device=rows.device)
    else:
        target = rows.clamp_min(0).to(I64)
    changed = (entries != resident[target]).any(dim=1) & valid
    meta = (n_placed | (unsched.to(I32) << 8) | (has_cand.to(I32) << 9)
            | (changed.to(I32) << 10))
    write = (changed | ~valid) if all_rows else changed
    return EntryDiff(meta, torch.where(changed[:, None], entries, 0),
                     torch.where(write, target, -1))


def entry_diff(assignment, unsched, feasible, strategy, rows, resident, *,
               k_out: int, all_rows: bool, offset: int,
               out: Optional[EntryDiff] = None) -> EntryDiff:
    """K16: one block per row zeroes a Duplicated row, compacts the row's
    placed cells in site order into its first ``k_out`` entry words (an
    ordered compaction in place of the JAX sort), counts the placed sites
    and the feasible ones, and diffs the words against the resident row,
    which it only reads; ``fleet_solve`` writes the resident after the
    last chunk (K6 over ``commit``), so a row named twice in one batch is
    diffed against the pre-pass resident both times, as in JAX. With
    ``out``, the outputs are written into those tensors (a chunk's rows of
    pass-wide buffers)."""
    args = (assignment, unsched, feasible, strategy, rows, resident)
    kw = dict(k_out=k_out, all_rows=all_rows, offset=offset)
    if native.on_cpu(args):
        return _into(out, entry_diff_ref(*args, **kw))
    native.check("entry_diff", assignment=(assignment, I32),
                 unsched=(unsched, BOOL), feasible=(feasible, BOOL),
                 strategy=(strategy, I32), rows=(rows, I32),
                 resident=(resident, I32))
    b, c = assignment.shape
    cap, k_res = resident.shape
    if (feasible.shape != (b, c)
            or any(t.shape != (b,) for t in (unsched, strategy, rows))
            or not 0 < k_out <= min(k_res, max(c, 1))
            or (all_rows and not 0 <= offset <= cap - b)):
        raise ValueError("entry_diff: inconsistent shapes")
    dev = rows.device
    want = ((I32, (b,)), (I32, (b, k_res)), (I64, (b,)))
    if out is None:
        out = EntryDiff(*(torch.empty(sh, dtype=d, device=dev) for d, sh in want))
    else:
        _check_out("entry_diff", out, want)
    if b:
        native.launch(entry_diff, "entry_diff", "entry_diff_launch", dev,
                      assignment, unsched, feasible, strategy, rows, b, c,
                      resident, cap, k_res, k_out, int(all_rows), offset, *out)
    return out


entry_diff.launches = 0


def fleet_solve_ref(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en,
                    rows, cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
                    prev_sites, prev_counts, prev_entries, *, chunk: int,
                    n_chunks: int, k_out: int, k_res: int, e_cap: int,
                    wide: bool, fast: Optional[tuple], has_aggregated: bool,
                    all_rows: bool, pack21: bool = False):
    """``_fleet_solve`` (karmada_tpu/scheduler/fleet.py:277-420) line by
    line: per chunk the masks, the profile-row merge and the division,
    then the Duplicated zeroing, the sorted entry prefix, n_placed, unsched
    and has_cand; the entry rows padded to ``k_res`` and diffed against
    ``prev_entries`` (a contiguous slice for the all-rows storm, a row
    gather otherwise), which takes the new rows IN PLACE (the port of the
    donation; padding rows of a partial batch are dropped as
    ``mode="drop"`` drops them); one cumsum compaction of the changed
    rows' entries into ``e_cap``; the meta words; and the wire (4 B total,
    2 B metas, 3-byte or 21-bit entries; int32 when C > 0xFFFF). Returns
    (flat, prev_entries)."""
    tables = (cp_bits, cp_static, gvk_bits, prof_table, incomplete_en)
    state = (cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
             prev_sites, prev_counts)
    valid = rows >= 0
    r = rows.clamp_min(0).to(I64)
    ents, placed, unsched, cand = [], [], [], []
    for i in range(n_chunks):
        m = fleet_masks_ref(*tables, rows[i * chunk : (i + 1) * chunk], *state)
        assignment, u = divide_replicas_ref(
            m.strategy, m.replicas, m.feasible, m.static_w, m.avail, m.prev,
            m.fresh, has_aggregated, wide, fast,
        )
        e, n_placed = _entry_rows_ref(assignment, m.strategy, k_out)
        ents.append(e)
        placed.append(n_placed)
        unsched.append(u)
        cand.append(m.feasible.any(dim=1))
    entries = _pad_cols(torch.cat(ents), k_res)
    n_placed, unsched, has_cand = torch.cat(placed), torch.cat(unsched), torch.cat(cand)
    n = entries.shape[0]
    if all_rows:
        changed = (entries != prev_entries[:n]).any(dim=1) & valid
        prev_entries[:n] = entries
    else:
        changed = (entries != prev_entries[r]).any(dim=1) & valid
        prev_entries[r[valid]] = entries[valid]
    valid_e = ((entries > 0) & changed[:, None]).reshape(-1)
    stream, total = compact_ref(entries.reshape(-1), valid_e, e_cap)
    meta = (n_placed | (unsched.to(I32) << 8) | (has_cand.to(I32) << 9)
            | (changed.to(I32) << 10))
    if cp_static.shape[1] <= 0xFFFF:
        flat = _solve_wire(_le32(total), meta, entry_bytes_ref(stream, e_cap, pack21), True)
    else:
        flat = _solve_wire(total.reshape(1), meta, stream, False)
    return flat, prev_entries


def fleet_solve(cp_bits, cp_static, gvk_bits, prof_table, incomplete_en, rows,
                cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
                prev_sites, prev_counts, prev_entries, *, chunk: int,
                n_chunks: int, k_out: int, k_res: int, e_cap: int, wide: bool,
                fast: Optional[tuple], has_aggregated: bool, all_rows: bool,
                pack21: bool = False):
    """The single-dispatch pass (``_fleet_solve``): per chunk K3 -> K2 ->
    K16, each chunk's K16 writing its rows of pass-wide buffers, then K6
    writes the changed entry rows into ``prev_entries`` in place and K5's
    entry wire compacts and serialises them, the metas written in place
    between the total and the entries. Returns (flat, prev_entries)."""
    if prev_entries.shape[1] != k_res:
        raise ValueError("fleet_solve: the resident is not k_res wide")
    tables = (cp_bits, cp_static, gvk_bits, prof_table, incomplete_en)
    state = (cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh,
             prev_sites, prev_counts)
    n, dev = chunk * n_chunks, rows.device
    diff = EntryDiff(torch.empty((n,), dtype=I32, device=dev),
                     torch.empty((n, k_res), dtype=I32, device=dev),
                     torch.empty((n,), dtype=I64, device=dev))
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        m = fleet_masks(*tables, rows[sl], *state)
        assignment, unsched = divide_replicas(
            m.strategy, m.replicas, m.feasible, m.static_w, m.avail, m.prev,
            m.fresh, has_aggregated, wide, fast,
        )
        entry_diff(assignment, unsched, m.feasible, m.strategy, rows[sl],
                   prev_entries, k_out=k_out, all_rows=all_rows, offset=i * chunk,
                   out=EntryDiff(*(t[sl] for t in diff)))
    scatter_rows((prev_entries,), diff.commit, (diff.entries,))
    flat = entry_wire(diff.entries, e_cap=e_cap, byte_wire=cp_static.shape[1] <= 0xFFFF,
                      pack21=pack21, meta=diff.meta)
    return flat, prev_entries
