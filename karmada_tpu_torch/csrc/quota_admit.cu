// K12 quota_admit: FIFO quota admission of one wave, per namespace.
//
// Replaces karmada_tpu/ops/quota.py:64 quota_admit (the FederatedResourceQuota
// admission pass of karmada_tpu/scheduler/core.py:627 _quota_admission).
//
//   in:  ns_ids int32[B] (namespace row, < 0 = not quota'd),
//        demand int64[B, R] (>= 0, each <= DEMAND_CLAMP = 2^44),
//        remaining int64[N, R] (UNLIMITED = 2^62 where a dim has no limit)
//   out: admitted uint8[B], wave_used int64[N, R]
//   scratch (the wrapper allocates it): keys uint32[2][B], idx int32[2][B],
//        counts uint32[ndig * 256 + ndig * tiles * 256], tinfo
//        int32[scan_tiles][2], tagg int64[scan_tiles][R]; tiles = ceil(B /
//        2048), scan_tiles = ceil(B / 1024), ndig = the 8-bit digits of N (at
//        least 1)
//
// A row is admitted iff, on every dim, the inclusive sum of the demand of the
// rows of its namespace up to and including it (arrival order) is at most
// the namespace's remaining quota. A denied row's demand still holds its
// place in line. wave_used[k] is the admitted demand of namespace k.
//
// The JAX program sorts by the key ns * B + row, takes one cumsum over the
// sorted wave and a cummax of the segment bases: the key is a stable
// partition of the rows by namespace. This kernel builds that partition
// once and reads each row a constant number of times, whatever N is:
//  1. keys: segment s = ns for 0 <= ns < N, else N (the pad segment: JAX
//     compares negative ids with UNLIMITED and ids at or above N with the
//     UNLIMITED pad row of a clamped gather, and its scatter-add drops
//     both; under the demand contract, B <= 2^17 rows of at most 2^44, no
//     segment sum reaches 2^62, so every such row is admitted and adds
//     nothing to wave_used); the digit counts of the sort; wave_used zeroed.
//  2. a stable LSD radix sort of (s, row) over the 8-bit digits of N
//     (radix_sort.cuh): one pass up to 255 namespaces, two up to 65,535.
//  3. tiles: per 1024-position tile of the sorted order, its first and last
//     segment and the demand of its last segment's rows, per dim (warp sums
//     and atomic adds: those rows are the tile's suffix).
//  4. admit: per tile, the carry of the segment it starts in (the tiles
//     before it whose last segment is that one: a block-wide min over at
//     most 127 predecessors finds where the segment starts, and warp 0 sums
//     their demand); a block-wide segmented scan of the demand, dims DT at
//     a time, plus the carry; the compare with remaining[s] (the pad
//     segment is admitted); the verdict written through the stored row;
//     then a warp-wide segmented scan of the admitted demand, and one
//     atomic add per segment run of a warp and dim into wave_used (int64
//     sums of non-negative values: any order is exact).
// Any R: dims are taken DT at a time in registers, so the verdict is the
// AND over the tiles of dims.
//
// What bounds it on an H100: latency, not bytes. The wave is at most 2^17
// rows (ns 512 KB and demand 4 MB at R = 4, read once, about 1.4 us at HBM
// rate); the work is 3 + ndig launches over 128 blocks at most, each a few
// block-wide scans and barriers, so the time no longer grows with N.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix_sort.cuh"

namespace {

using radix::BINS;
using radix::ITEMS;
using radix::SCAN_ITEMS;
using radix::SCAN_TILE;
using radix::Seg;
using radix::THREADS;
using radix::TILE;
typedef unsigned long long u64;

constexpr int DT = 4;  // dims a scan carries in registers

__global__ void __launch_bounds__(THREADS) admit_keys_kernel(
    const int32_t* __restrict__ ns_ids, int b_n, int n_ns, int ndig, int r_dims,
    uint32_t* __restrict__ keys, int32_t* __restrict__ idx, uint32_t* __restrict__ hist,
    uint32_t* __restrict__ counts, int64_t* __restrict__ wave_used, int64_t* __restrict__ tagg) {
  __shared__ uint32_t s_hist[4 * BINS];
  for (int i = threadIdx.x; i < ndig * BINS; i += THREADS) s_hist[i] = 0;
  __syncthreads();
  const int tile = blockIdx.x, tiles = gridDim.x;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tile * TILE + it * THREADS + threadIdx.x;
    if (e >= b_n) continue;
    const int ns = ns_ids[e];
    const uint32_t s = (ns >= 0 && ns < n_ns) ? (uint32_t)ns : (uint32_t)n_ns;
    keys[e] = s;
    idx[e] = e;
    radix::count_key(s, 0, ndig, s_hist);
  }
  radix::flush_counts(s_hist, ndig, 0, tile, tiles, hist, counts);
  const size_t step = (size_t)tiles * THREADS;
  const size_t cells = (size_t)n_ns * r_dims;
  for (size_t i = (size_t)tile * THREADS + threadIdx.x; i < cells; i += step) wave_used[i] = 0;
  const size_t aggs = (size_t)((b_n + SCAN_TILE - 1) / SCAN_TILE) * r_dims;
  for (size_t i = (size_t)tile * THREADS + threadIdx.x; i < aggs; i += step) tagg[i] = 0;
}

// per tile of the sorted order: first and last segment, and the demand of
// the last segment's rows in the tile (0 for the pad segment), summed by
// warps and added atomically (those rows are the tile's suffix: the warps
// before it skip)
__global__ void __launch_bounds__(THREADS) admit_tiles_kernel(
    const uint32_t* __restrict__ keys_all, const int32_t* __restrict__ idx_all,
    const uint32_t* __restrict__ hist, const int64_t* __restrict__ demand, int b_n, int n_ns,
    int ndig, int r_dims, int32_t* __restrict__ tinfo, int64_t* __restrict__ tagg) {
  const int buf = radix::sorted_buffer(radix::plan_mask(hist, b_n, ndig, 0));
  const uint32_t* skeys = keys_all + (size_t)buf * b_n;
  const int32_t* sidx = idx_all + (size_t)buf * b_n;
  const int tile = blockIdx.x, lane = threadIdx.x & 31;
  const int p0 = tile * SCAN_TILE;
  const int p1 = min(p0 + SCAN_TILE, b_n);
  const uint32_t first = skeys[p0], last = skeys[p1 - 1];
  if (threadIdx.x == 0) {
    tinfo[2 * tile] = (int32_t)first;
    tinfo[2 * tile + 1] = (int32_t)last;
  }
  int row[SCAN_ITEMS];
  bool in_last[SCAN_ITEMS], any = false;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int p = p0 + threadIdx.x * SCAN_ITEMS + j;
    in_last[j] = p < p1 && skeys[p] == last && last < (uint32_t)n_ns;
    row[j] = in_last[j] ? sidx[p] : 0;
    any = any || in_last[j];
  }
  if (!__any_sync(0xffffffffu, any)) return;
  u64* agg = reinterpret_cast<u64*>(tagg) + (size_t)tile * r_dims;
  for (int r0 = 0; r0 < r_dims; r0 += DT) {
    u64 x[DT];
#pragma unroll
    for (int k = 0; k < DT; ++k) x[k] = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        if (in_last[j] && r0 + k < r_dims) x[k] += (u64)demand[(size_t)row[j] * r_dims + r0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < DT; ++k) {
      const u64 w = radix::warp_sum(x[k]);
      if (lane == 0 && w && r0 + k < r_dims) atomicAdd(agg + r0 + k, w);
    }
  }
}

__global__ void __launch_bounds__(THREADS) admit_kernel(
    const uint32_t* __restrict__ keys_all, const int32_t* __restrict__ idx_all,
    const uint32_t* __restrict__ hist, const int64_t* __restrict__ demand,
    const int64_t* __restrict__ remaining, const int32_t* __restrict__ tinfo,
    const int64_t* __restrict__ tagg, int b_n, int n_ns, int ndig, int r_dims,
    uint8_t* __restrict__ admitted, int64_t* __restrict__ wave_used) {
  __shared__ int s_stop;
  __shared__ u64 s_carry[2][DT];  // by the parity of the tile of dims
  const int buf = radix::sorted_buffer(radix::plan_mask(hist, b_n, ndig, 0));
  const uint32_t* skeys = keys_all + (size_t)buf * b_n;
  const int32_t* sidx = idx_all + (size_t)buf * b_n;
  const int tile = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tile * SCAN_TILE;
  const int p1 = min(p0 + SCAN_TILE, b_n);
  const uint32_t k0 = skeys[p0];

  // the tiles before this one that hold rows of segment k0: back from
  // tile - 1 while a tile is all k0 (predecessor j = tile - 1 - j back);
  // the first one that is not adds its last segment's demand if that is
  // k0, and ends the segment's carry
  if (tid == 0) s_stop = tile;
  __syncthreads();
  if (tid < tile) {
    const int pred = tile - 1 - tid;
    const bool all_k0 = (uint32_t)tinfo[2 * pred + 1] == k0 && (uint32_t)tinfo[2 * pred] == k0;
    if (!all_k0) atomicMin(&s_stop, tid);
  }
  __syncthreads();
  const int stop = s_stop;

  uint32_t key[SCAN_ITEMS];
  int row[SCAN_ITEMS];
  bool valid[SCAN_ITEMS], head[SCAN_ITEMS], live[SCAN_ITEMS], ok[SCAN_ITEMS], tail[SCAN_ITEMS];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int p = p0 + tid * SCAN_ITEMS + j;
    valid[j] = p < p1;
    key[j] = valid[j] ? skeys[p] : 0xffffffffu;
    row[j] = valid[j] ? sidx[p] : 0;
    // a segment's first position (not a tile's: the carry continues it)
    head[j] = valid[j] && (p == 0 || skeys[p - 1] != key[j]);
    live[j] = valid[j] && key[j] < (uint32_t)n_ns;  // the pad segment is admitted
    ok[j] = true;
  }
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {  // a run's last position in the tile
    const int p = p0 + tid * SCAN_ITEMS + j;
    const uint32_t next =
        j + 1 < SCAN_ITEMS ? key[j + 1] : (p + 1 < p1 ? skeys[p + 1] : 0xffffffffu);
    tail[j] = live[j] && (p + 1 >= p1 || next != key[j]);
  }

  int parity = 0;
  for (int r0 = 0; r0 < r_dims; r0 += DT, parity ^= 1) {
    // warp 0: the carry into this tile's first segment; the block scan's
    // barriers below publish it, and the other parity's slot is written
    // only after every thread has passed the next block scan
    if (warp == 0) {
      u64 c[DT];
#pragma unroll
      for (int k = 0; k < DT; ++k) c[k] = 0;
      if (k0 < (uint32_t)n_ns) {
        for (int j = lane; j <= stop && j < tile; j += 32) {
          const int pred = tile - 1 - j;
          if ((uint32_t)tinfo[2 * pred + 1] != k0) continue;
#pragma unroll
          for (int k = 0; k < DT; ++k) {
            if (r0 + k < r_dims) c[k] += (u64)tagg[(size_t)pred * r_dims + r0 + k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        c[k] = radix::warp_sum(c[k]);
        if (lane == 0) s_carry[parity][k] = c[k];
      }
    }
    // the segmented inclusive sums of this thread's positions
    u64 incl[SCAN_ITEMS][DT];
    Seg<DT> x = radix::seg_identity<DT>();
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (head[j]) {
        x = radix::seg_identity<DT>();
        x.f = 1;
      }
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        if (live[j] && r0 + k < r_dims) x.s[k] += (u64)demand[(size_t)row[j] * r_dims + r0 + k];
        incl[j][k] = x.s[k];
      }
    }
    Seg<DT> total;
    const Seg<DT> pre = radix::block_seg_scan(x, &total);
    bool seen = false;  // a head at or before position j of this thread
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      seen = seen || head[j];
      if (!live[j]) continue;
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        if (r0 + k >= r_dims) continue;
        u64 v = incl[j][k];
        if (!seen) v += pre.s[k] + (pre.f ? 0ull : s_carry[parity][k]);
        ok[j] = ok[j] && (long long)v <= remaining[(size_t)key[j] * r_dims + r0 + k];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (valid[j]) admitted[row[j]] = (!live[j] || ok[j]) ? 1 : 0;
  }

  // wave_used: the admitted demand of each segment run of each warp's
  // positions, one atomic add a run and dim (a warp-wide segmented scan;
  // a run crossing into the next warp is added by both, in parts)
  for (int r0 = 0; r0 < r_dims; r0 += DT) {
    u64 incl[SCAN_ITEMS][DT];
    Seg<DT> x = radix::seg_identity<DT>();
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (head[j]) {
        x = radix::seg_identity<DT>();
        x.f = 1;
      }
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        if (live[j] && ok[j] && r0 + k < r_dims) {
          x.s[k] += (u64)demand[(size_t)row[j] * r_dims + r0 + k];
        }
        incl[j][k] = x.s[k];
      }
    }
    Seg<DT> pre = radix::seg_shfl_up(radix::warp_seg_incl(x), 1);
    if (lane == 0) pre = radix::seg_identity<DT>();
    bool seen = false;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      seen = seen || head[j];
      if (!(tail[j] || (live[j] && lane == 31 && j == SCAN_ITEMS - 1))) continue;
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        if (r0 + k >= r_dims) continue;
        const u64 v = seen ? incl[j][k] : incl[j][k] + pre.s[k];
        if (v) {
          atomicAdd(reinterpret_cast<u64*>(wave_used) + (size_t)key[j] * r_dims + r0 + k, v);
        }
      }
    }
  }
}

}  // namespace

// admitted uint8[B], wave_used int64[N, R] = quota_admit(ns_ids, demand,
// remaining), for any N and R; B <= 2^17 (the wrapper checks)
extern "C" int quota_admit_launch(const int32_t* ns_ids, const int64_t* demand,
                                  const int64_t* remaining, int b_n, int n_ns, int r_dims,
                                  uint8_t* admitted, int64_t* wave_used, uint32_t* keys,
                                  int32_t* idx, uint32_t* counts, int32_t* tinfo,
                                  int64_t* tagg, int ndig, cudaStream_t stream) {
  const int tiles = (b_n + TILE - 1) / TILE;
  const int scan_tiles = (b_n + SCAN_TILE - 1) / SCAN_TILE;
  if (b_n < 0 || n_ns < 0 || r_dims < 0 || scan_tiles > THREADS || ndig < 1 || ndig > 4 ||
      (ndig < 4 && ((long long)n_ns >> (8 * ndig)) != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b_n == 0) {
    cudaMemsetAsync(wave_used, 0, (size_t)n_ns * r_dims * sizeof(int64_t), stream);
    return (int)cudaGetLastError();
  }
  uint32_t* hist = counts;
  uint32_t* tile_counts = counts + (size_t)ndig * BINS;
  cudaMemsetAsync(counts, 0, ((size_t)ndig * BINS + (size_t)ndig * tiles * BINS) * sizeof(uint32_t),
                  stream);
  admit_keys_kernel<<<tiles, THREADS, 0, stream>>>(ns_ids, b_n, n_ns, ndig, r_dims, keys, idx,
                                                   hist, tile_counts, wave_used, tagg);
  radix::sort_pairs(keys, idx, hist, tile_counts, b_n, ndig, 0u, 1, stream);
  admit_tiles_kernel<<<scan_tiles, THREADS, 0, stream>>>(keys, idx, hist, demand, b_n, n_ns,
                                                         ndig, r_dims, tinfo, tagg);
  admit_kernel<<<scan_tiles, THREADS, 0, stream>>>(keys, idx, hist, demand, remaining, tinfo,
                                                   tagg, b_n, n_ns, ndig, r_dims, admitted,
                                                   wave_used);
  return (int)cudaGetLastError();
}
