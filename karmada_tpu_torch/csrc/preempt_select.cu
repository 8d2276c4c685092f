// K15 preempt_select: plane-wide victim selection of one preemption pass,
// and the capacity the victims free per cluster.
//
// Replaces karmada_tpu/ops/preempt.py:72 preempt_select (the victim
// selection of karmada_tpu/scheduler/core.py:1027 _preempt_pass).
//
//   in:  prio int32[B], demand int64[B, R], freed int64[B, R],
//        victim_ok uint8[B] (bool), weight int32[B], assigned int32[B, C],
//        requests int64[B, R]
//   out: victims uint8[B] (bool), freed_caps int64[C, R]
//   scratch (the wrapper allocates it): keys uint64[2][2][B], idx
//        int32[2][2][B], counts uint32[2 * 8 * 256 * (1 + tiles) + 1],
//        d_in uint64[R][B], tsum uint64[2][scan_tiles][R], sel int32[B];
//        tiles = ceil(B / 2048), scan_tiles = ceil(B / 1024)
//   b_key: the row count the packed keys are built with (>= B): the JAX
//        program's padded row count, so that a wrapping key wraps as there
//
// The rule, as the JAX program computes it:
//  - demand_gt(q) = the total demand of the rows whose priority is > q. JAX
//    sorts the rows by the key -(prio * B) - (B - 1 - row) (prio desc, then
//    row asc; no int64 wrap for an int32 prio and B <= 2^17), takes the
//    exclusive prefix sums of demand in that order and, per victim, the
//    first position whose prio <= q (searchsorted): that prefix is
//    demand_gt(q), or the whole sum when no such position exists.
//  - the victims are sorted by the packed key
//      v_prio * ((MAX_WEIGHT + 1) * B) + (MAX_WEIGHT - clip(weight)) * B + row
//    with v_prio = prio for an eligible victim and MAX_PRIORITY + 1 for
//    every other row (prio asc, weight desc, row asc); cum_excl is the
//    exclusive prefix sum of freed in that order, over every row.
//  - a row is a victim iff it is eligible and some dim has freed > 0 and
//    cum_excl < demand_gt(prio).
//  - freed_caps[c, r] = sum over victims of assigned[b, c] * requests[b, r].
// Every int64 sum and product wraps modulo 2^64 as in JAX (unsigned
// arithmetic, reinterpreted); the packed key wraps too when a priority
// reaches 2^20, and is computed the same way (not repaired). JAX's argsort
// is stable, so both sorts order by (key, row): equal keys keep row order.
//
// Launches, all on the caller's stream:
//  1. keys: per row the d key ~(prio ^ 2^31) << 32 (prio descending is its
//     ascending order; the row tiebreak comes from the sort's stability;
//     in the high half it shares the v key's passes) and the v key with
//     its sign bit flipped (the signed order of the wrapped int64 key is
//     then the unsigned order), the sort's digit counts of both, freed_caps
//     zeroed.
//  2. a stable LSD radix sort of both (key, row) arrays at once (grid.y;
//     radix_sort.cuh): one launch per 8-bit digit from the lowest an array
//     needs, a digit equal in every key skipped, and where b_key is 2^k
//     the v key's digits below bit k too (they only repeat the row order
//     the sort keeps): 6 launches at b_key 2^17; with 16 priority classes
//     there the d key takes one pass, the v key four.
//  3. tiles: per 1024-position tile, the demand in d order scanned within
//     the tile (d_in) and its tile sums, and the tile sums of freed in v
//     order; dims DT at a time.
//  4. select: per tile of the v order, the tile sums of both orders scanned
//     by one warp into shared memory (the carry of the freed scan; the base
//     of each d tile), the in-tile scan of freed; per position the first d
//     position whose prio <= its own (a binary search of the sorted d keys,
//     a thread's searches in step), so
//     demand_gt = the d tile's base + d_in there; the verdict, the flag
//     written through the stored row, and the victims appended to a list
//     (warp ballots and one atomic a warp: the list's order is free, since
//     the product's sums are exact in any order).
//  5. freed_caps: blocks stride over the list of victims, one victim's
//     row of assigned at a time, read coalesced with eight cells a thread
//     in flight (the bytes, not the few non-zero cells, bound it); each
//     non-zero cell adds assigned * request to its cluster's sums
//     atomically, every dim (addition modulo 2^64 is exact in any order).
//
// What bounds it on an H100: latency, not bytes. The selection's inputs are
// at most 2^17 rows of ~60 bytes (8 MB, a few microseconds at HBM rate);
// the launches above are about 13, each over at most 128 blocks, and the
// freed-capacity product reads only the victims' rows of assigned.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix_sort.cuh"

namespace {

using radix::BINS;
using radix::ITEMS;
using radix::MAX_DIGITS;
using radix::SCAN_ITEMS;
using radix::SCAN_TILE;
using radix::Seg;
using radix::THREADS;
using radix::TILE;
typedef unsigned long long u64;

constexpr long long MAX_PRIORITY = (1LL << 20) - 1;
constexpr long long MAX_WEIGHT = (1LL << 20) - 1;
constexpr int DT = 4;           // dims a scan carries in registers
constexpr int CAP_THREADS = 256;  // the freed-capacity product's block
constexpr int CAP_UNROLL = 8;     // cells a thread of it loads at once
constexpr int CAP_GRID = 2048;    // its blocks at most, striding over the victims
constexpr int SAMPLES = 2048;  // chunks of the sorted d keys a select block holds

// prio descending as an ascending key, in the high half: its digits share
// the v key's passes (radix positions 4-7)
__device__ __forceinline__ u64 d_key(int32_t prio) {
  return (u64)((uint32_t)prio ^ 0x7fffffffu) << 32;
}

__global__ void __launch_bounds__(THREADS) preempt_keys_kernel(
    const int32_t* __restrict__ prio, const uint8_t* __restrict__ victim_ok,
    const int32_t* __restrict__ weight, int b_n, int b_key, u64* __restrict__ keys,
    int32_t* __restrict__ idx, uint32_t* __restrict__ hist, uint32_t* __restrict__ counts,
    unsigned firsts, int c_n, int r_n, int64_t* __restrict__ freed_caps) {
  __shared__ uint32_t s_hist[2][MAX_DIGITS * BINS];
  for (int i = threadIdx.x; i < 2 * MAX_DIGITS * BINS; i += THREADS) (&s_hist[0][0])[i] = 0;
  __syncthreads();
  const int tile = blockIdx.x, tiles = gridDim.x;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tile * TILE + it * THREADS + threadIdx.x;
    if (e >= b_n) continue;
    const long long p = prio[e];
    const long long b = b_key;
    long long w = weight[e];
    w = w < 0 ? 0 : (w > MAX_WEIGHT ? MAX_WEIGHT : w);
    const long long vp = victim_ok[e] ? p : MAX_PRIORITY + 1;
    const u64 vkey = (u64)vp * (u64)((MAX_WEIGHT + 1) * b) + (u64)(MAX_WEIGHT - w) * (u64)b +
                     (u64)e;
    const u64 dk = d_key(prio[e]);
    const u64 vk = vkey ^ (1ull << 63);
    keys[e] = dk;                       // array 0 (d), buffer 0
    keys[(size_t)2 * b_n + e] = vk;     // array 1 (v), buffer 0
    idx[e] = e;
    idx[(size_t)2 * b_n + e] = e;
    radix::count_key(dk, radix::first_of(firsts, 0), MAX_DIGITS, s_hist[0]);
    radix::count_key(vk, radix::first_of(firsts, 1), MAX_DIGITS, s_hist[1]);
  }
  for (int y = 0; y < 2; ++y) {
    radix::flush_counts(s_hist[y], MAX_DIGITS, radix::first_of(firsts, y), tile, tiles,
                        hist + (size_t)y * MAX_DIGITS * BINS,
                        counts + (size_t)y * MAX_DIGITS * tiles * BINS);
  }
  const size_t cells = (size_t)c_n * r_n;
  for (size_t i = (size_t)tile * THREADS + threadIdx.x; i < cells; i += (size_t)tiles * THREADS) {
    freed_caps[i] = 0;
  }
}

// y = 0: demand in d order, scanned within the tile (d_in[r][pos]) and
// summed (tsum[0][tile][r]); y = 1: freed in v order, summed (tsum[1])
__global__ void __launch_bounds__(THREADS) preempt_tiles_kernel(
    const u64* __restrict__ keys, const int32_t* __restrict__ idx,
    const uint32_t* __restrict__ hist, unsigned firsts, const int64_t* __restrict__ demand,
    const int64_t* __restrict__ freed, int b_n, int r_n, u64* __restrict__ d_in,
    u64* __restrict__ tsum) {
  const int y = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int buf = radix::sorted_buffer(radix::plan_mask(
      hist + (size_t)y * MAX_DIGITS * BINS, b_n, MAX_DIGITS, radix::first_of(firsts, y)));
  const int32_t* sidx = idx + ((size_t)y * 2 + buf) * b_n;
  const int64_t* src = y == 0 ? demand : freed;
  const int p0 = tile * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int row[SCAN_ITEMS];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) row[j] = p0 + j < b_n ? sidx[p0 + j] : -1;
  for (int r0 = 0; r0 < r_n; r0 += DT) {
    u64 x[SCAN_ITEMS][DT];
    Seg<DT> t = radix::seg_identity<DT>();
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        x[j][k] = row[j] >= 0 && r0 + k < r_n ? (u64)src[(size_t)row[j] * r_n + r0 + k] : 0;
        t.s[k] += x[j][k];
      }
    }
    Seg<DT> total;
    const Seg<DT> pre = radix::block_seg_scan(t, &total);
    if (y == 0) {
      u64 run[DT];
#pragma unroll
      for (int k = 0; k < DT; ++k) run[k] = pre.s[k];
#pragma unroll
      for (int j = 0; j < SCAN_ITEMS; ++j) {
#pragma unroll
        for (int k = 0; k < DT; ++k) {
          if (row[j] >= 0 && r0 + k < r_n) d_in[(size_t)(r0 + k) * b_n + p0 + j] = run[k];
          run[k] += x[j][k];
        }
      }
    }
    if (threadIdx.x < DT && r0 + threadIdx.x < r_n) {
      tsum[((size_t)y * tiles + tile) * r_n + r0 + threadIdx.x] = total.s[threadIdx.x];
    }
  }
}

__global__ void __launch_bounds__(THREADS) preempt_select_kernel(
    const int32_t* __restrict__ prio, const int64_t* __restrict__ freed,
    const uint8_t* __restrict__ victim_ok, const u64* __restrict__ keys,
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ hist, unsigned firsts,
    const u64* __restrict__ d_in, const u64* __restrict__ tsum, int b_n, int r_n,
    uint8_t* __restrict__ victims, int32_t* __restrict__ sel, uint32_t* __restrict__ sel_count) {
  __shared__ u64 s_dbase[THREADS + 1][DT];  // exclusive sums of the d tiles; [tiles] = total
  __shared__ u64 s_vcarry[DT];              // freed in v order before this tile
  __shared__ u64 s_sample[SAMPLES];         // the last d key of each chunk
  const int tile = blockIdx.x, tiles = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31;
  const int buf_d =
      radix::sorted_buffer(radix::plan_mask(hist, b_n, MAX_DIGITS, radix::first_of(firsts, 0)));
  const int buf_v = radix::sorted_buffer(radix::plan_mask(
      hist + (size_t)MAX_DIGITS * BINS, b_n, MAX_DIGITS, radix::first_of(firsts, 1)));
  const u64* dkeys = keys + (size_t)buf_d * b_n;
  const int32_t* vidx = idx + ((size_t)2 + buf_v) * b_n;
  const u64* tsum_d = tsum;
  const u64* tsum_v = tsum + (size_t)tiles * r_n;

  const int p0 = tile * SCAN_TILE + tid * SCAN_ITEMS;
  int row[SCAN_ITEMS], pos[SCAN_ITEMS];
  u64 want[SCAN_ITEMS];
  bool sel_any[SCAN_ITEMS];
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    row[j] = p0 + j < b_n ? vidx[p0 + j] : -1;
    sel_any[j] = false;
    pos[j] = 0;
    want[j] = row[j] >= 0 ? d_key(prio[row[j]]) : 0;
  }
  // the first d position whose prio <= each row's (d keys >= its own): the
  // chunk from a sample of the sorted d keys in shared memory (each
  // chunk's last key), then a branchless lower bound in the chunk, the
  // SCAN_ITEMS searches in step so their loads are in flight together
  const int stride = (b_n + SAMPLES - 1) / SAMPLES;
  const int chunks = (b_n + stride - 1) / stride;
  for (int i = tid; i < chunks; i += THREADS) {
    s_sample[i] = dkeys[min((i + 1) * stride, b_n) - 1];
  }
  __syncthreads();
  int len = stride;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    int lo = 0, hi = chunks;  // the first chunk whose last key >= want
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_sample[mid] >= want[j]) hi = mid;
      else lo = mid + 1;
    }
    pos[j] = min(lo * stride, b_n);  // b_n when every key is below want
  }
  for (; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (pos[j] + half < b_n && dkeys[pos[j] + half] < want[j]) pos[j] += half;
    }
    len -= half;
  }
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) pos[j] += pos[j] < b_n && dkeys[pos[j]] < want[j] ? 1 : 0;

  for (int r0 = 0; r0 < r_n; r0 += DT) {
    // warp 0: the d tiles' exclusive sums (and their total) and this v
    // tile's carry; the block scan's barriers below publish them
    if (tid < 32) {
      u64 run[DT], vc[DT];
#pragma unroll
      for (int k = 0; k < DT; ++k) run[k] = vc[k] = 0;
      for (int t0 = 0; t0 < tiles; t0 += 32) {
        const int t = t0 + lane;
#pragma unroll
        for (int k = 0; k < DT; ++k) {
          const bool in = t < tiles && r0 + k < r_n;
          const u64 x = in ? tsum_d[(size_t)t * r_n + r0 + k] : 0;
          if (in && t < tile) vc[k] += tsum_v[(size_t)t * r_n + r0 + k];
          u64 incl = x;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const u64 y = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += y;
          }
          if (t < tiles) s_dbase[t][k] = run[k] + incl - x;
          run[k] += __shfl_sync(0xffffffffu, incl, 31);
        }
      }
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        vc[k] = radix::warp_sum(vc[k]);
        if (lane == 0) {
          s_dbase[tiles][k] = run[k];
          s_vcarry[k] = vc[k];
        }
      }
    }
    // the in-tile exclusive sums of freed in v order
    u64 x[SCAN_ITEMS][DT];
    Seg<DT> t = radix::seg_identity<DT>();
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        x[j][k] = row[j] >= 0 && r0 + k < r_n ? (u64)freed[(size_t)row[j] * r_n + r0 + k] : 0;
        t.s[k] += x[j][k];
      }
    }
    Seg<DT> total;
    const Seg<DT> pre = radix::block_seg_scan(t, &total);  // its barriers publish warp 0's
    u64 cum[DT];
#pragma unroll
    for (int k = 0; k < DT; ++k) cum[k] = s_vcarry[k] + pre.s[k];
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
#pragma unroll
      for (int k = 0; k < DT; ++k) {
        if (row[j] >= 0 && r0 + k < r_n) {
          const u64 d_gt =
              pos[j] < b_n ? s_dbase[pos[j] / SCAN_TILE][k] + d_in[(size_t)(r0 + k) * b_n + pos[j]]
                           : s_dbase[tiles][k];
          if ((long long)x[j][k] > 0 && (long long)cum[k] < (long long)d_gt) sel_any[j] = true;
        }
        cum[k] += x[j][k];
      }
    }
    __syncthreads();  // s_dbase and s_vcarry are rewritten by the next tile of dims
  }

#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const bool s = row[j] >= 0 && sel_any[j] && victim_ok[row[j]];
    if (row[j] >= 0) victims[row[j]] = s ? 1 : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, s);
    if (!ballot) continue;
    uint32_t base = 0;
    if (lane == 0) base = atomicAdd(sel_count, (uint32_t)__popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (s) sel[base + __popc(ballot & ((1u << lane) - 1))] = row[j];
  }
}

// one victim row at a time a block, its cells read coalesced, CAP_UNROLL
// a thread in flight; a non-zero cell adds assigned * request to its
// cluster's R sums (victims hold few clusters: the atomics are few)
__global__ void __launch_bounds__(CAP_THREADS) freed_caps_kernel(
    const int32_t* __restrict__ sel, const uint32_t* __restrict__ sel_count,
    const int32_t* __restrict__ assigned, const int64_t* __restrict__ requests, int r_n,
    int c_n, int64_t* __restrict__ freed_caps) {
  const int n_sel = (int)*sel_count;
  for (int i = blockIdx.x; i < n_sel; i += gridDim.x) {
    const int row = sel[i];
    const int32_t* a_row = assigned + (size_t)row * c_n;
    const int64_t* req = requests + (size_t)row * r_n;
    for (int c0 = 0; c0 < c_n; c0 += CAP_THREADS * CAP_UNROLL) {
      int32_t a[CAP_UNROLL];
#pragma unroll
      for (int u = 0; u < CAP_UNROLL; ++u) {
        const int c = c0 + u * CAP_THREADS + threadIdx.x;
        a[u] = c < c_n ? a_row[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < CAP_UNROLL; ++u) {
        if (a[u] == 0) continue;
        const size_t cell = (size_t)(c0 + u * CAP_THREADS + threadIdx.x) * r_n;
        for (int r = 0; r < r_n; ++r) {
          const u64 v = (u64)(long long)a[u] * (u64)req[r];
          if (v) atomicAdd(reinterpret_cast<u64*>(freed_caps) + cell + r, v);
        }
      }
    }
  }
}

}  // namespace

// victims uint8[B], freed_caps int64[C, R] = preempt_select(...), for any R;
// 1 <= B <= b_key <= 2^17 (the wrapper checks)
extern "C" int preempt_select_launch(const int32_t* prio, const int64_t* demand,
                                     const int64_t* freed, const uint8_t* victim_ok,
                                     const int32_t* weight, const int32_t* assigned,
                                     const int64_t* requests, int b_n, int b_key, int r_n,
                                     int c_n, uint8_t* victims, int64_t* freed_caps, u64* keys,
                                     int32_t* idx, uint32_t* counts, u64* d_in, u64* tsum,
                                     int32_t* sel, cudaStream_t stream) {
  const int tiles = (b_n + TILE - 1) / TILE;
  const int scan_tiles = (b_n + SCAN_TILE - 1) / SCAN_TILE;
  if (b_n < 1 || b_key < b_n || r_n < 0 || c_n < 0 || scan_tiles > THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  uint32_t* hist = counts;                                  // [2][8][BINS]
  uint32_t* tile_counts = counts + 2 * MAX_DIGITS * BINS;   // [2][8][tiles][BINS]
  uint32_t* sel_count = tile_counts + (size_t)2 * MAX_DIGITS * tiles * BINS;
  // b_key = 2^k: the v key is the row plus a multiple of 2^k, so its digits
  // wholly below bit k only repeat the row order (radix_sort.cuh)
  const int k = (b_key & (b_key - 1)) == 0 ? __builtin_ctz((unsigned)b_key) : 0;
  const unsigned firsts = 4u | (unsigned)(k / radix::BITS) << 4;  // d key: 4; v key: k / 8
  cudaMemsetAsync(counts, 0,
                  ((size_t)2 * MAX_DIGITS * BINS * (1 + tiles) + 1) * sizeof(uint32_t), stream);
  preempt_keys_kernel<<<tiles, THREADS, 0, stream>>>(prio, victim_ok, weight, b_n, b_key, keys,
                                                     idx, hist, tile_counts, firsts, c_n, r_n,
                                                     freed_caps);
  radix::sort_pairs(keys, idx, hist, tile_counts, b_n, MAX_DIGITS, firsts, 2, stream);
  preempt_tiles_kernel<<<dim3(scan_tiles, 2), THREADS, 0, stream>>>(
      keys, idx, hist, firsts, demand, freed, b_n, r_n, d_in, tsum);
  preempt_select_kernel<<<scan_tiles, THREADS, 0, stream>>>(prio, freed, victim_ok, keys, idx,
                                                            hist, firsts, d_in, tsum, b_n, r_n,
                                                            victims, sel, sel_count);
  if (c_n > 0 && r_n > 0) {
    freed_caps_kernel<<<b_n < CAP_GRID ? b_n : CAP_GRID, CAP_THREADS, 0, stream>>>(
        sel, sel_count, assigned, requests, r_n, c_n, freed_caps);
  }
  return (int)cudaGetLastError();
}
