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
//   scratch (the wrapper allocates it): keys int64[2, N2], idx int32[2, N2],
//        excl int64[2, R, N2], tile_sums int64[2, R, N2 / 1024 + 1]
//        with N2 = max(2048, the power of two >= B)
//   b_key: the row count the packed keys are built with (>= B): the JAX
//        program's padded row count, so that a wrapping key wraps as there
//
// The rule, as the JAX program computes it:
//  - demand_gt(q) = the total demand of the rows whose priority is > q. JAX
//    sorts the rows by the key -(prio * B) - (B - 1 - row) (prio desc, then
//    row asc), takes the exclusive prefix sums of demand in that order and,
//    per victim, the first position whose prio <= q (searchsorted): that
//    prefix is demand_gt(q), or the whole sum when no such position exists.
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
//  1. keys: both sort keys per row; rows past B get the largest key and an
//     index past B, so they sort last.
//  2. a bitonic sort of (key, index) pairs, both arrays at once (grid.y):
//     one launch sorts every 2048-element tile in shared memory; then per
//     merge size the strides >= 2048 run as one global compare-exchange
//     launch each and the strides < 2048 as one shared-memory launch.
//     N2 = 2^17 takes 28 launches.
//  3. a two-level scan: per 1024-element tile a block-wide exclusive scan
//     (warp shuffles) of the demand (in d order) and of freed (in v order),
//     per dim, with the tile's total; then one block scans the tile totals.
//  4. select: one thread per sorted victim position binary-searches the d
//     order for the first prio <= its own, adds the tile offsets and
//     writes its row's flag.
//  5. freed_caps: zeroed, then blocks of (256 clusters x 512 rows) skip the
//     rows that were not selected (a warp-uniform branch), accumulate
//     assigned * requests in registers and add their sums atomically
//     (addition modulo 2^64 is exact in any order).
//
// What bounds it on an H100: latency, not bytes. The selection's inputs are
// at most 2^17 rows of ~60 bytes (8 MB, a few microseconds at HBM rate);
// the ~34 dependent launches of the sort and scans cost some microseconds
// each. The freed-capacity product reads only the selected rows' assigned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long MAX_PRIORITY = (1LL << 20) - 1;
constexpr long long MAX_WEIGHT = (1LL << 20) - 1;
constexpr int SORT_TILE = 2048;  // elements a shared-memory sort block holds
constexpr int SORT_THREADS = SORT_TILE / 2;
constexpr int SCAN_TILE = 1024;
constexpr int SCAN_WARPS = SCAN_TILE / 32;
constexpr int MAX_R = 16;
constexpr int CAP_COLS = 256;
constexpr int CAP_ROWS = 512;
typedef unsigned long long u64;

__device__ __forceinline__ bool greater(long long ka, int ia, long long kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

__global__ void keys_kernel(const int32_t* __restrict__ prio,
                            const uint8_t* __restrict__ victim_ok,
                            const int32_t* __restrict__ weight, int b_n, int b_key,
                            int n2, long long* __restrict__ keys,
                            int32_t* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  long long dkey = 0x7fffffffffffffffLL, vkey = 0x7fffffffffffffffLL;
  if (i < b_n) {
    const long long p = prio[i];
    const long long b = b_key;
    dkey = -(p * b) - (b - 1 - i);
    long long w = weight[i];
    w = w < 0 ? 0 : (w > MAX_WEIGHT ? MAX_WEIGHT : w);
    const long long vp = victim_ok[i] ? p : MAX_PRIORITY + 1;
    const u64 k = (u64)vp * (u64)((MAX_WEIGHT + 1) * b) + (u64)(MAX_WEIGHT - w) * (u64)b + (u64)i;
    vkey = (long long)k;
  }
  keys[i] = dkey;
  keys[n2 + i] = vkey;
  idx[i] = i;
  idx[n2 + i] = i;
}

// one compare-exchange of positions a < b for merge size ``size``
__device__ __forceinline__ void cmp_swap(long long* key, int32_t* id, int a, int b, bool up) {
  const long long ka = key[a], kb = key[b];
  const int ia = id[a], ib = id[b];
  if (greater(ka, ia, kb, ib) == up) {
    key[a] = kb;
    key[b] = ka;
    id[a] = ib;
    id[b] = ia;
  }
}

// the strides < SORT_TILE of merge sizes ``size_lo`` .. ``size_hi`` over one
// tile held in shared memory (size_lo == 2: the full local sort)
__global__ void sort_shared_kernel(long long* __restrict__ keys, int32_t* __restrict__ idx,
                                   int n2, int size_lo, int size_hi) {
  __shared__ long long sk[SORT_TILE];
  __shared__ int32_t si[SORT_TILE];
  long long* key = keys + (size_t)blockIdx.y * n2;
  int32_t* id = idx + (size_t)blockIdx.y * n2;
  const int tile = blockIdx.x * SORT_TILE;
  for (int t = threadIdx.x; t < SORT_TILE; t += SORT_THREADS) {
    sk[t] = key[tile + t];
    si[t] = id[tile + t];
  }
  __syncthreads();
  for (int size = size_lo; size <= size_hi; size <<= 1) {
    for (int stride = min(size, SORT_TILE) >> 1; stride > 0; stride >>= 1) {
      const int t = threadIdx.x;
      const int pos = 2 * t - (t & (stride - 1));
      const bool up = ((tile + pos) & size) == 0;
      cmp_swap(sk, si, pos, pos + stride, up);
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < SORT_TILE; t += SORT_THREADS) {
    key[tile + t] = sk[t];
    id[tile + t] = si[t];
  }
}

// one stride >= SORT_TILE of merge size ``size``, over global memory
__global__ void sort_step_kernel(long long* __restrict__ keys, int32_t* __restrict__ idx,
                                 int n2, int size, int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n2 / 2) return;
  const int pos = 2 * t - (t & (stride - 1));
  cmp_swap(keys + (size_t)blockIdx.y * n2, idx + (size_t)blockIdx.y * n2, pos, pos + stride,
           (pos & size) == 0);
}

// exclusive block-wide scan of x (modulo 2^64); the block total in *total
__device__ __forceinline__ u64 block_excl_scan(u64 x, u64* warp_sums, u64* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64 v = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    u64 w = lane < SCAN_WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < SCAN_WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  const u64 before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[SCAN_WARPS - 1];
  return before + v - x;
}

// z = 0: demand in d order; z = 1: freed in v order; one dim per blockIdx.y
__global__ void scan_tiles_kernel(const int64_t* __restrict__ demand,
                                  const int64_t* __restrict__ freed,
                                  const int32_t* __restrict__ idx, int b_n, int r_n, int n2,
                                  int n_tiles, u64* __restrict__ excl,
                                  u64* __restrict__ tile_sums) {
  __shared__ u64 warp_sums[SCAN_WARPS];
  const int z = blockIdx.z, r = blockIdx.y, tile = blockIdx.x;
  const int i = tile * SCAN_TILE + threadIdx.x;
  const int row = idx[(size_t)z * n2 + i];
  const int64_t* src = z == 0 ? demand : freed;
  const u64 x = row < b_n ? (u64)src[(size_t)row * r_n + r] : 0;
  u64 total;
  const u64 ex = block_excl_scan(x, warp_sums, &total);
  excl[((size_t)z * r_n + r) * n2 + i] = ex;
  if (threadIdx.x == 0) tile_sums[((size_t)z * r_n + r) * (n_tiles + 1) + tile] = total;
}

// exclusive scan of the tile totals in place; slot n_tiles gets the total
__global__ void scan_sums_kernel(int r_n, int n_tiles, u64* __restrict__ tile_sums) {
  __shared__ u64 warp_sums[SCAN_WARPS];
  u64* sums = tile_sums + ((size_t)blockIdx.y * r_n + blockIdx.x) * (n_tiles + 1);
  const int t = threadIdx.x;  // n_tiles <= SCAN_TILE (the wrapper checks)
  const u64 x = t < n_tiles ? sums[t] : 0;
  u64 total;
  const u64 ex = block_excl_scan(x, warp_sums, &total);
  if (t < n_tiles) sums[t] = ex;
  if (t == 0) sums[n_tiles] = total;
}

__global__ void select_kernel(const int32_t* __restrict__ prio,
                              const int64_t* __restrict__ freed,
                              const uint8_t* __restrict__ victim_ok,
                              const int32_t* __restrict__ idx, const u64* __restrict__ excl,
                              const u64* __restrict__ tile_sums, int b_n, int r_n, int n2,
                              int n_tiles, uint8_t* __restrict__ victims) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b_n) return;
  const int32_t* d_idx = idx;
  const int row = idx[n2 + i];
  const int vp = prio[row];
  // first d position whose prio <= vp (prio is non-increasing along d)
  int lo = 0, hi = b_n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (prio[d_idx[mid]] <= vp) hi = mid;
    else lo = mid + 1;
  }
  const int pos = lo;
  bool sel = false;
  if (victim_ok[row]) {
    for (int r = 0; r < r_n; ++r) {
      const u64* d_sums = tile_sums + (size_t)r * (n_tiles + 1);
      const u64* v_sums = tile_sums + ((size_t)r_n + r) * (n_tiles + 1);
      const u64 d_gt = pos < b_n
          ? excl[(size_t)r * n2 + pos] + d_sums[pos / SCAN_TILE]
          : d_sums[n_tiles];
      const u64 cum = excl[((size_t)r_n + r) * n2 + i] + v_sums[i / SCAN_TILE];
      if (freed[(size_t)row * r_n + r] > 0 && (long long)cum < (long long)d_gt) sel = true;
    }
  }
  victims[row] = sel ? 1 : 0;
}

__global__ void freed_caps_kernel(const uint8_t* __restrict__ victims,
                                  const int32_t* __restrict__ assigned,
                                  const int64_t* __restrict__ requests, int b_n, int r_n,
                                  int c_n, int64_t* __restrict__ freed_caps) {
  const int c = blockIdx.x * CAP_COLS + threadIdx.x;
  const int row0 = blockIdx.y * CAP_ROWS;
  const int row1 = min(row0 + CAP_ROWS, b_n);
  u64 acc[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) acc[r] = 0;
  bool any = false;
  for (int row = row0; row < row1; ++row) {
    if (!victims[row]) continue;  // uniform across the block
    any = true;
    if (c >= c_n) continue;
    const u64 a = (u64)(long long)assigned[(size_t)row * c_n + c];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < r_n) acc[r] += a * (u64)requests[(size_t)row * r_n + r];
    }
  }
  if (!any || c >= c_n) return;
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
    if (r < r_n && acc[r] != 0) {
      atomicAdd(reinterpret_cast<u64*>(freed_caps) + (size_t)c * r_n + r, acc[r]);
    }
  }
}

}  // namespace

// victims uint8[B], freed_caps int64[C, R] = preempt_select(...); R <= 16,
// n2 = max(2048, pow2 >= B), B <= b_key <= 2^17 (the wrapper checks)
extern "C" int preempt_select_launch(const int32_t* prio, const int64_t* demand,
                                     const int64_t* freed, const uint8_t* victim_ok,
                                     const int32_t* weight, const int32_t* assigned,
                                     const int64_t* requests, int b_n, int b_key, int r_n,
                                     int c_n, int n2, uint8_t* victims, int64_t* freed_caps,
                                     long long* keys, int32_t* idx, int64_t* excl,
                                     int64_t* tile_sums, cudaStream_t stream) {
  if (r_n < 1 || r_n > MAX_R || n2 < SORT_TILE || (n2 & (n2 - 1)) || b_n > n2 || b_key < b_n ||
      n2 / SCAN_TILE > SCAN_TILE) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = n2 / SCAN_TILE;
  u64* ex = reinterpret_cast<u64*>(excl);
  u64* sums = reinterpret_cast<u64*>(tile_sums);
  keys_kernel<<<(n2 + 255) / 256, 256, 0, stream>>>(prio, victim_ok, weight, b_n, b_key, n2,
                                                    keys, idx);
  const dim3 tiles(n2 / SORT_TILE, 2);
  sort_shared_kernel<<<tiles, SORT_THREADS, 0, stream>>>(keys, idx, n2, 2, SORT_TILE);
  for (int size = 2 * SORT_TILE; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride >= SORT_TILE; stride >>= 1) {
      sort_step_kernel<<<dim3((n2 / 2 + 255) / 256, 2), 256, 0, stream>>>(keys, idx, n2, size,
                                                                          stride);
    }
    sort_shared_kernel<<<tiles, SORT_THREADS, 0, stream>>>(keys, idx, n2, size, size);
  }
  scan_tiles_kernel<<<dim3(n_tiles, r_n, 2), SCAN_TILE, 0, stream>>>(
      demand, freed, idx, b_n, r_n, n2, n_tiles, ex, sums);
  scan_sums_kernel<<<dim3(r_n, 2), SCAN_TILE, 0, stream>>>(r_n, n_tiles, sums);
  if (b_n > 0) {
    select_kernel<<<(b_n + 255) / 256, 256, 0, stream>>>(prio, freed, victim_ok, idx, ex, sums,
                                                         b_n, r_n, n2, n_tiles, victims);
  }
  cudaMemsetAsync(freed_caps, 0, (size_t)c_n * r_n * sizeof(int64_t), stream);
  if (b_n > 0 && c_n > 0) {
    freed_caps_kernel<<<dim3((c_n + CAP_COLS - 1) / CAP_COLS, (b_n + CAP_ROWS - 1) / CAP_ROWS),
                        CAP_COLS, 0, stream>>>(victims, assigned, requests, b_n, r_n, c_n,
                                               freed_caps);
  }
  return (int)cudaGetLastError();
}
