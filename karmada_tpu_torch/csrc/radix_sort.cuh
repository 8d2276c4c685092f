// Shared device code of K12 (quota_admit.cu) and K15 (preempt_select.cu):
// a stable LSD radix sort of (key, row) pairs with 8-bit digits, and a
// block-wide segmented scan of small vectors of 64-bit sums.
//
// The sort. Keys are unsigned (u32 or u64); the caller maps its order onto
// the unsigned order. One launch of ``radix_pass_kernel`` per digit
// position; a block owns one TILE of positions and never waits on another
// block: the offsets it scatters to come from counts the launch before it
// left behind.
//  - The caller's keys kernel writes the keys and the row indices (buffer
//    0, row order), the whole-array count of every digit at every position
//    (``hist``, [ndig][BINS]) and each row-order tile's counts of the
//    digit at the array's first position (``counts[first]``,
//    [tiles][BINS]). ``hist`` and the other counts start at 0.
//  - An array's first position is 0, or higher where the caller knows the
//    digits below it only repeat the row order: a key equal to its row
//    index plus a multiple of 2^k (every row below 2^k) sorts as its bits
//    from k up alone do, since the input is in row order and the sort is
//    stable.
//  - A position whose digit is the same in every key (some bin of its
//    ``hist`` holds all n keys) is skipped: its launch returns at once and
//    the buffers do not swap. The first position always runs (it moves the
//    pairs into pass order), so a later pass never reads row order.
//  - A pass ranks its tile's pairs stably by digit (``__match_any_sync``
//    within a warp, per-warp counts in shared memory, warps in order),
//    orders them by digit in shared memory, and writes them out in that
//    order (neighbouring threads, neighbouring positions of a digit's run)
//    at the digit's whole-array base plus the counts of the tiles before
//    it. As it writes it counts the next running position's digits by
//    destination tile (``counts[q]``), which is all the next pass needs.
//  - After the passes the pairs lie in buffer popc(runs) & 1.
// Stability: each pass keeps the order it read, and the first reads row
// order, so equal keys stay in row order.
//
// The scan. ``block_seg_scan`` is the exclusive scan of one (head flag,
// DT sums) value per thread under the segmented operator
//   (f1, s1) . (f2, s2) = (f1 | f2, f2 ? s2 : s1 + s2),
// sums modulo 2^64; with no head flags it is a plain exclusive sum.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace radix {

typedef unsigned long long u64;

constexpr int BITS = 8;
constexpr int BINS = 1 << BITS;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;  // positions a block owns
constexpr int MAX_DIGITS = 8;          // a u64 key
static_assert(THREADS == 2 * BINS, "a pass sums its tile offsets two threads a digit");
constexpr int SCAN_ITEMS = 2;                    // positions a thread of a scan owns
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;  // positions a scan block owns

template <typename K>
__device__ __forceinline__ unsigned digit(K key, int d) {
  return (unsigned)(key >> (d * BITS)) & (BINS - 1);
}

// bit d set: position d runs (``first`` always; a later one unless one bin
// of its hist holds all n keys). Every thread of the block must call it.
__device__ __forceinline__ unsigned plan_mask(const uint32_t* __restrict__ hist, int n,
                                              int ndig, int first) {
  __shared__ int s_uniform[MAX_DIGITS];
  if (threadIdx.x < MAX_DIGITS) s_uniform[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < ndig * BINS; i += blockDim.x) {
    if (hist[i] == (uint32_t)n) s_uniform[i / BINS] = 1;
  }
  __syncthreads();
  unsigned mask = 1u << first;
  for (int d = first + 1; d < ndig; ++d) {
    if (!s_uniform[d]) mask |= 1u << d;
  }
  __syncthreads();  // s_uniform is reused by the next call
  return mask;
}

// the buffer (0 or 1) that holds the pairs after every pass of ``mask``
__device__ __forceinline__ int sorted_buffer(unsigned mask) { return __popc(mask) & 1; }

// keys kernels: count one key's digits from position ``first`` up into the
// block's shared counts [ndig][BINS]
template <typename K>
__device__ __forceinline__ void count_key(K key, int first, int ndig, uint32_t* s_hist) {
  for (int d = first; d < ndig; ++d) atomicAdd(&s_hist[d * BINS + digit(key, d)], 1u);
}

// keys kernels: after every key of row-order tile ``tile`` is counted, add
// the block's counts to hist and store its counts of the first position's
// digit as counts[first][tile]
__device__ __forceinline__ void flush_counts(const uint32_t* s_hist, int ndig, int first,
                                             int tile, int tiles, uint32_t* __restrict__ hist,
                                             uint32_t* __restrict__ counts) {
  __syncthreads();
  for (int i = threadIdx.x; i < ndig * BINS; i += blockDim.x) {
    const uint32_t c = s_hist[i];
    if (c) atomicAdd(&hist[i], c);
  }
  for (int v = threadIdx.x; v < BINS; v += blockDim.x) {
    counts[((size_t)first * tiles + tile) * BINS + v] = s_hist[first * BINS + v];
  }
}

// array y's first position: 4 bits of ``firsts`` each
__device__ __forceinline__ int first_of(unsigned firsts, int y) { return (firsts >> (4 * y)) & 15; }

// One digit position ``d`` of the sort; grid (tiles, arrays). Array y holds
// keys[y][2][n], idx[y][2][n], hist[y][ndig][BINS], counts[y][ndig][tiles][BINS].
template <typename K>
__global__ void __launch_bounds__(THREADS) radix_pass_kernel(K* __restrict__ keys_all,
                                                             int32_t* __restrict__ idx_all,
                                                             const uint32_t* __restrict__ hist_all,
                                                             uint32_t* __restrict__ counts_all,
                                                             int n, int ndig, unsigned firsts,
                                                             int d) {
  __shared__ uint32_t s_warp[WARPS][BINS];
  __shared__ uint32_t s_off[BINS];
  __shared__ uint32_t s_wsum[BINS / 32];
  __shared__ uint32_t s_before[THREADS];
  __shared__ uint32_t s_start[BINS];
  __shared__ K s_key[TILE];
  __shared__ int32_t s_idx[TILE];
  const int y = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const uint32_t* hist = hist_all + (size_t)y * ndig * BINS;
  uint32_t* counts = counts_all + (size_t)y * ndig * tiles * BINS;
  const unsigned mask = plan_mask(hist, n, ndig, first_of(firsts, y));
  if (!((mask >> d) & 1u)) return;  // below the first, or one digit in every key
  const int par = __popc(mask & ((1u << d) - 1)) & 1;
  const K* src_k = keys_all + ((size_t)y * 2 + par) * n;
  const int32_t* src_i = idx_all + ((size_t)y * 2 + par) * n;
  K* dst_k = keys_all + ((size_t)y * 2 + (par ^ 1)) * n;
  int32_t* dst_i = idx_all + ((size_t)y * 2 + (par ^ 1)) * n;
  const unsigned later = mask & ~((2u << d) - 1);
  const int q = later ? __ffs(later) - 1 : -1;  // the next running position
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this tile's base for each digit: the whole-array exclusive sum over the
  // smaller digits, plus this digit's count in the tiles before this one
  // (two threads a digit, the even and the odd tiles, 16 loads in flight)
  uint32_t tot = 0, before = 0;
  {
    const uint32_t* c = counts + (size_t)d * tiles * BINS + (tid & (BINS - 1));
#pragma unroll 16
    for (int t = tid / BINS; t < tile; t += THREADS / BINS) before += c[(size_t)t * BINS];
  }
  s_before[tid] = before;
  __syncthreads();
  if (tid < BINS) {
    tot = hist[(size_t)d * BINS + tid];
    before = s_before[tid] + s_before[tid + BINS];
  }
  uint32_t incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (tid < BINS && lane == 31) s_wsum[warp] = incl;
  for (int i = tid; i < WARPS * BINS; i += THREADS) (&s_warp[0][0])[i] = 0;
  __syncthreads();
  if (tid < BINS) {
    uint32_t base = incl - tot;
    for (int w = 0; w < warp; ++w) base += s_wsum[w];
    s_off[tid] = base + before;
  }

  // stable ranks within each warp's contiguous run of 32 * ITEMS positions
  const unsigned lt = (1u << lane) - 1;
  K key[ITEMS];
  int32_t id[ITEMS];
  unsigned dig[ITEMS];
  uint32_t rank[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = tile * TILE + warp * (32 * ITEMS) + it * 32 + lane;
    const bool valid = e < n;
    key[it] = valid ? src_k[e] : K(0);
    id[it] = valid ? src_i[e] : 0;
    dig[it] = valid ? digit(key[it], d) : BINS;  // BINS: no bin
    const unsigned peers = __match_any_sync(0xffffffffu, dig[it]);
    const unsigned below = __popc(peers & lt);
    const uint32_t seen = valid ? s_warp[warp][dig[it]] : 0;
    __syncwarp();
    if (valid && below == 0) s_warp[warp][dig[it]] = seen + __popc(peers);
    __syncwarp();
    rank[it] = seen + below;
  }
  __syncthreads();
  uint32_t tcount = 0;  // the digit's count in the tile
  if (tid < BINS) {     // each warp's exclusive offset within the tile's digit
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t c = s_warp[w][tid];
      s_warp[w][tid] = tcount;
      tcount += c;
    }
  }
  // the tile's digit starts: the exclusive sum of tcount over the digits
  uint32_t tincl = tcount;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, tincl, off);
    if (lane >= off) tincl += v;
  }
  if (tid < BINS && lane == 31) s_wsum[warp] = tincl;
  __syncthreads();
  if (tid < BINS) {
    uint32_t start = tincl - tcount;
    for (int w = 0; w < warp; ++w) start += s_wsum[w];
    s_start[tid] = start;
  }
  __syncthreads();
  // the tile's pairs in digit order in shared memory, then written out in
  // that order, so neighbouring threads write neighbouring positions of
  // each digit's run
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (dig[it] == BINS) continue;
    const uint32_t lp = s_start[dig[it]] + s_warp[warp][dig[it]] + rank[it];
    s_key[lp] = key[it];
    s_idx[lp] = id[it];
  }
  __syncthreads();
  const int tile_n = min(TILE, n - tile * TILE);
  for (int i = tid; i < tile_n; i += THREADS) {
    const K k = s_key[i];
    const unsigned dg = digit(k, d);
    const uint32_t dst = s_off[dg] + (i - s_start[dg]);
    dst_k[dst] = k;
    dst_i[dst] = s_idx[i];
    if (q >= 0) atomicAdd(&counts[((size_t)q * tiles + dst / TILE) * BINS + digit(k, q)], 1u);
  }
}

// launch every pass of ``ndig`` positions, from the lowest first position
// of the arrays, over ``arrays`` arrays of n pairs
template <typename K>
inline void sort_pairs(K* keys, int32_t* idx, const uint32_t* hist, uint32_t* counts, int n,
                       int ndig, unsigned firsts, int arrays, cudaStream_t stream) {
  const dim3 grid((n + TILE - 1) / TILE, arrays);
  int lowest = MAX_DIGITS;
  for (int y = 0; y < arrays; ++y) lowest = min(lowest, (int)((firsts >> (4 * y)) & 15));
  for (int d = lowest; d < ndig; ++d) {
    radix_pass_kernel<K><<<grid, THREADS, 0, stream>>>(keys, idx, hist, counts, n, ndig, firsts,
                                                       d);
  }
}

// ---- the scans ----------------------------------------------------------------

// the sum of x over the warp (modulo 2^64), in every lane
__device__ __forceinline__ u64 warp_sum(u64 x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DT>
struct Seg {
  int f;
  u64 s[DT];
};

template <int DT>
__device__ __forceinline__ Seg<DT> seg_identity() {
  Seg<DT> z;
  z.f = 0;
#pragma unroll
  for (int k = 0; k < DT; ++k) z.s[k] = 0;
  return z;
}

// a then b
template <int DT>
__device__ __forceinline__ Seg<DT> seg_combine(const Seg<DT>& a, const Seg<DT>& b) {
  Seg<DT> c;
  c.f = a.f | b.f;
#pragma unroll
  for (int k = 0; k < DT; ++k) c.s[k] = b.f ? b.s[k] : a.s[k] + b.s[k];
  return c;
}

template <int DT>
__device__ __forceinline__ Seg<DT> seg_shfl_up(const Seg<DT>& a, int off) {
  Seg<DT> b;
  b.f = __shfl_up_sync(0xffffffffu, a.f, off);
#pragma unroll
  for (int k = 0; k < DT; ++k) b.s[k] = __shfl_up_sync(0xffffffffu, a.s[k], off);
  return b;
}

template <int DT>
__device__ __forceinline__ Seg<DT> warp_seg_incl(Seg<DT> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg<DT> up = seg_shfl_up(x, off);
    if (lane >= off) x = seg_combine(up, x);
  }
  return x;
}

// exclusive block-wide scan of one value per thread (blockDim.x == THREADS);
// every thread must call it; *total gets the whole block's combination
template <int DT>
__device__ __forceinline__ Seg<DT> block_seg_scan(const Seg<DT>& x, Seg<DT>* total) {
  __shared__ Seg<DT> s_w[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Seg<DT> incl = warp_seg_incl(x);
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const Seg<DT> w = warp_seg_incl(lane < WARPS ? s_w[lane] : seg_identity<DT>());
    if (lane < WARPS) s_w[lane] = w;
  }
  __syncthreads();
  Seg<DT> ex = seg_shfl_up(incl, 1);
  if (lane == 0) ex = seg_identity<DT>();
  const Seg<DT> out = warp == 0 ? ex : seg_combine(s_w[warp - 1], ex);
  *total = s_w[WARPS - 1];
  __syncthreads();  // s_w is reused by the next call
  return out;
}

}  // namespace radix
