// K13 quota_caps: the static-assignment quota ceiling per (row, cluster).
//
// Replaces karmada_tpu/ops/quota.py:120 _cluster_caps_kernel as jitted by
// :150 quota_cluster_caps, and in its fold form the cap fold of
// karmada_tpu/scheduler/core.py:2295 _profile_table_quota.
//
//   in:  caps int64[N, C, R] (a FederatedResourceQuota's static-assignment
//        hard limits per cluster; UNLIMITED = 2^62 where none),
//        ns_rows int32[B] (row of caps, < 0 = uncapped), requests int64[B, R]
//   cell(b, c) = ns_rows[b] < 0 ? 2^31-1 :
//        int32(min(2^31-1, min over dims r with requests[b, r] > 0 of
//              (cap >= UNLIMITED ? 2^62 : floor(cap / requests[b, r]))))
//        with cap = caps[clamp(ns_rows[b], 0, N-1), c, r]; 2^62 (read as
//        2^31-1) when nothing is requested
//
// Per-row form (quota_caps_launch): out int32[B, C] = cell, the estimator-
// shaped answer the general route merges beside the summary estimate.
// Fold form (quota_fold_launch): over the fleet's profile table int32[U, C]
// (K1's table form, then K7's overlay, -1 = no summary) with the profiles'
// cap rows, in place: where cell < 2^31-1 the table becomes
// min(table < 0 ? 2^31-1 : table, cell). A capped cluster with no summary
// thus answers the cap, as the general route's merge (which ignores -1)
// does.
//
// Division: the caps are hard limits from the FRQ spec, and nothing makes
// them non-negative, so C++'s truncating '/' is corrected to JAX's floor for
// a negative cap (the request is > 0 here). The int32 conversion keeps the
// low 32 bits, as XLA's convert does for a cap quotient below -2^31.
//
// What bounds it on an H100: bytes, the B x C int32 write (82 MB at the
// general route's 4096 x 5000 chunk, ~24 us at HBM rate). The per-row
// form's design keeps every other cost under it:
//
// - Divisions: none per cell. Each (row, requested dim) gets its
//   Granlund-Montgomery multiplier and shift once per block, in shared
//   memory (divmagic.cuh), and a cap is staged once per (block, namespace):
//   x = 2 (a ^ s) with s = a >> 63, which gives JAX's floor for a negative
//   cap (INT64_MIN included); a cap at or above UNLIMITED is staged x = 0,
//   s = 2^62, which answers 2^62 whatever the request. A cell then costs a
//   high product, a shift, an xor and a min per requested dim. The answer
//   keeps the min against 2^31 - 1 and the low 32 bits.
// - Caps read once per (block, namespace), not once per row: a block takes
//   512 columns (4 a thread, 4 warps) and a run of up to 128 rows, ranks the
//   run's capped rows by cap row in shared memory (ids at or past N read
//   N - 1, as the jnp gather clamps), and each warp walks them in that
//   order, one namespace's segment at a time. At a segment's start each
//   thread stages its columns' caps of the namespace into registers from
//   one of its warp's two shared buffers, and the namespace after next
//   starts to fly into that buffer (cp.async, the span read in coalesced
//   words, row_tiles.cuh): two segments of rows cover each copy's latency,
//   and the first two namespaces fly over the block's prologue.
//   So the caps a launch reads through L2 are at most (row runs) x (cap
//   rows a run names) x C x R x 8 bytes: at the quota general chunk (4096
//   rows, 4 capped namespaces, runs of ~63 rows) about 40 MB, and in
//   practice the capped rows' namespaces alone. A multiplier is made for
//   capped rows only.
// - A dim in which every cap of a warp's span is UNLIMITED answers 2^62,
//   which never binds: the warp skips its products for the segment (a
//   ballot at staging). A quota that caps a few clusters costs the other
//   warps a fill.
// - Uncapped rows (ns < 0) are a pure fill of 2^31 - 1, with no loads,
//   written by each warp on its own: an even block's before its prologue,
//   an odd block's after its capped rows, so that an SM's blocks stream
//   stores and compute at once (a quota that caps few namespaces leaves
//   most rows to the fills).
// - Past G = 4 dims the caps do not stay in registers: at a segment's start
//   each warp copies its span's words of the namespace (contiguous, wn x R)
//   into its buffer in dynamic shared memory (cp.async, coalesced, one pad
//   word every 16), and each row stages its cells' caps from there. Past
//   WIDE_DIMS dims the buffer takes a chunk of WIDE_DIMS dims a column, and
//   each row copies its chunks in turn (a lane's caps in global memory sit
//   8 R bytes from its neighbour's: read there, every load touches 32
//   lines).
// - Stores: 4 adjacent columns a lane, one 16-B store where the row's warp
//   span starts 16-B aligned (C % 4 == 0); otherwise the span is realigned
//   by shuffles, its head and tail one cell a store (row_tiles.cuh).
// - The grid: grid.x takes the row runs (any row count is one launch),
//   grid.y the column tiles, rows a block chosen for one wave of the blocks
//   the card holds at once (at most 102 registers a thread: five blocks an
//   SM).
//
// The fold form keeps a thread a cell and an int64 division per requested
// dim: it runs once per table rebuild over U x C cells (0.004 ms).
#include <cstdint>
#include <cuda_runtime.h>

#include "divmagic.cuh"
#include "row_tiles.cuh"

namespace {

constexpr int THREADS = 256;  // the fold form's block
constexpr long long MAX_I32 = 2147483647LL;
constexpr long long UNLIMITED = 1LL << 62;

// the per-row form
constexpr int ROW_THREADS = 128;                     // 4 warps
constexpr int VEC = SPAN_VEC;                        // columns a thread
constexpr int TILE_C = ROW_THREADS * VEC;            // 512 columns a block
constexpr int MAX_RB = ROW_THREADS;                  // rows a block at most: one rank a thread
constexpr int G = SPAN_DIMS;                         // dims whose caps stay in registers
constexpr int SMEM_ROWS = 8 * 1024;                  // the multipliers' shared memory
constexpr int WIDE_DIMS = 24;                        // dims a column of a wide buffer
constexpr int WIDE_WORDS = SPAN_CELLS + SPAN_CELLS / 16;  // a wide buffer's words a dim

// a (row, dim)'s multiplier and shift (m = 0: not requested)
struct Mult {
  unsigned long long m;
  int l, pad;
};

// a cap staged for floor_staged: at or above UNLIMITED x = 0 and s = 2^62,
// which answers 2^62 for any request. s is kept as its high word sh: its low
// word is sh >> 31 (all ones, or 0) in every case (sign_of)
__device__ __forceinline__ void stage_cap(long long a, unsigned long long& x2, int& sh) {
  unsigned long long s;
  if (a >= UNLIMITED) {
    x2 = 0;
    s = (unsigned long long)UNLIMITED;
  } else {
    stage_signed(a, x2, s);
  }
  sh = (int)(s >> 32);
}

__device__ __forceinline__ unsigned long long sign_of(int sh) {
  return ((unsigned long long)(unsigned)sh << 32) | (unsigned)(sh >> 31);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// min(best, 2^31 - 1), its low 32 bits as XLA's convert keeps them
__device__ __forceinline__ int32_t to_cell(long long best) {
  best = best < MAX_I32 ? best : MAX_I32;
  return (int32_t)(uint32_t)(unsigned long long)best;
}

// the warp's span (wn columns of R words at src) into buf, dims [d0, d0 +
// w_dims) a column as [column][w_dims] words, one pad word every 16: one
// contiguous copy where every dim fits (w_dims == R)
__device__ __forceinline__ void wide_fetch(const int64_t* __restrict__ src, int wn, int r_dims,
                                           int d0, int w_dims, unsigned long long* buf,
                                           int lane) {
  if (w_dims == r_dims) {
    for (int g = lane; g < wn * r_dims; g += 32)
      __pipeline_memcpy_async(buf + g + (g >> 4), src + g, 8);
  } else {  // w_dims == WIDE_DIMS
    for (int g = lane; g < wn * WIDE_DIMS; g += 32) {
      const int col = g / WIDE_DIMS, k = g - col * WIDE_DIMS;
      if (d0 + k < r_dims)
        __pipeline_memcpy_async(buf + g + (g >> 4), src + (size_t)col * r_dims + d0 + k, 8);
    }
  }
  __pipeline_commit();
}

__device__ __forceinline__ int32_t cap_cell(const int64_t* __restrict__ caps,
                                            int n_caps, int c_n, int r_dims,
                                            int ns, const int64_t* __restrict__ q,
                                            int c) {
  if (ns < 0) return (int32_t)MAX_I32;
  const int row = ns < n_caps ? ns : n_caps - 1;  // a jnp gather clamps
  const int64_t* cap = caps + ((size_t)row * c_n + c) * r_dims;
  long long best = UNLIMITED;
  for (int r = 0; r < r_dims; ++r) {
    const long long qr = q[r];
    if (qr <= 0) continue;
    const long long a = cap[r];
    long long ratio;
    if (a >= UNLIMITED) {
      ratio = UNLIMITED;  // no limit never binds, whatever the request
    } else {
      ratio = a / qr;
      if (a % qr != 0 && a < 0) --ratio;  // floor, not truncation
    }
    best = ratio < best ? ratio : best;
  }
  return to_cell(best);
}

// grid.x: runs of `rb` rows, grid.y: tiles of TILE_C columns. ONE: r_dims
// <= G, a namespace's caps held in registers (at most 102 registers, so
// that five blocks an SM hide the rows' latencies); else each warp's wide
// buffer follows the multipliers in dynamic shared memory.
template <bool ONE>
__global__ void __launch_bounds__(ROW_THREADS, ONE ? 5 : 1)
quota_caps_kernel(const int64_t* __restrict__ caps, int n_caps, int c_n, int r_dims,
                  const int32_t* __restrict__ ns_rows, const int64_t* __restrict__ req,
                  int b_n, int rb, int32_t* __restrict__ out) {
  extern __shared__ Mult mult[];                // [rb][r_dims]
  __shared__ int key[MAX_RB];                   // a run row's cap row, -1 uncapped
  __shared__ int order[MAX_RB];                 // the run's capped rows by key
  __shared__ int seg_end[MAX_RB];               // by position: where its key's rows end
  // a warp's caps words, two buffers in turn: a segment's namespace is staged
  // from one while the next segment's lands in the other
  __shared__ __align__(16) unsigned long long span[ONE ? ROW_THREADS / 32 : 1][2]
                                                  [ONE ? SPAN_WORDS : 1];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * rb;
  const int rows = (int)min((long long)rb, (long long)b_n - row0);
  const int c0 = blockIdx.y * TILE_C + tid * VEC;
  const int wbase = blockIdx.y * TILE_C + (tid & ~31) * VEC;  // the warp's span
  const int wn = min(SPAN_CELLS, c_n - wbase);
  const int words = max(wn, 0) * r_dims;  // the warp's words of a namespace
  const int w_dims = min(r_dims, WIDE_DIMS), chunks = (r_dims + WIDE_DIMS - 1) / WIDE_DIMS;
  unsigned long long* wide = reinterpret_cast<unsigned long long*>(mult + (size_t)rb * r_dims) +
                             (size_t)(tid >> 5) * WIDE_WORDS * w_dims;

  // each warp on its own, before the block's prologue: its first two capped
  // namespaces (the two least capped ids) in flight over the multipliers
  // and the ranking
  int ids[MAX_RB / 32];  // rows lane, lane + 32, ...: cap row, -1 uncapped
  int kmin = 0x7fffffff, kmin2 = 0x7fffffff;
#pragma unroll
  for (int q = 0; q < MAX_RB / 32; ++q) {
    const int j = lane + 32 * q;
    const int ns = j < rows ? ns_rows[row0 + j] : -1;
    ids[q] = ns < 0 ? -1 : (ns < n_caps ? ns : n_caps - 1);  // a jnp gather clamps
    if (ids[q] >= 0) kmin = min(kmin, ids[q]);
  }
  kmin = warp_min(kmin);
#pragma unroll
  for (int q = 0; q < MAX_RB / 32; ++q)
    if (ids[q] > kmin) kmin2 = min(kmin2, ids[q]);
  kmin2 = warp_min(kmin2);
  if constexpr (ONE) {
    if (kmin != 0x7fffffff)
      span_words_fetch(caps + ((size_t)kmin * c_n + wbase) * r_dims, words, r_dims,
                       span[tid >> 5][0], lane);
    __pipeline_commit();
    if (kmin2 != 0x7fffffff)
      span_words_fetch(caps + ((size_t)kmin2 * c_n + wbase) * r_dims, words, r_dims,
                       span[tid >> 5][1], lane);
    __pipeline_commit();
  }
  // the fills: an even block's before its prologue, an odd block's after
  // its capped rows, so that an SM's blocks stream stores and compute at
  // once
  auto fills = [&]() {
    const int32_t fill[VEC] = {(int32_t)MAX_I32, (int32_t)MAX_I32, (int32_t)MAX_I32,
                               (int32_t)MAX_I32};
#pragma unroll
    for (int q = 0; q < MAX_RB / 32; ++q) {
      unsigned todo = __ballot_sync(0xffffffffu, lane + 32 * q < rows && ids[q] < 0);
      while (todo) {
        const int b = 32 * q + __ffs(todo) - 1;
        todo &= todo - 1;
        store_span4(out + (size_t)(row0 + b) * c_n + wbase, wn, fill, lane);
      }
    }
  };
  const bool fills_first = (blockIdx.x & 1) == 0;
  if (fills_first) fills();
  if (tid < rows) {
    const int ns = ns_rows[row0 + tid];
    key[tid] = ns < 0 ? -1 : (ns < n_caps ? ns : n_caps - 1);
  }
  for (int p = tid; p < rows * r_dims; p += ROW_THREADS) {  // capped rows only
    const long long d = req[row0 * r_dims + p];
    const int ns = ns_rows[row0 + p / r_dims];
    Mult x = {0, 0, 0};
    if (d > 0 && ns >= 0) magic((unsigned long long)d, x.m, x.l);
    mult[p] = x;
  }
  __syncthreads();
  int capped = 0;  // the run's capped rows
  if (tid < rows) {  // a capped row's stable rank by key, and where its key's rows end
    const int k = key[tid];
    int rank = 0, end = 0;
    for (int j = 0; j < rows; ++j) {
      const int kj = key[j];
      rank += kj >= 0 && (kj < k || (kj == k && j < tid));
      end += kj >= 0 && kj <= k;
    }
    if (k >= 0) {
      order[rank] = tid;
      seg_end[rank] = end;
    }
  }
  for (int j = 0; j < rows; ++j) capped += key[j] >= 0;
  __syncthreads();

  unsigned long long x2[VEC][G];  // ONE: the segment's namespace's caps, staged
  int sg[VEC][G];
  unsigned bounded = 0;
  for (int i = 0, seg = 0; i < capped; ++seg) {
    const int end = seg_end[i];
    const int k = key[order[i]];
    const int64_t* base = caps + (size_t)k * c_n * r_dims;
    if constexpr (ONE) {
      __pipeline_wait_prior(1);  // all but the newest: this segment's words landed
      __syncwarp();
      const unsigned long long* buf = span[tid >> 5][seg & 1];
      bounded = 0;  // bit r: some cap of the warp's span in dim r is below UNLIMITED
#pragma unroll
      for (int r = 0; r < G; ++r) {
        bool below = false;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int g = (lane * VEC + j) * r_dims + r;
          const long long a = r < r_dims ? (long long)buf[g + (g >> 4)] : UNLIMITED;
          below |= a < UNLIMITED && c0 + j < c_n;
          stage_cap(a, x2[j][r], sg[j][r]);
        }
        bounded |= __any_sync(0xffffffffu, below) ? 1u << r : 0u;
      }
      __syncwarp();  // every lane staged: the buffer takes the namespace after next
      const int after = end < capped ? seg_end[end] : capped;
      if (after < capped)
        span_words_fetch(caps + ((size_t)key[order[after]] * c_n + wbase) * r_dims, words,
                         r_dims, span[tid >> 5][seg & 1], lane);
      __pipeline_commit();
    } else if (chunks == 1) {  // every dim of the namespace, once a segment
      __syncwarp();  // every lane is done with the namespace before
      wide_fetch(base + (size_t)wbase * r_dims, wn, r_dims, 0, w_dims, wide, lane);
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    for (; i < end; ++i) {
      const int row = order[i];
      const Mult* mrow = mult + (size_t)row * r_dims;
      long long best[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) best[j] = UNLIMITED;
      if constexpr (ONE) {
        Mult x[G];  // the row's multipliers, loaded together
#pragma unroll
        for (int r = 0; r < G; ++r) x[r] = r < r_dims ? mrow[r] : Mult{0, 0, 0};
#pragma unroll
        for (int r = 0; r < G; ++r) {
          // not requested (uniform over the block), or every cap of the warp's
          // span UNLIMITED in this dim: 2^62, which never binds (uniform over
          // the warp)
          if (x[r].m == 0 || !(bounded >> r & 1)) continue;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const long long q = floor_staged(x[r].m, x[r].l, x2[j][r], sign_of(sg[j][r]));
            best[j] = q < best[j] ? q : best[j];
          }
        }
      } else {  // past G dims: the caps from the warp's wide buffer, a chunk at a time
        for (int ch = 0; ch < chunks; ++ch) {
          const int d0 = ch * WIDE_DIMS;
          if (chunks > 1) {  // a chunk a row
            __syncwarp();
            wide_fetch(base + (size_t)wbase * r_dims, wn, r_dims, d0, w_dims, wide, lane);
            __pipeline_wait_prior(0);
            __syncwarp();
          }
          const int dn = min(w_dims, r_dims - d0);
          for (int r = 0; r < dn; ++r) {
            const Mult x = mrow[d0 + r];
            if (x.m == 0) continue;  // uniform over the warp
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const int g = (lane * VEC + j) * w_dims + r;
              unsigned long long xx;
              int sh;
              stage_cap((long long)wide[g + (g >> 4)], xx, sh);
              const long long q = floor_staged(x.m, x.l, xx, sign_of(sh));
              best[j] = q < best[j] ? q : best[j];
            }
          }
        }
      }
      int32_t v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = to_cell(best[j]);
      store_span4(out + (size_t)(row0 + row) * c_n + wbase, wn, v, lane);
    }
  }
  if (!fills_first) fills();
}

__global__ void quota_fold_kernel(const int64_t* __restrict__ caps, int n_caps,
                                  int c_n, int r_dims,
                                  const int32_t* __restrict__ prof_ns,
                                  const int64_t* __restrict__ profiles, int u_n,
                                  int32_t* __restrict__ table) {
  const size_t cell = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (cell >= (size_t)u_n * c_n) return;
  const int u = (int)(cell / c_n);
  const int ns = prof_ns[u];
  if (ns < 0) return;  // uncapped profile: the table stands
  const int c = (int)(cell - (size_t)u * c_n);
  const int32_t cap = cap_cell(caps, n_caps, c_n, r_dims, ns,
                               profiles + (size_t)u * r_dims, c);
  if (cap >= MAX_I32) return;
  int32_t t = table[cell];
  t = t < 0 ? (int32_t)MAX_I32 : t;
  table[cell] = t < cap ? t : cap;
}

inline unsigned blocks_for(size_t cells) {
  return (unsigned)((cells + THREADS - 1) / THREADS);
}

template <bool ONE>
int caps_rows(const int64_t* caps, int n_caps, int c_n, int r_dims, const int32_t* ns_rows,
              const int64_t* req, int b_n, int32_t* out, cudaStream_t stream) {
  const int tiles = (c_n + TILE_C - 1) / TILE_C;
  int most = r_dims > 0 ? (int)(SMEM_ROWS / (sizeof(Mult) * r_dims)) : MAX_RB;
  most = most < 1 ? 1 : (most > MAX_RB ? MAX_RB : most);
  const void* kernel = (const void*)quota_caps_kernel<ONE>;
  // past G dims, each warp's wide buffer after the multipliers
  const size_t wide = ONE ? 0
      : sizeof(unsigned long long) * (ROW_THREADS / 32) * WIDE_WORDS *
            (r_dims < WIDE_DIMS ? r_dims : WIDE_DIMS);
  const size_t most_smem = sizeof(Mult) * most * r_dims + wide;
  if (most_smem > 48 * 1024) {  // before the occupancy query, which reads it
    const int err = (int)cudaFuncSetAttribute(
        quota_caps_kernel<ONE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most_smem);
    if (err) return err;
  }
  // one wave of resident blocks
  const long long blocks =
      (long long)resident_blocks(kernel, ROW_THREADS, most_smem) * sm_count();
  const int rb = rows_per_block(b_n, tiles, blocks, most);
  const size_t smem = sizeof(Mult) * rb * r_dims + wide;
  quota_caps_kernel<ONE><<<dim3((unsigned)((b_n + rb - 1) / rb), tiles), ROW_THREADS, smem,
                           stream>>>(caps, n_caps, c_n, r_dims, ns_rows, req, b_n, rb, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out int32[B, C] = quota_cluster_caps(caps, ns_rows, req)
extern "C" int quota_caps_launch(const int64_t* caps, int n_caps, int c_n,
                                 int r_dims, const int32_t* ns_rows,
                                 const int64_t* req, int b_n, int32_t* out,
                                 cudaStream_t stream) {
  if ((size_t)b_n * c_n == 0) return 0;
  return r_dims <= G
      ? caps_rows<true>(caps, n_caps, c_n, r_dims, ns_rows, req, b_n, out, stream)
      : caps_rows<false>(caps, n_caps, c_n, r_dims, ns_rows, req, b_n, out, stream);
}

// table int32[U, C], in place: the cap fold of the fleet's profile table
extern "C" int quota_fold_launch(const int64_t* caps, int n_caps, int c_n,
                                 int r_dims, const int32_t* prof_ns,
                                 const int64_t* profiles, int u_n,
                                 int32_t* table, cudaStream_t stream) {
  const size_t cells = (size_t)u_n * c_n;
  if (cells == 0) return 0;
  quota_fold_kernel<<<blocks_for(cells), THREADS, 0, stream>>>(
      caps, n_caps, c_n, r_dims, prof_ns, profiles, u_n, table);
  return (int)cudaGetLastError();
}
