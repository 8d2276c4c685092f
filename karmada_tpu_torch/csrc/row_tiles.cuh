// Shared pieces of the row-streaming kernels K13 (quota_caps.cu, per-row
// form) and K1 (estimate_merge.cu): a block owns a tile of columns, four
// adjacent columns a thread, and streams a run of rows through it.
//
// - store_span4: a warp writes its 128 cells of a row in 16-B stores.
//   Where the warp's span does not start on a 16-B boundary (C % 4 != 0,
//   or a misaligned base), each lane's chunk takes its own last cells and
//   the next lane's first ones (shuffles), and the span's head and tail go
//   one cell a store.
// - load4: a thread's four cells of a row in one 16-B load where they are
//   16-B aligned and whole, one cell a load otherwise.
// - span_words_fetch / span_words_read: a warp's span of a [C][R] int64
//   table (R <= 4), each lane's 4 columns' R words. A lane's words are
//   contiguous but 32 R bytes from its neighbour's, so a lane reading its
//   own would touch 32 lines a load; instead the warp copies the span in
//   coalesced words (32 consecutive a copy, cp.async straight into shared
//   memory, in flight while the warp works), one pad word every 16 (so
//   that neither the copies nor the lanes' reads meet more than two to a
//   bank), and each lane reads its own back.
// - resident_blocks / rows_per_block: the grid's rows a block, so that a
//   launch is about one wave of the blocks the card holds at once (no tail
//   wave; grid.x takes the rows, so any row count is one launch).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

constexpr int SPAN_VEC = 4;                 // cells a lane
constexpr int SPAN_CELLS = 32 * SPAN_VEC;   // cells a warp
constexpr int SPAN_DIMS = 4;                // dims a span buffer holds
// shared-memory words of a warp's span buffer (one pad word every 16)
constexpr int SPAN_WORDS = SPAN_CELLS * SPAN_DIMS + SPAN_CELLS * SPAN_DIMS / 16;

// lane `lane` holds cells [4 lane, 4 lane + 4) of the warp's span dst[0, n)
// (n <= 128 valid cells; n and dst the same over the warp, which calls this
// whole)
__device__ __forceinline__ void store_span4(int32_t* dst, int n, const int32_t v[SPAN_VEC],
                                            int lane) {
  if (n <= 0) return;
  const int c = SPAN_VEC * lane;
  const int delta = (int)(((uintptr_t)dst >> 2) & 3);
  if (delta == 0) {
    if (c + SPAN_VEC <= n) {
      *reinterpret_cast<int4*>(dst + c) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < SPAN_VEC; ++k)
        if (c + k < n) dst[c + k] = v[k];
    }
    return;
  }
  // the head: cells [0, e) before the first 16-B boundary; lane l then
  // writes the chunk [4 l + e, 4 l + e + 4): its own v[e..3] and the next
  // lane's v[0..e-1]
  const int e = SPAN_VEC - delta;
  const int32_t n0 = __shfl_down_sync(0xffffffffu, v[0], 1);
  const int32_t n1 = __shfl_down_sync(0xffffffffu, v[1], 1);
  const int32_t n2 = __shfl_down_sync(0xffffffffu, v[2], 1);
  int32_t w[SPAN_VEC];
  if (e == 1) {
    w[0] = v[1], w[1] = v[2], w[2] = v[3], w[3] = n0;
  } else if (e == 2) {
    w[0] = v[2], w[1] = v[3], w[2] = n0, w[3] = n1;
  } else {
    w[0] = v[3], w[1] = n0, w[2] = n1, w[3] = n2;
  }
  const int cc = c + e;
  if (cc + SPAN_VEC <= n) {  // never lane 31: its chunk runs past the span
    *reinterpret_cast<int4*>(dst + cc) = make_int4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < SPAN_VEC; ++k)
      if (cc + k < n) dst[cc + k] = w[k];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < SPAN_VEC - 1; ++k)
      if (k < e && k < n) dst[k] = v[k];
  }
}

// cells [c, c + 4) of row `src` (cells past c_n read 0)
__device__ __forceinline__ void load4(const int32_t* __restrict__ src, int c, int c_n,
                                      int32_t v[4]) {
  const int32_t* p = src + c;
  if (c + 4 <= c_n && ((uintptr_t)p & 15) == 0) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c + k < c_n ? __ldg(p + k) : 0;
  }
}

// the warp's words of src[0, total) (its span's columns x R, R <= 4), 32
// consecutive a copy, straight into the warp's buffer, asynchronously
// (cp.async, no registers: the copies fly while the warp works); the caller
// commits (__pipeline_commit), and waits (__pipeline_wait_prior) and syncs
// the warp (or the block) before span_words_read
__device__ __forceinline__ void span_words_fetch(const int64_t* __restrict__ src, int total,
                                                 int r_dims, unsigned long long* buf, int lane) {
  const int per = SPAN_VEC * r_dims;  // words a lane
#pragma unroll
  for (int k = 0; k < SPAN_VEC * SPAN_DIMS; ++k) {
    const int g = lane + 32 * k;
    if (k < per && g < total) __pipeline_memcpy_async(buf + g + (g >> 4), src + g, 8);
  }
}

// lane `lane`'s words a[j][r] = the span's column 4 lane + j, dim r (0 for
// r >= r_dims)
template <int GD>
__device__ __forceinline__ void span_words_read(const unsigned long long* buf, int r_dims,
                                                int lane, long long a[SPAN_VEC][GD]) {
#pragma unroll
  for (int j = 0; j < SPAN_VEC; ++j)
#pragma unroll
    for (int r = 0; r < GD; ++r) {
      const int g = (lane * SPAN_VEC + j) * r_dims + r;
      a[j][r] = r < r_dims ? (long long)buf[g + (g >> 4)] : 0;
    }
}

// the current device's SM count, read once
inline int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      n = sms;
    if (n <= 0) n = 1;
  }
  return n;
}

// blocks of `kernel` an SM holds at `threads` threads and `smem` bytes of
// dynamic shared memory (at least 1), asked of the runtime once per
// (kernel, threads, smem)
inline int resident_blocks(const void* kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int threads;
    size_t smem;
    int blocks;
  };
  static Entry seen[16];
  static int n_seen = 0;
  static std::mutex lock;  // launches may come from several host threads
  const std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].threads == threads && seen[i].smem == smem)
      return seen[i].blocks;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) != cudaSuccess) {
    cudaGetLastError();  // not sticky; the launch reports its own errors
    blocks = 1;
  }
  blocks = blocks < 1 ? 1 : blocks;
  seen[n_seen % 16] = Entry{kernel, threads, smem, blocks};
  if (n_seen < 16) ++n_seen;
  return blocks;
}

// rows a block, between 1 and `most`, so that the grid over `tiles` column
// tiles is about `blocks` blocks
inline int rows_per_block(long long b_n, int tiles, long long blocks, int most) {
  long long rb = (b_n * tiles + blocks - 1) / blocks;
  rb = rb < 1 ? 1 : (rb > most ? most : rb);
  return (int)rb;
}
