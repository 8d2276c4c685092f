// K16 entry_diff: the entry-resident diff of the single-dispatch fleet pass.
//
// Replaces karmada_tpu/scheduler/fleet.py:314-337 and 353-376, the body of
// _fleet_solve after the divide, for one chunk of rows:
//   zero the Duplicated rows; n_placed = cells > 0; has_cand =
//   any(feasible); the row's (site<<8 | count) words in site order, first
//   k_out, zero-padded to the resident's width k_res; changed = the words
//   differ from resident[r] (a valid row only); meta = n_placed |
//   unsched<<8 | has_cand<<9 | changed<<10; the row's words for the wire,
//   zeros when unchanged; and the resident row to write after the pass:
//   r when changed, also the padding rows of an all-rows chunk (the JAX
//   slice update writes their zero words), else -1.
// all_rows chunks own the contiguous rows [offset, offset + rows); partial
// batches read their row (padding reads row 0) and write nothing here.
//
// The resident is only read. JAX diffs every row of a pass against the
// resident as it stood before the pass, so a row named twice in one batch
// (two problems with one key) is "changed" both times; an in-place write
// here would show the second occurrence the first one's words. The caller
// writes the resident once, after the last chunk (K6 over `commit`).
//
// The JAX program sorts each [chunk, C] row (lax.sort) and keeps a prefix.
// The sorted keys are unique per row with the site in the high bits, so
// the sorted prefix IS the first placed cells in site order: an ordered
// compaction gives the same words and no sort runs.
//
// What bounds it on an H100: bytes. It reads the int32 assignment and the
// feasible byte of every cell (5 B a cell, 102 MB for a 4096 x 5000
// chunk), and per row the resident words, and writes the row's words,
// meta and commit index: about 0.03 ms at 3.35 TB/s. The design: one block
// per row walks the row in tiles of 256 columns, one column a thread; a
// tile with no placed cell (most of them: a row places at most 128 of
// 5000) costs one __syncthreads_count, and a tile with some runs a
// block-wide exclusive scan that gives each placed cell its rank. The words
// collect in shared memory (k_res ints), where the diff and the output
// rows read them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DUPLICATED = 0;

// block-wide exclusive scan of one int per thread; *total gets the sum
// (every thread). Uses and re-arms s_warp[WARPS + 1].
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < WARPS; ++k) {
      const int t = s_warp[k];
      s_warp[k] = acc;
      acc += t;
    }
    s_warp[WARPS] = acc;
  }
  __syncthreads();
  const int out = s_warp[wid] + x - v;
  *total = s_warp[WARPS];
  __syncthreads();  // s_warp is reused by the next call
  return out;
}

__global__ void __launch_bounds__(THREADS) entry_diff_kernel(
    const int32_t* __restrict__ assignment, const uint8_t* __restrict__ unsched,
    const uint8_t* __restrict__ feasible, const int32_t* __restrict__ strategy,
    const int32_t* __restrict__ rows, int c_n,
    const int32_t* __restrict__ resident, int k_res, int k_out, int all_rows,
    int offset, int32_t* __restrict__ meta_out, int32_t* __restrict__ ents,
    long long* __restrict__ commit) {
  extern __shared__ int32_t words[];  // [k_res]
  __shared__ int s_warp[WARPS + 1];
  const int j = blockIdx.x;
  const int row = rows[j];
  const bool valid = row >= 0;
  const long long t = all_rows ? (long long)offset + j : (valid ? row : 0);
  const bool dup = strategy[j] == DUPLICATED;
  const int32_t* a = assignment + (size_t)j * c_n;
  const uint8_t* f = feasible + (size_t)j * c_n;
  for (int k = threadIdx.x; k < k_res; k += THREADS) words[k] = 0;
  __syncthreads();

  int n_placed = 0, cand = 0;
  int seen = 0;  // placed cells ranked so far (block-uniform)
  for (int base = 0; base < c_n; base += THREADS) {
    const int c = base + threadIdx.x;
    const bool in = c < c_n;
    const int32_t av = (in && !dup) ? a[c] : 0;
    const bool sel = av > 0;
    n_placed += sel;
    cand |= (in && f[c]) ? 1 : 0;
    if (seen < k_out && __syncthreads_count(sel) > 0) {  // block-uniform
      int tile;
      const int pos = seen + block_scan(sel ? 1 : 0, s_warp, &tile);
      if (sel && pos < k_out) words[pos] = (c << 8) | av;
      seen += tile;
    }
  }
  __syncthreads();  // every word is written

  const int32_t* pe = resident + (size_t)t * k_res;
  int diff = 0;
  for (int k = threadIdx.x; k < k_res; k += THREADS) diff |= words[k] != pe[k];
  const bool changed = valid && __syncthreads_or(diff) != 0;
  int32_t* o = ents + (size_t)j * k_res;
  for (int k = threadIdx.x; k < k_res; k += THREADS) o[k] = changed ? words[k] : 0;
  int total_placed;
  block_scan(n_placed, s_warp, &total_placed);
  const bool any_cand = __syncthreads_or(cand) != 0;
  if (threadIdx.x == 0) {
    meta_out[j] = total_placed | ((int32_t)(unsched[j] != 0) << 8) |
                  ((int32_t)any_cand << 9) | ((int32_t)changed << 10);
    commit[j] = (changed || (all_rows && !valid)) ? t : -1;
  }
}

}  // namespace

extern "C" int entry_diff_launch(
    const int32_t* assignment, const uint8_t* unsched, const uint8_t* feasible,
    const int32_t* strategy, const int32_t* rows, int b_n, int c_n,
    const int32_t* resident, int cap, int k_res, int k_out, int all_rows,
    int offset, int32_t* meta, int32_t* ents, long long* commit,
    cudaStream_t stream) {
  (void)cap;  // the wrapper checks the all_rows window against it
  if (b_n == 0) return 0;
  if (k_out < 1 || k_out > k_res) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k_res * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        entry_diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  entry_diff_kernel<<<b_n, THREADS, smem, stream>>>(
      assignment, unsched, feasible, strategy, rows, c_n, resident, k_res,
      k_out, all_rows, offset, meta, ents, commit);
  return (int)cudaGetLastError();
}
