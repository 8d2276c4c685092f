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
// meta and commit index: about 0.03 ms at 3.35 TB/s.
//
// The design, as K4 phase A's (fleet_diff.cu): one block of 8 warps per
// row. Each warp owns a contiguous span of the row (up to MAX_STEPS steps
// of 128 columns) and each lane 4 consecutive columns a step, read with
// one 16-B load of the assignment and one 4-B load of the feasible bytes
// (scalar loads where C % 4 != 0 or a pointer is not aligned), all steps'
// loads in flight at once. A lane keeps each step's 4 counts as 4 bytes of
// one register (min(count, 255); a cell placed past 255, which the fleet's
// 128-replica cap rules out, is read again for its word). The block's
// first 2 x THREADS resident words are loaded before the row, so their
// latency hides behind it. One block-wide exchange of the warps' placed
// counts and has_cand (one barrier a row for C <= 8 x MAX_STEPS x 128)
// gives each warp its first word slot and the row's n_placed; a warp
// ranks its own placed cells in site order by four ballots a step and
// writes each one below k_out into the shared words (k_out of them: a
// row's words past k_out are zeros). A barrier, then one __syncthreads_or
// of the diff; about three barriers a row in all.
//
// k2_variants.py --fleet times a copy built with -DFLEET_CUT=1: the
// ranking skipped (loads, n_placed, has_cand, the diff and the outputs
// kept), so the difference is what the compaction adds to a launch.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef FLEET_CUT
#define FLEET_CUT 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DUPLICATED = 0;
constexpr int MAX_STEPS = 8;  // 128-column steps a warp holds per span
constexpr unsigned FULL = 0xffffffffu;

// the nonzero bytes of a 32-bit word as a 4-bit mask (byte e -> bit e)
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

__global__ void __launch_bounds__(THREADS) entry_diff_kernel(
    const int32_t* __restrict__ assignment, const uint8_t* __restrict__ unsched,
    const uint8_t* __restrict__ feasible, const int32_t* __restrict__ strategy,
    const int32_t* __restrict__ rows, int c_n,
    const int32_t* __restrict__ resident, int k_res, int k_out, int all_rows,
    int offset, int32_t* __restrict__ meta_out, int32_t* __restrict__ ents,
    long long* __restrict__ commit, int steps, int vec) {
  extern __shared__ int32_t words[];  // [k_out]: the first min(seen, k_out) are set
  __shared__ int s_x[2][2][WARPS];  // per warp: placed cells, has_cand
  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = rows[j];
  const bool valid = row >= 0;
  const long long t = all_rows ? (long long)offset + j : (valid ? row : 0);
  const bool dup = strategy[j] == DUPLICATED;
  const int32_t* a = assignment + (size_t)j * c_n;
  const uint8_t* f = feasible + (size_t)j * c_n;
  const int32_t* pe = resident + (size_t)t * k_res;
  // the resident row's first words, in flight while the row is read
  const int32_t pre0 = tid < k_res ? pe[tid] : 0;
  const int32_t pre1 = tid + THREADS < k_res ? pe[tid + THREADS] : 0;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int span = steps * 128;

  int seen = 0, has_cand = 0;  // the block's placed cells and has_cand (uniform)
  int p = 0;
  for (int base = 0; base < c_n; base += span * WARPS, p ^= 1) {
    const int wbase = base + warp * span;
    uint32_t v[MAX_STEPS];  // a step's 4 counts, a byte each: min(count, 255), 0 unplaced
    uint32_t cand = 0;
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) {
      v[s] = 0;
      const int c = wbase + s * 128 + lane * 4;
      if (s < steps && c < c_n) {
        int32_t x[4] = {0, 0, 0, 0};
        if (vec) {  // the 4 columns lie inside the row, aligned
          if (!dup) {
            const int4 q = *reinterpret_cast<const int4*>(a + c);
            x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
          }
          cand |= *reinterpret_cast<const uint32_t*>(f + c);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < c_n) {
              if (!dup) x[e] = a[c + e];
              cand |= f[c + e];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[s] |= (uint32_t)(x[e] <= 0 ? 0 : (x[e] < 255 ? x[e] : 255)) << (8 * e);
      }
    }
    int mine = 0;
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) mine += __popc(nonzero_nibble(v[s]));
    // one exchange a span: the warps' placed cells and has_cand
    const int w_placed = __reduce_add_sync(FULL, mine);
    const unsigned w_cand = __reduce_or_sync(FULL, cand != 0 ? 1u : 0u);
    if (lane == 0) {
      s_x[p][0][warp] = w_placed;
      s_x[p][1][warp] = (int)w_cand;
    }
    __syncthreads();
    int before = seen, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int n = s_x[p][0][w];
      before += w < warp ? n : 0;
      total += n;
      has_cand |= s_x[p][1][w];
    }
#if FLEET_CUT != 1
    if (w_placed && before < k_out) {  // ordered compaction of the placed cells
      int pos = before;
#pragma unroll
      for (int s = 0; s < MAX_STEPS; ++s) {
        if (s < steps && pos < k_out) {
          const uint32_t fl = nonzero_nibble(v[s]);
          const unsigned m0 = __ballot_sync(FULL, fl & 1u);
          const unsigned m1 = __ballot_sync(FULL, fl & 2u);
          const unsigned m2 = __ballot_sync(FULL, fl & 4u);
          const unsigned m3 = __ballot_sync(FULL, fl & 8u);
          int r = pos + __popc(m0 & lt) + __popc(m1 & lt) + __popc(m2 & lt) +
                  __popc(m3 & lt);
          const int c = wbase + s * 128 + lane * 4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (fl >> e & 1u) {
              if (r < k_out) {
                const int32_t n = (int32_t)(v[s] >> (8 * e) & 0xFFu);
                // a count past a byte is read again (the fleet holds <= 128)
                words[r] = ((c + e) << 8) | (n < 255 ? n : a[c + e]);
              }
              ++r;
            }
          }
          pos += __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
        }
      }
    }
#endif
    seen += total;
  }
  __syncthreads();  // every word is written
  // the row's words: the first `filled` compacted, zeros past them
  const int filled = seen < k_out ? seen : k_out;
  int diff = 0;
  if (tid < k_res) diff |= (tid < filled ? words[tid] : 0) != pre0;
  if (tid + THREADS < k_res)
    diff |= (tid + THREADS < filled ? words[tid + THREADS] : 0) != pre1;
  for (int k = tid + 2 * THREADS; k < k_res; k += THREADS)
    diff |= (k < filled ? words[k] : 0) != pe[k];
  const bool changed = valid && __syncthreads_or(diff) != 0;
  int32_t* o = ents + (size_t)j * k_res;
  for (int k = tid; k < k_res; k += THREADS)
    o[k] = changed && k < filled ? words[k] : 0;
  if (tid == 0) {
    meta_out[j] = seen | ((int32_t)(unsched[j] != 0) << 8) |
                  ((int32_t)(has_cand != 0) << 9) | ((int32_t)changed << 10);
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
  // steps of 128 columns a warp: the row split evenly over the 8 warps,
  // at most MAX_STEPS a span (wider rows take several spans)
  const int groups = (c_n + 127) / 128;
  const int per_warp = (groups + WARPS - 1) / WARPS;
  const int steps = per_warp < 1 ? 1 : (per_warp > MAX_STEPS ? MAX_STEPS : per_warp);
  const auto al = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int vec = c_n % 4 == 0 && al(assignment, 16) && al(feasible, 4);
  const size_t smem = (size_t)k_out * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        entry_diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  entry_diff_kernel<<<b_n, THREADS, smem, stream>>>(
      assignment, unsched, feasible, strategy, rows, c_n, resident, k_res,
      k_out, all_rows, offset, meta, ents, commit, steps, vec);
  return (int)cudaGetLastError();
}
