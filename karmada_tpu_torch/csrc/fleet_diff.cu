// K4 fleet_diff: the resident diff of phase A and the entry rows of phase B.
//
// Phase A (fleet_diff_launch) replaces karmada_tpu/scheduler/fleet.py:574-634,
// the body of _fleet_pass after the divide, for one chunk of rows:
//   zero the Duplicated rows; dense8 = (uint8)assignment; n_placed = cells
//   > 0; has_cand = any(feasible); meta = n_placed | unsched<<8 |
//   has_cand<<9; read the old dense row and meta word of the resident and
//   write the new ones IN PLACE (all_rows chunks own rows [offset, offset +
//   rows); partial batches write their valid rows only and drop padding,
//   as .at[].set(mode="drop") drops it); changed = any changed cell or a
//   changed meta; dcount = changed cells; and the cell deltas
//   (site<<9 | count+1) of the changed cells in site order, first d_slots.
// Phase B (fleet_entry_rows_launch) replaces fleet.py:736-745, the per-row
// stage of _fleet_entries: for each row index (-1 gives zeros), the
// (site<<8 | count) words of the row's nonzero cells in site order, first
// k_out.
//
// The JAX programs sort each row ([chunk, C] lax.sort) and keep a prefix.
// The sorted keys are unique per row with the site in the high bits, so
// the sorted prefix IS the first cells in site order: both stages are
// ordered compactions here, and no sort runs.
//
// What bounds it on an H100: bytes. Phase A reads the int32 assignment,
// the feasible byte and the old uint8 row and writes the uint8 row: 7 B a
// cell, 143 MB for a 4096 x 5000 chunk, about 0.043 ms at 3.35 TB/s. Phase B
// reads one uint8 row per changed row and writes k_out words a row: 270 MB
// and 34 MB for config 5's 53,953 churned rows, about 0.09 ms.
//
// Phase A's design: one block of 8 warps per row. Each warp owns a
// contiguous span of the row (up to MAX_STEPS steps of 128 columns) and
// each lane 4 consecutive columns a step, read with one 16-B load of the
// assignment and 4-B loads of the feasible and resident bytes (scalar
// loads where C % 4 != 0), all steps' loads in flight at once. A lane
// reads its resident bytes and writes them back itself (only the words
// that changed), so the in-place update needs no barrier. The lane keeps
// its steps' new bytes and changed flags in registers; one block-wide
// exchange of the warps' changed counts, n_placed and has_cand (one
// barrier a row for C <= 8 x MAX_STEPS x 128) gives each warp its first
// delta slot, and a warp ranks its own changed cells in site order by
// four ballots a step. A row with no changed cell skips the compaction,
// as the JAX program's lax.cond skips a steady chunk's.
//
// Phase B's design: one warp per row, 4 rows a block, no barrier. A row
// is gathered at any index, so it starts at any byte: a lane reads the
// aligned 16-B chunks that overlap the row (up to ROW_STEPS of them a
// span, 32 lanes apart, all in flight at once) and masks off the bytes
// outside it. An aligned 16-B load never crosses a page, so the bytes it
// reads past either end of the row are readable; they are never used.
// Each chunk's nonzero bytes become a 16-bit mask by byte-wise SIMD
// (__vcmpne4) and one multiply a word; a warp scan of the masks' popcounts
// gives each lane its first word slot, in site order, and the lane writes
// its nonzero bytes below k_out. The row stops at k_out placed cells; a
// padding row only writes its k_out zeros. k2_variants.py --fleet times a
// copy built with -DFLEET_CUT=1: phase B's loads alone (folded into a
// value written only when impossible) and its zero fill, no compaction.

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

__global__ void __launch_bounds__(THREADS) fleet_diff_kernel(
    const int32_t* __restrict__ assignment, const uint8_t* __restrict__ unsched,
    const uint8_t* __restrict__ feasible, const int32_t* __restrict__ strategy,
    const int32_t* __restrict__ rows, int c_n, uint8_t* res_dense,
    int32_t* res_meta, int all_rows, int offset, int d_slots,
    uint8_t* __restrict__ changed_out, int32_t* __restrict__ meta_out,
    int32_t* __restrict__ dcount_out, int32_t* __restrict__ deltas, int steps,
    int vec) {
  __shared__ int s_x[2][3][WARPS];  // per warp: changed, n_placed, has_cand
  const int j = blockIdx.x;
  const int row = rows[j];
  const bool valid = row >= 0;
  // all_rows: the chunk's own contiguous rows, padding included; partial:
  // the row itself, while padding reads row 0 and writes nothing
  const long long t = all_rows ? (long long)offset + j : (valid ? row : 0);
  const bool writes = all_rows || valid;
  const bool dup = strategy[j] == DUPLICATED;
  const int32_t* a = assignment + (size_t)j * c_n;
  const uint8_t* f = feasible + (size_t)j * c_n;
  uint8_t* rd = res_dense + (size_t)t * c_n;
  int32_t* dl = deltas + (size_t)j * d_slots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int span = steps * 128;

  int n_placed = 0, cand = 0;  // this thread's, running
  int placed = 0, has_cand = 0, seen = 0;  // the block's (uniform)
  int p = 0;
  for (int base = 0; base < c_n; base += span * WARPS, p ^= 1) {
    const int wbase = base + warp * span;
    uint32_t d8w[MAX_STEPS], chg[MAX_STEPS];
    int mine = 0;
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) {
      d8w[s] = 0;
      chg[s] = 0;
      const int c = wbase + s * 128 + lane * 4;
      if (s < steps && c < c_n) {
        uint32_t nw = 0, ow = 0, fw = 0;
        int np = 0;
        if (vec) {  // the 4 columns lie inside the row, 16-B aligned
          const int4 av = *reinterpret_cast<const int4*>(a + c);
          const int32_t v[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int32_t x = dup ? 0 : v[e];
            np += x > 0;
            nw |= (uint32_t)(x & 0xFF) << (8 * e);  // counts <= MAX_REPLICAS_FAST
          }
          fw = *reinterpret_cast<const uint32_t*>(f + c);
          ow = *reinterpret_cast<const uint32_t*>(rd + c);
          if (writes && nw != ow) *reinterpret_cast<uint32_t*>(rd + c) = nw;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < c_n) {
              const int32_t x = dup ? 0 : a[c + e];
              np += x > 0;
              nw |= (uint32_t)(x & 0xFF) << (8 * e);
              fw |= (uint32_t)(f[c + e] != 0) << (8 * e);
              ow |= (uint32_t)rd[c + e] << (8 * e);
            }
          }
          if (writes)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < c_n && ((nw ^ ow) >> (8 * e) & 0xFF))
                rd[c + e] = (uint8_t)(nw >> (8 * e));
        }
        n_placed += np;
        cand |= fw != 0;
        uint32_t fl = 0;
        if (valid)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fl |= (uint32_t)(((nw ^ ow) >> (8 * e) & 0xFF) != 0) << e;
        d8w[s] = nw;
        chg[s] = fl;
        mine += __popc(fl);
      }
    }
    // one exchange a span: the warps' changed cells, n_placed, has_cand
    const int w_changed = __reduce_add_sync(FULL, mine);
    const int w_placed = __reduce_add_sync(FULL, n_placed);
    const unsigned w_cand = __reduce_or_sync(FULL, (unsigned)cand);
    if (lane == 0) {
      s_x[p][0][warp] = w_changed;
      s_x[p][1][warp] = w_placed;
      s_x[p][2][warp] = (int)w_cand;
    }
    __syncthreads();
    int before = seen, total = 0;
    placed = 0;
    has_cand = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = s_x[p][0][w];
      before += w < warp ? v : 0;
      total += v;
      placed += s_x[p][1][w];
      has_cand |= s_x[p][2][w];
    }
    if (total && before < d_slots) {  // ordered compaction of the changed cells
      int pos = before;
#pragma unroll
      for (int s = 0; s < MAX_STEPS; ++s) {
        if (s < steps && pos < d_slots) {
          const uint32_t fl = chg[s];
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
              if (r < d_slots)
                dl[r] = ((c + e) << 9) | (int32_t)((d8w[s] >> (8 * e) & 0xFFu) + 1);
              ++r;
            }
          }
          pos += __popc(m0) + __popc(m1) + __popc(m2) + __popc(m3);
        }
      }
    }
    seen += total;
  }
  const int filled = seen < d_slots ? seen : d_slots;
  for (int k = filled + threadIdx.x; k < d_slots; k += THREADS) dl[k] = 0;
  if (threadIdx.x == 0) {
    const int32_t meta = placed | ((int32_t)(unsched[j] != 0) << 8) |
                         ((int32_t)(has_cand != 0) << 9);
    const int32_t old_m = res_meta[t];
    if (writes) res_meta[t] = meta;
    changed_out[j] = (valid && (seen > 0 || meta != old_m)) ? 1 : 0;
    meta_out[j] = meta;
    dcount_out[j] = seen;
  }
}

constexpr int ROW_WARPS = 4;   // phase B: one warp a row, 4 rows a block
constexpr int ROW_STEPS = 10;  // 16-B chunks a lane holds a span: 5120 B a warp

// the nonzero bytes of a 32-bit word as a 4-bit mask (byte e -> bit e)
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

__global__ void __launch_bounds__(ROW_WARPS * 32) fleet_entry_rows_kernel(
    const uint8_t* __restrict__ res_dense, int c_n,
    const int32_t* __restrict__ rows, int m_n, int k_out,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (j >= m_n) return;  // warp-uniform
  const int row = rows[j];
  int32_t* o = out + j * k_out;
  int seen = 0;  // nonzero cells ranked so far (warp-uniform)
  if (row >= 0) {
    const uintptr_t start =
        reinterpret_cast<uintptr_t>(res_dense) + (size_t)row * c_n;
    const uint4* q0 = reinterpret_cast<const uint4*>(start & ~(uintptr_t)15);
    const int off = (int)(start & 15);  // the row's first byte in chunk 0
    const int end = off + c_n;          // one past its last byte
    const int nq = (end + 15) >> 4;     // chunks overlapping the row
    for (int qb = 0; qb < nq && seen < k_out; qb += 32 * ROW_STEPS) {
      uint4 w[ROW_STEPS];
#pragma unroll
      for (int s = 0; s < ROW_STEPS; ++s) {
        const int q = qb + s * 32 + lane;
        w[s] = q < nq ? q0[q] : make_uint4(0u, 0u, 0u, 0u);
      }
#if FLEET_CUT == 1
      uint32_t acc = 0;
#pragma unroll
      for (int s = 0; s < ROW_STEPS; ++s) acc ^= w[s].x ^ w[s].y ^ w[s].z ^ w[s].w;
      if (acc == 0x5bd1e995u) o[0] = (int32_t)acc;
#else
#pragma unroll
      for (int s = 0; s < ROW_STEPS; ++s) {
        const int q = qb + s * 32 + lane;
        uint32_t nz = nonzero_nibble(w[s].x) | nonzero_nibble(w[s].y) << 4 |
                      nonzero_nibble(w[s].z) << 8 | nonzero_nibble(w[s].w) << 12;
        const int lo = off - q * 16, hi = end - q * 16;  // the row's bytes: [lo, hi)
        if (lo > 0) nz &= 0xFFFFu << lo;
        if (hi < 16) nz &= hi > 0 ? (1u << hi) - 1u : 0u;
        if (seen < k_out && __any_sync(FULL, nz)) {  // warp-uniform
          const int n = __popc(nz);
          int x = n;  // inclusive scan of the counts over the lanes
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x += y;
          }
          int r = seen + x - n;
          const int col = q * 16 - off;  // the column of the chunk's byte 0
          while (nz && r < k_out) {
            const int e = __ffs(nz) - 1;
            nz &= nz - 1;
            const uint32_t wd =
                e < 8 ? (e < 4 ? w[s].x : w[s].y) : (e < 12 ? w[s].z : w[s].w);
            o[r++] = ((col + e) << 8) | (int32_t)((wd >> (8 * (e & 3))) & 0xFFu);
          }
          seen += __shfl_sync(FULL, x, 31);
        }
      }
#endif
    }
  }
  const int filled = seen < k_out ? seen : k_out;
  for (int k = filled + lane; k < k_out; k += 32) o[k] = 0;
}

}  // namespace

extern "C" int fleet_diff_launch(
    const int32_t* assignment, const uint8_t* unsched, const uint8_t* feasible,
    const int32_t* strategy, const int32_t* rows, int b_n, int c_n,
    uint8_t* res_dense, int32_t* res_meta, int cap, int all_rows, int offset,
    int d_slots, uint8_t* changed, int32_t* meta, int32_t* dcount,
    int32_t* deltas, cudaStream_t stream) {
  (void)cap;  // the wrapper checks the all_rows window against it
  if (b_n == 0) return 0;
  // steps of 128 columns a warp: the row split evenly over the 8 warps,
  // at most MAX_STEPS a span (wider rows take several spans)
  const int groups = (c_n + 127) / 128;
  const int per_warp = (groups + WARPS - 1) / WARPS;
  const int steps = per_warp < 1 ? 1 : (per_warp > MAX_STEPS ? MAX_STEPS : per_warp);
  const auto al = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int vec = c_n % 4 == 0 && al(assignment, 16) && al(feasible, 4) &&
                  al(res_dense, 4);
  fleet_diff_kernel<<<b_n, THREADS, 0, stream>>>(
      assignment, unsched, feasible, strategy, rows, c_n, res_dense, res_meta,
      all_rows, offset, d_slots, changed, meta, dcount, deltas, steps, vec);
  return (int)cudaGetLastError();
}

extern "C" int fleet_entry_rows_launch(const uint8_t* res_dense, int cap,
                                       int c_n, const int32_t* rows, int m_n,
                                       int k_out, int32_t* out,
                                       cudaStream_t stream) {
  (void)cap;
  if (m_n == 0) return 0;
  const int blocks = (int)(((long long)m_n + ROW_WARPS - 1) / ROW_WARPS);
  fleet_entry_rows_kernel<<<blocks, ROW_WARPS * 32, 0, stream>>>(
      res_dense, c_n, rows, m_n, k_out, out);
  return (int)cudaGetLastError();
}
