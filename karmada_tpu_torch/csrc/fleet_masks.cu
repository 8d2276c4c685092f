// K3 fleet_masks: the fleet path's per-row feasibility and division inputs.
//
// Replaces, for one chunk of resident table rows:
//   karmada_tpu/scheduler/fleet.py:538-547  the per-row state gather of
//                                           _fleet_pass (rows = -1 is
//                                           padding: row 0's slots, with
//                                           replicas, fresh and counts 0)
//   karmada_tpu/scheduler/fleet.py:184      _row_masks: the scatter-add of
//                                           the K_PREV (site, count) pairs
//                                           into prev, the gathers of the
//                                           bitpacked affinity/taint and GVK
//                                           planes by slot, unpacked in
//                                           little bit order (_unpack_bits,
//                                           fleet.py:174), and
//     feasible = aff & (gvk | prev>0 & incomplete) & (taint | prev>0) & valid
//   karmada_tpu/scheduler/fleet.py:568-569  the profile-row gather and
//                                           merge_estimates (one estimator)
// and, as a second entry point, karmada_tpu/scheduler/fleet.py:788
// _fleet_bits: the same feasibility packed into 32-bit words.
//
// Outputs feed K2 (divide_replicas) directly: feasible bool, static_w,
// prev and avail int32 [rows, C], plus the row's replicas, strategy and
// fresh flag.
//
// What bounds it on an H100: bytes. The masks form writes 13 B a cell
// (feasible 1, static_w 4, prev 4, avail 4): 266 MB for a 4096 x 5000
// chunk, about 0.08 ms at 3.35 TB/s. Its reads (one static-weight row and
// one profile row per binding, three bit planes of C/8 bytes) mostly hit
// L2, since rows share a few interned slots. The bits form writes C/8
// bytes a row and reads the row's pairs.
//
// The design. Masks form: one block per row (any number of rows). The
// row's slots are resolved once; prev is built by scattering the row's
// pairs into a zeroed shared tile of the columns (shared atomicAdd on
// uint32: int32 with wrap-around, exact and order-free, so duplicate sites
// add and the padding pair (0, 0) adds nothing; sites outside [0, C) are
// dropped, as row_masks_ref drops them), which makes prev O(1) a cell for
// any k_prev. Each thread then writes 4 consecutive columns a step: 16-B
// stores of static_w, prev and avail and one 4-B store of feasible, the
// mask bits from one byte of each plane (a scalar path serves rows that
// are not 16-B aligned, C % 4 != 0). Rows wider than one tile loop over
// tiles. Bits form: persistent blocks of 8 warps, one row per warp at a
// time (the next row's slots loaded while one is processed), one thread
// per 32-bit word. The row's positive-prev bitmask is built in shared
// memory from the pairs' per-site int32 sums (a warp match finds duplicate
// sites; only then are counts summed); the planes' bytes are read as
// little-endian words (a funnel shift of two aligned words, no byte
// loads), all of a lane's words in flight at once; incomplete_en is packed
// to words once a block, and
//   word = aff & (gvk | pm & inc) & (taint | pm) & live-bits.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef FLEET_CUT
// k2_variants.py --fleet times truncated copies: 1 returns before the
// previous-site pass, 2 right after it (prev or its bitmask stored)
#define FLEET_CUT 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TILE = 8192;  // prev columns a masks block holds (32 KB)
constexpr int WARPS = THREADS / 32;  // bits form: rows in flight a block
constexpr int MAX_WINDOW = 1024;  // bits form: words a window (32,768 columns)
constexpr int32_t MAX_I32 = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t merged(int32_t est, int32_t reps) {
  // merge_estimates over the one profile-table answer: -1 (no answer) and
  // MAX_INT32 (untouched sentinel) give spec.Replicas, as does a row of 0
  // replicas (the non-workload short-circuit)
  return (reps == 0 || est == -1 || est == MAX_I32) ? reps : est;
}

__global__ void __launch_bounds__(THREADS) fleet_masks_kernel(
    const uint8_t* __restrict__ cp_bits, const int32_t* __restrict__ cp_static,
    const uint8_t* __restrict__ gvk_bits, const int32_t* __restrict__ prof_table,
    const uint8_t* __restrict__ incomplete, int c_n, int gw8,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cp_idx,
    const int32_t* __restrict__ gvk_idx, const int32_t* __restrict__ prof_idx,
    const int32_t* __restrict__ replicas, const int32_t* __restrict__ strategy,
    const uint8_t* __restrict__ fresh, const int32_t* __restrict__ prev_sites,
    const int32_t* __restrict__ prev_counts, int k_prev,
    uint8_t* __restrict__ feasible, int32_t* __restrict__ static_w,
    int32_t* __restrict__ prev, int32_t* __restrict__ avail,
    int32_t* __restrict__ reps_out, int32_t* __restrict__ st_out,
    uint8_t* __restrict__ fr_out, int tile, int vec) {
  extern __shared__ int4 s_tile4[];  // tile columns of prev, 16-B aligned
  int32_t* s_prev = reinterpret_cast<int32_t*>(s_tile4);
  const int j = blockIdx.x;
  const int row = rows[j];
  const bool valid = row >= 0;
  const int r = valid ? row : 0;
  const int cp = cp_idx[r], gv = gvk_idx[r], pf = prof_idx[r];
  const int32_t reps = valid ? replicas[r] : 0;
  if (threadIdx.x == 0) {
    reps_out[j] = reps;
    st_out[j] = strategy[r];
    fr_out[j] = (valid && fresh[r]) ? 1 : 0;
  }
  const int w8 = (c_n + 7) >> 3;
  const uint8_t* aff_row = cp_bits + (size_t)cp * 2 * w8;
  const uint8_t* taint_row = aff_row + w8;
  const uint8_t* gvk_row = gvk_bits + (size_t)gv * gw8;
  const int32_t* sw_row = cp_static + (size_t)cp * c_n;
  const int32_t* pf_row = prof_table + (size_t)pf * c_n;
  const int32_t* ps = prev_sites + (size_t)r * k_prev;
  const int32_t* pc = prev_counts + (size_t)r * k_prev;
  const size_t o = (size_t)j * c_n;
  // the thread's first pair, loaded before the tile is zeroed (padding
  // rows scatter nothing: their counts are 0)
  const bool has_pair = valid && (int)threadIdx.x < k_prev;
  const int site0 = has_pair ? ps[threadIdx.x] : -1;
  const uint32_t cnt0 = has_pair ? (uint32_t)pc[threadIdx.x] : 0u;
#if FLEET_CUT == 1
  return;
#endif

  for (int base = 0; base < c_n; base += tile) {
    const int width = min(tile, c_n - base);
    if (base) __syncthreads();  // the last tile's reads of s_prev are done
    for (int i = threadIdx.x; i < (width + 3) >> 2; i += THREADS)
      s_tile4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    // (a zero count adds nothing: the padding pairs are skipped)
    if (cnt0 != 0 && site0 >= base && site0 - base < width)
      atomicAdd(reinterpret_cast<unsigned*>(&s_prev[site0 - base]), cnt0);
    if (valid)
      for (int k = threadIdx.x + THREADS; k < k_prev; k += THREADS) {
        const int s = ps[k];
        const uint32_t n = (uint32_t)pc[k];
        if (n != 0 && s >= base && s - base < width)
          atomicAdd(reinterpret_cast<unsigned*>(&s_prev[s - base]), n);
      }
    __syncthreads();

    if (vec) {  // 4 columns a step; C % 4 == 0 and every row 16-B aligned
      for (int c = base + 4 * threadIdx.x; c < base + width; c += 4 * THREADS) {
        const int4 pv = *reinterpret_cast<const int4*>(s_prev + (c - base));
#if FLEET_CUT == 2
        *reinterpret_cast<int4*>(prev + o + c) = pv;
        continue;
#endif
        const int4 sw = __ldg(reinterpret_cast<const int4*>(sw_row + c));
        const int4 est = __ldg(reinterpret_cast<const int4*>(pf_row + c));
        const uint32_t inc4 = __ldg(reinterpret_cast<const uint32_t*>(incomplete + c));
        const int byte = c >> 3, sh = c & 7;  // sh is 0 or 4
        const uint32_t aff = (__ldg(aff_row + byte) >> sh) & 0xFu;
        const uint32_t taint = (__ldg(taint_row + byte) >> sh) & 0xFu;
        const uint32_t gvk = (__ldg(gvk_row + byte) >> sh) & 0xFu;
        const uint32_t pm = (uint32_t)(pv.x > 0) | (uint32_t)(pv.y > 0) << 1 |
                            (uint32_t)(pv.z > 0) << 2 | (uint32_t)(pv.w > 0) << 3;
        const uint32_t inc = (uint32_t)((inc4 & 0xFFu) != 0) |
                             (uint32_t)((inc4 & 0xFF00u) != 0) << 1 |
                             (uint32_t)((inc4 & 0xFF0000u) != 0) << 2 |
                             (uint32_t)((inc4 & 0xFF000000u) != 0) << 3;
        const uint32_t f =
            valid ? aff & (gvk | (pm & inc)) & (taint | pm) : 0u;
        *reinterpret_cast<uint32_t*>(feasible + o + c) =
            (f & 1u) | (f >> 1 & 1u) << 8 | (f >> 2 & 1u) << 16 | (f >> 3 & 1u) << 24;
        *reinterpret_cast<int4*>(static_w + o + c) = sw;
        *reinterpret_cast<int4*>(prev + o + c) = pv;
        *reinterpret_cast<int4*>(avail + o + c) =
            make_int4(merged(est.x, reps), merged(est.y, reps),
                      merged(est.z, reps), merged(est.w, reps));
      }
    } else {  // one column a step
      for (int c = base + threadIdx.x; c < base + width; c += THREADS) {
        const int32_t pv = s_prev[c - base];
        prev[o + c] = pv;
#if FLEET_CUT == 2
        continue;
#endif
        const int byte = c >> 3, bit = c & 7;
        const bool pm = pv > 0;
        const bool aff = (aff_row[byte] >> bit) & 1;
        const bool taint = (taint_row[byte] >> bit) & 1;
        const bool gvk = (gvk_row[byte] >> bit) & 1;
        feasible[o + c] =
            (valid && aff && (gvk || (pm && incomplete[c])) && (taint || pm)) ? 1 : 0;
        static_w[o + c] = sw_row[c];
        avail[o + c] = merged(pf_row[c], reps);
      }
    }
  }
}

// bytes [b0, b0 + 4) of a plane row of n > b0 bytes as a little-endian
// word: a funnel shift of the two aligned words around them. An aligned
// word holding a byte of the row lies in that byte's page, so it may be
// read whole; the second is read only if it holds a byte of the row. Bytes
// outside the row land in bits >= 8n - 8b0 (columns past C, masked by the
// caller) or are shifted out.
__device__ __forceinline__ uint32_t le_word(const uint8_t* row, int b0, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + b0);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const unsigned sh = (unsigned)(a & 3) * 8;
  const uint32_t lo = __ldg(p);
  const uint32_t hi =
      sh && reinterpret_cast<uintptr_t>(p + 1) < reinterpret_cast<uintptr_t>(row + n)
          ? __ldg(p + 1) : 0u;
  return __funnelshift_r(lo, hi, sh);
}

// the positive-prev bits of one row's window [lo, hi) into s_pm, by one
// warp: an active pair (count != 0, site in the window) sums the counts of
// every active pair at its site (int32 with wrap-around) and sets the
// site's bit when the sum is > 0. A batch of 32 pairs whose active sites
// are distinct (a warp match) needs no sum; otherwise each active pair is
// broadcast in turn and compared. (s1_0, c1_0) is the lane's pair of the
// first batch, loaded ahead by the caller.
__device__ __forceinline__ void prev_bits(const int32_t* ps, const int32_t* pc,
                                          int k_prev, int lo, int hi, int lane,
                                          int s1_0, uint32_t c1_0, uint32_t* s_pm) {
  for (int kb = 0; kb < k_prev; kb += 32) {
    const int k = kb + lane;
    const int s1 = kb == 0 ? s1_0 : (k < k_prev ? ps[k] : -1);
    const uint32_t c1 = kb == 0 ? c1_0 : (k < k_prev ? (uint32_t)pc[k] : 0u);
    const bool a1 = c1 != 0 && s1 >= lo && s1 < hi;
    uint32_t sum = c1;
    // sites lie in [0, 2^31): lanes without an active pair get a key no
    // site takes
    const unsigned peers =
        __match_any_sync(FULL, a1 ? (unsigned)s1 : 0x80000000u | (unsigned)lane);
    if (k_prev > 32 || __any_sync(FULL, a1 && __popc(peers) > 1)) {
      sum = 0;
      for (int kb2 = 0; kb2 < k_prev; kb2 += 32) {
        const int k2 = kb2 + lane;
        const int s2 = kb2 == kb ? s1 : (k2 < k_prev ? ps[k2] : -1);
        const uint32_t c2 = kb2 == kb ? c1 : (k2 < k_prev ? (uint32_t)pc[k2] : 0u);
        unsigned act = __ballot_sync(FULL, c2 != 0 && s2 >= lo && s2 < hi);
        while (act) {
          const int l = __ffs(act) - 1;
          act &= act - 1;
          const int ss = __shfl_sync(FULL, s2, l);
          const uint32_t cc = __shfl_sync(FULL, c2, l);
          if (ss == s1) sum += cc;
        }
      }
    }
    if (a1 && (int32_t)sum > 0)
      atomicOr(&s_pm[(s1 - lo) >> 5], 1u << ((s1 - lo) & 31));
  }
}

// bits form: words a lane loads at once (5 x 32 x 32 = 5120 columns: a
// config-5 row in one batch of loads)
constexpr int UNROLL = 5;

struct RowSlot {
  int row, cp, gv, s1;  // s1, c1: the lane's pair of the first batch
  uint32_t c1;
};

__device__ __forceinline__ RowSlot load_slot(int row, const int32_t* cp_idx,
                                             const int32_t* gvk_idx,
                                             const int32_t* prev_sites,
                                             const int32_t* prev_counts, int k_prev,
                                             int lane) {
  RowSlot r{row, 0, 0, -1, 0u};
  if (row >= 0) {
    r.cp = cp_idx[row];
    r.gv = gvk_idx[row];
    if (lane < k_prev) {
      r.s1 = prev_sites[(size_t)row * k_prev + lane];
      r.c1 = (uint32_t)prev_counts[(size_t)row * k_prev + lane];
    }
  }
  return r;
}

__global__ void __launch_bounds__(THREADS) fleet_bits_kernel(
    const uint8_t* __restrict__ cp_bits, const uint8_t* __restrict__ gvk_bits,
    const uint8_t* __restrict__ incomplete, int c_n, int gw8,
    const int32_t* __restrict__ rows, int b_n,
    const int32_t* __restrict__ cp_idx, const int32_t* __restrict__ gvk_idx,
    const int32_t* __restrict__ prev_sites,
    const int32_t* __restrict__ prev_counts, int k_prev,
    int32_t* __restrict__ words, int n_words, int window) {
  extern __shared__ uint32_t s_mem[];  // s_inc[window], s_pm[WARPS][window]
  uint32_t* s_inc = s_mem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* s_pm = s_mem + (size_t)window * (1 + warp);
  const int w8 = (c_n + 7) >> 3;
  const long long stride = (long long)gridDim.x * WARPS;
  for (int w0 = 0; w0 < n_words; w0 += window) {
    const int nw = min(window, n_words - w0);
    const int lo = w0 * 32, hi = min(c_n, (w0 + nw) * 32);  // the window's columns
    if (w0) __syncthreads();  // every warp is done with the last window's s_inc
#pragma unroll 4
    for (int i = warp; i < nw; i += WARPS) {  // a warp ballot a word
      const int c = lo + 32 * i + lane;
      const unsigned x = __ballot_sync(FULL, c < c_n && incomplete[c] != 0);
      if (lane == 0) s_inc[i] = x;
    }
    __syncthreads();
    // a pipeline of rows: while row j is processed, the next row's slots
    // and first pairs and the row index after it are in flight
    long long j = (long long)blockIdx.x * WARPS + warp;
    int row_n = j + stride < b_n ? rows[j + stride] : -1;
    RowSlot next = load_slot(j < b_n ? rows[j] : -1, cp_idx, gvk_idx, prev_sites,
                             prev_counts, k_prev, lane);
    for (; j < b_n; j += stride) {
      const RowSlot cur = next;
      next = load_slot(row_n, cp_idx, gvk_idx, prev_sites, prev_counts, k_prev, lane);
      row_n = j + 2 * stride < b_n ? rows[j + 2 * stride] : -1;
      int32_t* out = words + (size_t)j * n_words + w0;
      if (cur.row < 0) {  // padding: no feasible cluster
        for (int i = lane; i < nw; i += 32) out[i] = 0;
        continue;
      }
#if FLEET_CUT == 1
      for (int i = lane; i < nw; i += 32) out[i] = cur.cp + cur.gv + cur.s1 + (int)cur.c1;
      continue;
#endif
      for (int i = lane; i < nw; i += 32) s_pm[i] = 0;
      __syncwarp();
      const uint8_t* aff_row = cp_bits + (size_t)cur.cp * 2 * w8;
      const uint8_t* gvk_row = gvk_bits + (size_t)cur.gv * gw8;
      for (int g0 = 0; g0 < nw; g0 += 32 * UNROLL) {
        // the planes' words first, in flight while the prev bits are built
        uint32_t aff[UNROLL], taint[UNROLL], gvk[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = g0 + lane + 32 * u;
          aff[u] = taint[u] = gvk[u] = 0;
          if (i < nw) {
            const int b0 = 4 * (w0 + i);
            aff[u] = le_word(aff_row, b0, w8);
            taint[u] = le_word(aff_row + w8, b0, w8);
            gvk[u] = le_word(gvk_row, b0, w8);
          }
        }
        if (g0 == 0) {
          prev_bits(prev_sites + (size_t)cur.row * k_prev,
                    prev_counts + (size_t)cur.row * k_prev, k_prev, lo, hi, lane,
                    cur.s1, cur.c1, s_pm);
          __syncwarp();
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = g0 + lane + 32 * u;
          if (i < nw) {
            const uint32_t pm = s_pm[i];
#if FLEET_CUT == 2
            out[i] = (int32_t)pm;
            continue;
#endif
            const int rem = c_n - 32 * (w0 + i);
            const uint32_t live = rem >= 32 ? FULL : (1u << rem) - 1u;
            out[i] = (int32_t)(aff[u] & (gvk[u] | (pm & s_inc[i])) & (taint[u] | pm) &
                               live);
          }
        }
      }
      __syncwarp();  // the next row re-zeroes s_pm
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

extern "C" int fleet_masks_launch(
    const uint8_t* cp_bits, const int32_t* cp_static, const uint8_t* gvk_bits,
    const int32_t* prof_table, const uint8_t* incomplete, int c_n, int gw8,
    const int32_t* rows, int b_n, const int32_t* cp_idx,
    const int32_t* gvk_idx, const int32_t* prof_idx, const int32_t* replicas,
    const int32_t* strategy, const uint8_t* fresh, const int32_t* prev_sites,
    const int32_t* prev_counts, int k_prev, uint8_t* feasible,
    int32_t* static_w, int32_t* prev, int32_t* avail, int32_t* reps_out,
    int32_t* st_out, uint8_t* fr_out, cudaStream_t stream) {
  if (b_n == 0 || c_n == 0) return 0;
  if (k_prev <= 0) return (int)cudaErrorInvalidValue;
  const int c4 = (c_n + 3) & ~3;
  const int tile = c4 < MAX_TILE ? c4 : MAX_TILE;
  const int vec = c_n % 4 == 0 && aligned(cp_static, 16) && aligned(prof_table, 16) &&
                  aligned(static_w, 16) && aligned(prev, 16) && aligned(avail, 16) &&
                  aligned(feasible, 4) && aligned(incomplete, 4);
  fleet_masks_kernel<<<b_n, THREADS, (size_t)tile * 4, stream>>>(
      cp_bits, cp_static, gvk_bits, prof_table, incomplete, c_n, gw8, rows,
      cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh, prev_sites,
      prev_counts, k_prev, feasible, static_w, prev, avail, reps_out, st_out,
      fr_out, tile, vec);
  return (int)cudaGetLastError();
}

extern "C" int fleet_bits_launch(
    const uint8_t* cp_bits, const int32_t* cp_static, const uint8_t* gvk_bits,
    const int32_t* prof_table, const uint8_t* incomplete, int c_n, int gw8,
    const int32_t* rows, int b_n, const int32_t* cp_idx,
    const int32_t* gvk_idx, const int32_t* prof_idx, const int32_t* replicas,
    const int32_t* strategy, const uint8_t* fresh, const int32_t* prev_sites,
    const int32_t* prev_counts, int k_prev, int32_t* words,
    cudaStream_t stream) {
  (void)cp_static; (void)prof_table; (void)prof_idx; (void)replicas;
  (void)strategy; (void)fresh;  // the bits form needs no division inputs
  if (b_n == 0 || c_n == 0) return 0;
  if (k_prev <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_words = (c_n + 31) >> 5;
  const int window = n_words < MAX_WINDOW ? n_words : MAX_WINDOW;
  const size_t smem = (size_t)window * (1 + WARPS) * 4;
  // persistent blocks, as many as fit at once, each packing incomplete_en
  // once and walking rows WARPS at a time
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fleet_bits_kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long want = ((long long)b_n + WARPS - 1) / WARPS;
  const int grid = (int)(want < fit ? want : fit);
  fleet_bits_kernel<<<grid, THREADS, smem, stream>>>(
      cp_bits, gvk_bits, incomplete, c_n, gw8, rows, b_n, cp_idx, gvk_idx,
      prev_sites, prev_counts, k_prev, words, n_words, window);
  return (int)cudaGetLastError();
}
