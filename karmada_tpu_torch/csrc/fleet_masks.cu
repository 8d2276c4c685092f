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
// What bounds it on an H100: bytes. It writes 13 B a cell (feasible 1,
// static_w 4, prev 4, avail 4): 266 MB for a 4096 x 5000 chunk, about
// 0.08 ms at 3.35 TB/s. Its reads (one static-weight row and one profile
// row per binding, two bit planes of C/8 bytes) are a third of that and
// mostly hit L2, since rows share a few interned slots. The design does no
// more than one pass over each output: a block owns 256 columns of one
// row, the row's previous pairs sit in shared memory, and every thread
// computes one cell — prev by comparing its column with the K_PREV shared
// sites (an accumulating scatter, in int32 with wrap-around, so duplicate
// sites add and the padding pair (0, 0) adds nothing), the mask bits by
// byte loads from the gathered planes. The bits form computes the same
// cell per thread and forms each word with one warp ballot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PREV = 64;
constexpr int32_t MAX_I32 = 2147483647;

struct Row {
  bool valid;
  int r;       // table row read (0 for padding)
  int cp, gv;  // slots
};

__device__ __forceinline__ Row load_row(const int32_t* rows, int j,
                                        const int32_t* cp_idx,
                                        const int32_t* gvk_idx) {
  Row w;
  const int row = rows[j];
  w.valid = row >= 0;
  w.r = w.valid ? row : 0;
  w.cp = cp_idx[w.r];
  w.gv = gvk_idx[w.r];
  return w;
}

// previous pairs of row w into shared memory (counts zeroed on padding)
__device__ __forceinline__ void load_pairs(const Row& w,
                                           const int32_t* prev_sites,
                                           const int32_t* prev_counts,
                                           int k_prev, int* s_site,
                                           int* s_cnt) {
  for (int k = threadIdx.x; k < k_prev; k += blockDim.x) {
    const size_t o = (size_t)w.r * k_prev + k;
    s_site[k] = prev_sites[o];
    s_cnt[k] = w.valid ? prev_counts[o] : 0;
  }
}

// prev at column c, and the feasibility of the cell
__device__ __forceinline__ bool cell(const Row& w, int c, int c_n,
                                     const uint8_t* cp_bits,
                                     const uint8_t* gvk_bits, int gw8,
                                     const uint8_t* incomplete,
                                     const int* s_site, const int* s_cnt,
                                     int k_prev, int32_t* prev_out) {
  uint32_t prev = 0;  // int32 add with wrap-around, as the JAX scatter-add
  for (int k = 0; k < k_prev; ++k)
    if (s_site[k] == c) prev += (uint32_t)s_cnt[k];
  *prev_out = (int32_t)prev;
  const bool pm = (int32_t)prev > 0;
  const int w8 = (c_n + 7) >> 3;
  const uint8_t* bits = cp_bits + (size_t)w.cp * 2 * w8;
  const int byte = c >> 3, bit = c & 7;
  const bool aff = (bits[byte] >> bit) & 1;
  const bool taint = (bits[w8 + byte] >> bit) & 1;
  const bool gvk = (gvk_bits[(size_t)w.gv * gw8 + byte] >> bit) & 1;
  return aff && (gvk || (pm && incomplete[c])) && (taint || pm) && w.valid;
}

__global__ void fleet_masks_kernel(
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
    uint8_t* __restrict__ fr_out) {
  __shared__ int s_site[MAX_PREV], s_cnt[MAX_PREV];
  const int j = blockIdx.y;
  const Row w = load_row(rows, j, cp_idx, gvk_idx);
  load_pairs(w, prev_sites, prev_counts, k_prev, s_site, s_cnt);
  __syncthreads();
  const int32_t reps = w.valid ? replicas[w.r] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    reps_out[j] = reps;
    st_out[j] = strategy[w.r];
    fr_out[j] = (w.valid && fresh[w.r]) ? 1 : 0;
  }
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= c_n) return;
  const size_t o = (size_t)j * c_n + c;
  int32_t pv;
  feasible[o] = cell(w, c, c_n, cp_bits, gvk_bits, gw8, incomplete, s_site,
                     s_cnt, k_prev, &pv) ? 1 : 0;
  prev[o] = pv;
  static_w[o] = cp_static[(size_t)w.cp * c_n + c];
  // merge_estimates over the one profile-table answer (-1 = no answer)
  const int32_t est = prof_table[(size_t)prof_idx[w.r] * c_n + c];
  int32_t v = est == -1 ? MAX_I32 : (est < MAX_I32 ? est : MAX_I32);
  if (reps == 0) v = MAX_I32;  // non-workload short-circuit
  if (v == MAX_I32) v = reps;  // untouched sentinel -> spec.Replicas
  avail[o] = v;
}

__global__ void fleet_bits_kernel(
    const uint8_t* __restrict__ cp_bits, const uint8_t* __restrict__ gvk_bits,
    const uint8_t* __restrict__ incomplete, int c_n, int gw8,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cp_idx,
    const int32_t* __restrict__ gvk_idx,
    const int32_t* __restrict__ prev_sites,
    const int32_t* __restrict__ prev_counts, int k_prev,
    int32_t* __restrict__ words) {
  __shared__ int s_site[MAX_PREV], s_cnt[MAX_PREV];
  const int j = blockIdx.y;
  const Row w = load_row(rows, j, cp_idx, gvk_idx);
  load_pairs(w, prev_sites, prev_counts, k_prev, s_site, s_cnt);
  __syncthreads();
  // the block covers 256 columns = 8 whole words; lanes past C vote 0
  const int c = blockIdx.x * THREADS + threadIdx.x;
  int32_t pv;
  const bool f = c < c_n && cell(w, c, c_n, cp_bits, gvk_bits, gw8,
                                 incomplete, s_site, s_cnt, k_prev, &pv);
  const unsigned word = __ballot_sync(0xffffffffu, f);
  const int n_words = (c_n + 31) >> 5;
  const int wi = c >> 5;
  if ((threadIdx.x & 31) == 0 && wi < n_words)
    words[(size_t)j * n_words + wi] = (int32_t)word;
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
  if (k_prev > MAX_PREV || b_n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((c_n + THREADS - 1) / THREADS, b_n);
  fleet_masks_kernel<<<grid, THREADS, 0, stream>>>(
      cp_bits, cp_static, gvk_bits, prof_table, incomplete, c_n, gw8, rows,
      cp_idx, gvk_idx, prof_idx, replicas, strategy, fresh, prev_sites,
      prev_counts, k_prev, feasible, static_w, prev, avail, reps_out, st_out,
      fr_out);
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
  if (k_prev > MAX_PREV) return (int)cudaErrorInvalidValue;
  // rows ride grid.y in runs of 65535
  for (int j0 = 0; j0 < b_n; j0 += 65535) {
    const int nb = b_n - j0 < 65535 ? b_n - j0 : 65535;
    const dim3 grid((c_n + THREADS - 1) / THREADS, nb);
    fleet_bits_kernel<<<grid, THREADS, 0, stream>>>(
        cp_bits, gvk_bits, incomplete, c_n, gw8, rows + j0, cp_idx, gvk_idx,
        prev_sites, prev_counts, k_prev,
        words + (size_t)j0 * ((c_n + 31) >> 5));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
