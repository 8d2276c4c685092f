// K1 estimate_merge: estimator availability for one binding chunk, fused.
//
// Replaces, in one pass over [B, C]:
//   karmada_tpu/ops/estimate.py:25   general_estimate (per request profile)
//   karmada_tpu/ops/estimate.py:87   general_estimate_interned, with its
//                                    row gather (estimate.py:48
//                                    gather_profile_rows) as a plain index
//   karmada_tpu/scheduler/core.py:2291-2293 / parallel/solver.py:46
//                                    no-summary clusters answer -1
//   karmada_tpu/ops/estimate.py:109  merge_estimates (one estimator)
//
//   avail[b, c] = merge(replicas[b], has_summary[c] ? est(profiles[p], c) : -1)
//   est(q, c)   = min over r with q[r] > 0 of floor(max(cap[c, r], 0) / q[r]),
//                 MAX_INT32 when q requests nothing, clamped to MAX_INT32
//   p           = prof_idx[b], wrapped like a negative numpy index and then
//                 clamped to [0, U) as a jnp gather clamps
//
// What bounds it on an H100: bytes. It writes B*C*4 bytes of int32 and reads
// little else (cap C*R*8, profiles U*R*8, B*8 of row scalars, C flags): at
// the north-star chunk (4096 x 5000) that is 82 MB, about 24 us at
// 3.35 TB/s. The int64 divisions (emulated on the card) are the only
// arithmetic of note, and the design keeps them off the B axis: a block owns
// a tile of 128 cluster columns and a run of 128 rows, computes the U x 128
// profile table of its columns into shared memory once (U*R divisions a
// thread), and then streams its rows out of that table. Each thread owns one
// column, so a warp's stores are 128 contiguous bytes. Above U_SHARED
// profiles (the un-interned schedule_step, where U == B) every element
// divides directly.
//
// Integer division: C++ '/' truncates toward zero, JAX '//' floors. They
// agree here only because both operands are clamped first, cap to >= 0 and
// the request to >= 1 (estimate.py:31-36). Keep the clamps before the
// division. The min runs in int64 and is clamped to 2^31-1 before the cast
// to int32 (estimate.py:38), so an absurd ratio reads as the sentinel and
// never wraps.
//
// Table form (profile_table_launch): karmada_tpu/scheduler/core.py:2256
// _profile_table's general branch, the fleet path's per-profile table.
// The same kernel with table_form set: row b IS profile b (no prof_idx
// gather) and the output is the estimate itself, -1 where the cluster has
// no summary (no merge). Its bound is the U x C int32 write.
//
// Merge form (estimate_merge_table_launch): karmada_tpu/scheduler/core.py:
// 2376-2385, the gathered profile table min-merged with any number E of
// extra estimates (static-assignment caps, out-of-tree estimators), in
// groups of MAX_EXTRAS: each group is one launch with its pointers as
// kernel arguments, and a group after the first reads the running minimum
// the group before it wrote (to a scratch buffer and the output in turn,
// so that the last group writes the output). A running minimum keeps
// MAX_INT32 where no answer came yet; the zero-replica short-circuit and
// the sentinel clamp run in the last group only, after the last estimate,
// as merge_estimates applies them once (estimate.py:108-122). At E <= 4 it
// is one launch; each later group reads and writes B x C once more.
//
// Rows beyond one grid: grid.y holds at most 65535 blocks of ROWS rows, so
// every entry point launches its grid once per run of 65535 * ROWS rows
// (row0 is the run's first row); today's chunks need one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_C = 128;   // cluster columns per block (one per thread)
constexpr int ROWS = 128;     // binding rows per block
constexpr int U_SHARED = 64;  // profiles held in the shared-memory table
constexpr long long MAX_I32 = 2147483647LL;
constexpr int MAX_EXTRAS = 4;  // extra estimates a merge-form launch takes
constexpr int MAX_GRID_Y = 65535;  // the grid's y extent
constexpr long long RUN_ROWS = (long long)MAX_GRID_Y * ROWS;  // rows a launch covers

__device__ __forceinline__ int32_t profile_estimate(
    const int64_t* __restrict__ cap_row, const int64_t* __restrict__ req,
    int r_dims) {
  long long best = MAX_I32;
  for (int r = 0; r < r_dims; ++r) {
    const long long q = req[r];
    if (q > 0) {
      long long c = cap_row[r];
      c = c > 0 ? c : 0;  // clamp before dividing: '/' == floor for c >= 0
      const long long ratio = c / q;  // q > 0, so max(q, 1) == q
      best = ratio < best ? ratio : best;
    }
  }
  return (int32_t)(best < MAX_I32 ? best : MAX_I32);
}

__global__ void estimate_merge_kernel(
    const int64_t* __restrict__ cap, int c_n, int r_dims,
    const int64_t* __restrict__ profiles, int u_n,
    const int32_t* __restrict__ prof_idx,
    const uint8_t* __restrict__ has_summary,
    const int32_t* __restrict__ replicas, int b_n,
    int32_t* __restrict__ out, int table_form, int row0) {
  extern __shared__ int32_t table[];  // [min(U, U_SHARED)][TILE_C]
  const int tx = threadIdx.x;
  const int c = blockIdx.x * TILE_C + tx;
  if (c >= c_n) return;
  const int64_t* cap_row = cap + (size_t)c * r_dims;
  const bool summary = has_summary[c] != 0;
  const bool use_table = !table_form && u_n <= U_SHARED;
  if (use_table) {
    // each thread fills and later reads only its own column: no barrier
    for (int u = 0; u < u_n; ++u)
      table[u * TILE_C + tx] =
          profile_estimate(cap_row, profiles + (size_t)u * r_dims, r_dims);
  }
  const int b0 = row0 + blockIdx.y * ROWS;
  const int b1 = min(b0 + ROWS, b_n);
  for (int b = b0; b < b1; ++b) {
    if (table_form) {  // one row per profile, no gather and no merge
      out[(size_t)b * c_n + c] =
          summary ? profile_estimate(cap_row, profiles + (size_t)b * r_dims,
                                     r_dims)
                  : -1;
      continue;
    }
    int p = prof_idx[b];
    if (p < 0) p += u_n;
    p = p < 0 ? 0 : (p >= u_n ? u_n - 1 : p);
    int32_t est = use_table
        ? table[p * TILE_C + tx]
        : profile_estimate(cap_row, profiles + (size_t)p * r_dims, r_dims);
    if (!summary) est = -1;                    // UnauthenticReplica
    const int32_t reps = replicas[b];
    int32_t v = est == -1 ? (int32_t)MAX_I32 : est;  // min over answers
    if (reps == 0) v = (int32_t)MAX_I32;       // non-workload short-circuit
    if (v == (int32_t)MAX_I32) v = reps;       // untouched sentinel
    out[(size_t)b * c_n + c] = v;
  }
}

__global__ void estimate_merge_table_kernel(
    const int32_t* __restrict__ table, int u_n, int c_n,
    const int32_t* __restrict__ prof_inv, const int32_t* __restrict__ acc,
    const int32_t* __restrict__ e0, const int32_t* __restrict__ e1,
    const int32_t* __restrict__ e2, const int32_t* __restrict__ e3, int e_n,
    const int32_t* __restrict__ replicas, int b_n, int last,
    int32_t* __restrict__ out, int row0) {
  const int c = blockIdx.x * TILE_C + threadIdx.x;
  if (c >= c_n) return;
  const int32_t* extras[MAX_EXTRAS] = {e0, e1, e2, e3};
  const int b0 = row0 + blockIdx.y * ROWS;
  const int b1 = min(b0 + ROWS, b_n);
  for (int b = b0; b < b1; ++b) {
    const size_t o = (size_t)b * c_n + c;
    int32_t v, est;  // min over answers, -1 ignored
    if (acc) {
      v = acc[o];  // the earlier groups' running minimum
    } else {
      int p = prof_inv[b];
      if (p < 0) p += u_n;
      p = p < 0 ? 0 : (p >= u_n ? u_n - 1 : p);
      v = (int32_t)MAX_I32;
      est = table[(size_t)p * c_n + c];
      if (est != -1) v = est < v ? est : v;
    }
#pragma unroll
    for (int e = 0; e < MAX_EXTRAS; ++e) {
      if (e < e_n) {
        est = extras[e][o];
        if (est != -1) v = est < v ? est : v;
      }
    }
    if (last) {  // once, after the last estimate
      const int32_t reps = replicas[b];
      if (reps == 0) v = (int32_t)MAX_I32;  // non-workload short-circuit
      if (v == (int32_t)MAX_I32) v = reps;  // untouched sentinel
    }
    out[o] = v;
  }
}

// the grid of rows [row0, min(row0 + RUN_ROWS, b_n))
dim3 run_grid(int c_n, int b_n, long long row0) {
  const long long rows = b_n - row0 < RUN_ROWS ? b_n - row0 : RUN_ROWS;
  return dim3((c_n + TILE_C - 1) / TILE_C, (unsigned)((rows + ROWS - 1) / ROWS));
}

}  // namespace

extern "C" int estimate_merge_launch(
    const int64_t* cap, int c_n, int r_dims, const int64_t* profiles, int u_n,
    const int32_t* prof_idx, const uint8_t* has_summary,
    const int32_t* replicas, int b_n, int32_t* out, cudaStream_t stream) {
  if (b_n == 0 || c_n == 0) return 0;
  const size_t smem =
      u_n <= U_SHARED ? (size_t)u_n * TILE_C * sizeof(int32_t) : 0;
  for (long long row0 = 0; row0 < b_n; row0 += RUN_ROWS) {
    estimate_merge_kernel<<<run_grid(c_n, b_n, row0), TILE_C, smem, stream>>>(
        cap, c_n, r_dims, profiles, u_n, prof_idx, has_summary, replicas, b_n,
        out, 0, (int)row0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out int32[U, C] = has_summary ? general_estimate(profiles[u], c) : -1
extern "C" int profile_table_launch(
    const int64_t* cap, int c_n, int r_dims, const int64_t* profiles, int u_n,
    const uint8_t* has_summary, int32_t* out, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  for (long long row0 = 0; row0 < u_n; row0 += RUN_ROWS) {
    estimate_merge_kernel<<<run_grid(c_n, u_n, row0), TILE_C, 0, stream>>>(
        cap, c_n, r_dims, profiles, u_n, nullptr, has_summary, nullptr, u_n,
        out, 1, (int)row0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out int32[B, C] = merge_estimates(replicas, (table[prof_inv], *extras))
// for any E = e_n >= 0 extra estimates; extras is a host array of E device
// pointers; scratch is an int32[B, C] buffer, used (and non-null) only when
// E > MAX_EXTRAS
extern "C" int estimate_merge_table_launch(
    const int32_t* table, int u_n, int c_n, const int32_t* prof_inv,
    const int32_t* const* extras, int e_n, const int32_t* replicas, int b_n,
    int32_t* scratch, int32_t* out, cudaStream_t stream) {
  const int groups = e_n > MAX_EXTRAS ? (e_n + MAX_EXTRAS - 1) / MAX_EXTRAS : 1;
  if (e_n < 0 || (e_n > 0 && extras == nullptr) || (groups > 1 && scratch == nullptr) ||
      (b_n > 0 && u_n <= 0))
    return (int)cudaErrorInvalidValue;
  if (b_n == 0 || c_n == 0) return 0;
  const int32_t* acc = nullptr;
  for (int g = 0; g < groups; ++g) {
    const int first = g * MAX_EXTRAS;
    const int n = e_n - first < MAX_EXTRAS ? e_n - first : MAX_EXTRAS;
    const int32_t* e[MAX_EXTRAS] = {nullptr, nullptr, nullptr, nullptr};
    for (int k = 0; k < n; ++k) e[k] = extras[first + k];
    // the last group writes out, the one before it scratch, and so on
    int32_t* dst = (groups - 1 - g) % 2 == 0 ? out : scratch;
    for (long long row0 = 0; row0 < b_n; row0 += RUN_ROWS) {
      estimate_merge_table_kernel<<<run_grid(c_n, b_n, row0), TILE_C, 0, stream>>>(
          table, u_n, c_n, prof_inv, acc, e[0], e[1], e[2], e[3], n, replicas,
          b_n, g == groups - 1, dst, (int)row0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    acc = dst;
  }
  return 0;
}
