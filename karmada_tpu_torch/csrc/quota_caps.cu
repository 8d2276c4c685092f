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
// What bounds it on an H100: bytes. One thread per output cell; a thread
// reads its row's R requests (the same for a whole block row, from L1) and
// its cluster's R caps (N x C x R x 8 bytes: 160 KB per capped namespace at
// C = 5000, R = 4, L2-resident), and writes one int32. At the general
// route's chunk (4096 x 5000) the output is 82 MB; the int64 division (R
// per cell, emulated on the card) is the arithmetic of note.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_I32 = 2147483647LL;
constexpr long long UNLIMITED = 1LL << 62;

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
  best = best < MAX_I32 ? best : MAX_I32;
  return (int32_t)(uint32_t)(unsigned long long)best;
}

__global__ void quota_caps_kernel(const int64_t* __restrict__ caps, int n_caps,
                                  int c_n, int r_dims,
                                  const int32_t* __restrict__ ns_rows,
                                  const int64_t* __restrict__ req, int b_n,
                                  int32_t* __restrict__ out) {
  const size_t cell = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (cell >= (size_t)b_n * c_n) return;
  const int b = (int)(cell / c_n);
  const int c = (int)(cell - (size_t)b * c_n);
  out[cell] = cap_cell(caps, n_caps, c_n, r_dims, ns_rows[b],
                       req + (size_t)b * r_dims, c);
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

}  // namespace

// out int32[B, C] = quota_cluster_caps(caps, ns_rows, req)
extern "C" int quota_caps_launch(const int64_t* caps, int n_caps, int c_n,
                                 int r_dims, const int32_t* ns_rows,
                                 const int64_t* req, int b_n, int32_t* out,
                                 cudaStream_t stream) {
  const size_t cells = (size_t)b_n * c_n;
  if (cells == 0) return 0;
  quota_caps_kernel<<<blocks_for(cells), THREADS, 0, stream>>>(
      caps, n_caps, c_n, r_dims, ns_rows, req, b_n, out);
  return (int)cudaGetLastError();
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
