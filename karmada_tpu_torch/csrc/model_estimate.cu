// K7 model_overlay: the resource-model grade estimate per (profile, cluster),
// written over the engine's profile table.
//
// Replaces karmada_tpu/models/modeling.py:72 estimate_by_models as the model
// branch of karmada_tpu/scheduler/core.py:2256 _profile_table (:2263-2293)
// runs it.
//
// For one request row q and one cluster c with G grades of R min bounds:
//   first[r]  = the first grade g with mb[c,g,r] >= q[r] and mb[c,g,r] >= 0,
//               G if none (jnp.argmax of a bool: the first true)
//   idx       = max over requested r (q[r] > 0) of first[r]; 0 if none
//   per[g]    = min over requested r of floor(max(mb[c,g,r], 0) / q[r]);
//               2^62 if none requested, and any value >= 2^62 reads as 0;
//               then at least 1 (general.go:226-231)
//   total     = idx >= G ? 0 : sum over g >= idx of counts[c,g] * per[g]
//   out       = int32(min(total, 2^31-1)),  applicable = every requested r
//               is covered[c,r]
//
// int64 wrap-around: counts * per and their sum are int64 in JAX and wrap.
// Signed overflow is undefined in C++, so both run in uint64 (the same bits)
// and the sum is reinterpreted as signed before JAX's min with 2^31-1; the
// cast to int32 then keeps the low 32 bits, as XLA's convert does for a
// wrapped negative. Division: both operands are clamped non-negative first
// (max(mb, 0) and a request > 0), so C++'s truncation equals JAX's floor.
//
// The engine's profile table, written by K1's table form, is updated in
// place (model_overlay_launch):
//   table = has_summary ? (has_models & applicable ? min(model, pods) : table)
//                       : -1
// with the requests' pods column counted as 0 (models never declare the
// implicit pods dimension) and pods = min(max(cap[c, pods], 0), 2^31-1),
// the allowed-pods cap. No-summary columns stay -1: the JAX engine applies
// the overlay before its -1 mask, and a cluster may have models but no
// summary.
//
// What bounds it on an H100: operations, and few of them at the engine's
// shapes (U <= a few thousand profiles, C = 5000, G = 9, R = 4). One
// thread per (profile, cluster) cell, so even the fleet's 8 profiles give
// 320 blocks: a block is 128 cluster columns of one profile row; each
// thread reads its cluster's G x R bounds (288 bytes at G = 9, R = 4) from
// global memory (the whole pack is 1.4 MB and stays in L2), and the grade
// walk stops at the first compliant grade. The int64 divisions (G x R per
// cell, emulated on the card) are the arithmetic of note. Output writes are
// coalesced along the column tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_C = 128;  // cluster columns per block (one per thread)
constexpr long long MAX_I32 = 2147483647LL;
constexpr long long SENTINEL = 1LL << 62;

// (total, applicable) of one request row against one cluster's grades;
// column pods_dim of the request counts as 0 (-1: no such column)
__device__ __forceinline__ int32_t model_cell(
    const int64_t* __restrict__ mb, const int32_t* __restrict__ counts,
    const uint8_t* __restrict__ covered, const int64_t* __restrict__ req,
    int g_n, int r_dims, int pods_dim, bool* applicable) {
  int idx = 0;
  bool app = true;
  for (int r = 0; r < r_dims; ++r) {
    const long long q = r == pods_dim ? 0 : req[r];
    if (q <= 0) continue;
    if (!covered[r]) app = false;
    int first = g_n;
    for (int g = 0; g < g_n; ++g) {
      const long long m = mb[g * r_dims + r];
      if (m >= q && m >= 0) {
        first = g;
        break;
      }
    }
    idx = first > idx ? first : idx;
  }
  *applicable = app;
  if (idx >= g_n) return 0;
  unsigned long long total = 0;
  for (int g = idx; g < g_n; ++g) {
    long long per = SENTINEL;
    for (int r = 0; r < r_dims; ++r) {
      const long long q = r == pods_dim ? 0 : req[r];
      if (q <= 0) continue;
      long long m = mb[g * r_dims + r];
      m = m > 0 ? m : 0;  // clamp before dividing: '/' == floor here
      const long long ratio = m / q;
      per = ratio < per ? ratio : per;
    }
    if (per >= SENTINEL) per = 0;
    if (per < 1) per = 1;
    total += (unsigned long long)(long long)counts[g] * (unsigned long long)per;
  }
  long long s = (long long)total;  // the wrapped int64 sum
  s = s < MAX_I32 ? s : MAX_I32;
  return (int32_t)(uint32_t)(unsigned long long)s;
}

// the model answer over the general one, in place on table
__global__ void model_overlay_kernel(
    const int64_t* __restrict__ mb, const int32_t* __restrict__ counts,
    const uint8_t* __restrict__ covered, int c_n, int g_n, int r_dims,
    const int64_t* __restrict__ req, const uint8_t* __restrict__ has_models,
    const uint8_t* __restrict__ has_summary, const int64_t* __restrict__ cap,
    int pods_dim, int32_t* __restrict__ table) {
  const int c = blockIdx.x * TILE_C + threadIdx.x;
  if (c >= c_n) return;
  const int u = blockIdx.y;
  const size_t o = (size_t)u * c_n + c;
  const int64_t* mb_c = mb + (size_t)c * g_n * r_dims;
  const int32_t* counts_c = counts + (size_t)c * g_n;
  const uint8_t* covered_c = covered + (size_t)c * r_dims;
  const int64_t* req_u = req + (size_t)u * r_dims;
  bool app;
  if (!has_summary[c]) {
    table[o] = -1;
    return;
  }
  if (!has_models[c]) return;  // the general answer stands
  int32_t t = model_cell(mb_c, counts_c, covered_c, req_u, g_n, r_dims,
                         pods_dim, &app);
  if (!app) return;
  if (pods_dim >= 0) {
    long long p = cap[(size_t)c * r_dims + pods_dim];
    p = p > 0 ? p : 0;
    const int32_t pods_cap = (int32_t)(p < MAX_I32 ? p : MAX_I32);
    t = t < pods_cap ? t : pods_cap;
  }
  table[o] = t;
}

}  // namespace

// table int32[U, C], in place: the model answer over the general one
extern "C" int model_overlay_launch(
    const int64_t* mb, const int32_t* counts, const uint8_t* covered, int c_n,
    int g_n, int r_dims, const int64_t* req, int u_n,
    const uint8_t* has_models, const uint8_t* has_summary, const int64_t* cap,
    int pods_dim, int32_t* table, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  const dim3 grid((c_n + TILE_C - 1) / TILE_C, u_n);
  model_overlay_kernel<<<grid, TILE_C, 0, stream>>>(
      mb, counts, covered, c_n, g_n, r_dims, req, has_models, has_summary, cap,
      pods_dim, table);
  return (int)cudaGetLastError();
}
