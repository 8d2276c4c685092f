// K8 node_sum: the accurate estimator's node-level MaxAvailableReplicas.
//
// Replaces karmada_tpu/estimator/accurate.py:226 _node_sum_kernel as jitted
// by :255 _node_sum_estimate (ref: pkg/estimator/server/estimate.go:59-112):
//
//   per[b, n] = min over dims r with req[b, r] > 0 of
//               floor(max(avail[n, r], 0) / req[b, r]);
//               2^62 when row b requests nothing, and any value >= 2^62
//               reads as 0
//   out[b]    = int32(min(sum over n with node_ok[b, n] of per[b, n],
//                         2^31-1))
//
// int64 wrap-around: the sum over up to thousands of nodes is int64 in JAX
// and wraps. Signed overflow is undefined in C++, so the sum runs in uint64
// (the same bits, and wrap-around addition is associative, so the order of
// the block reduction cannot change them), is reinterpreted as signed for
// JAX's min with 2^31-1, and the cast keeps the low 32 bits, as XLA's
// convert does for a wrapped negative. Division: avail is clamped to >= 0
// and the request is > 0, so C++'s truncation equals JAX's floor.
//
// What bounds it on an H100: bytes at the estimator server's batch (4096
// profile rows x 5000 nodes: the B x N prefilter mask is 20 MB, the node
// table 160 KB and stays in L2), and the int64 divisions (emulated on the
// card, up to R per cell) close behind. The design: one block per request
// row; its threads stride over the nodes (neighbouring threads read
// neighbouring mask bytes), each keeps a uint64 partial sum, and a warp
// shuffle plus one shared-memory step reduce them. One block per row needs
// no atomics, no zeroed scratch and no second pass; at the estimator
// phase's 8 rows x 4000 nodes the whole launch is a few microseconds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_I32 = 2147483647LL;
constexpr long long SENTINEL = 1LL << 62;

__global__ void node_sum_kernel(const int64_t* __restrict__ avail, int n_nodes,
                                int r_dims,
                                const uint8_t* __restrict__ node_ok,
                                const int64_t* __restrict__ req,
                                int32_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int64_t* q = req + (size_t)b * r_dims;
  const uint8_t* ok = node_ok + (size_t)b * n_nodes;
  unsigned long long sum = 0;
  for (int n = threadIdx.x; n < n_nodes; n += THREADS) {
    if (!ok[n]) continue;
    long long per = SENTINEL;
    for (int r = 0; r < r_dims; ++r) {
      const long long qr = q[r];
      if (qr <= 0) continue;
      long long a = avail[(size_t)n * r_dims + r];
      a = a > 0 ? a : 0;  // clamp before dividing: '/' == floor here
      const long long ratio = a / qr;
      per = ratio < per ? ratio : per;
    }
    if (per >= SENTINEL) per = 0;  // no requested dim
    sum += (unsigned long long)per;
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  __shared__ unsigned long long warp_sums[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    long long s = (long long)total;  // the wrapped int64 sum
    s = s < MAX_I32 ? s : MAX_I32;
    out[b] = (int32_t)(uint32_t)(unsigned long long)s;
  }
}

}  // namespace

// out int32[B] = node-sum estimate of req int64[B, R] over avail int64[N, R]
// and node_ok bool[B, N]
extern "C" int node_sum_launch(const int64_t* avail, int n_nodes, int r_dims,
                               const uint8_t* node_ok, const int64_t* req,
                               int b_n, int32_t* out, cudaStream_t stream) {
  if (b_n == 0) return 0;
  node_sum_kernel<<<b_n, THREADS, 0, stream>>>(avail, n_nodes, r_dims,
                                               node_ok, req, out);
  return (int)cudaGetLastError();
}
