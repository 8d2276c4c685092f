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
// (the same bits, and wrap-around addition is associative and commutative,
// so neither the order of the reductions nor the blocks it is split over
// can change them), is reinterpreted as signed for JAX's min with 2^31-1,
// and the cast keeps the low 32 bits, as XLA's convert does for a wrapped
// negative. Division: avail is clamped to >= 0 and the request is > 0, so
// floor is truncation.
//
// What bounds it on an H100: by its bytes, the B x N prefilter mask, the
// only large input (20 MB at the estimator server's 4096 profile rows x 5000
// nodes, ~6 us at HBM rate); in practice the issue of the work each cell
// needs: a 64-bit division per requested dim, which the card emulates in
// tens of dependent instructions, and at the estimator's 8 x 4000 the
// launch and a few dependent memory round trips. The design:
//
// - Division by an invariant divisor (Granlund-Montgomery, divmagic.cuh).
//   Within a row the divisor of dim r is the same for every node, so each
//   block computes its multiplier and shift once per (row, dim), and each
//   cell costs one high product, a shift and a min per requested dim,
//   whatever the data. (A float32 pre-compare of the dims, exact through
//   this multiplier only where the float could not decide, was faster on
//   uniform headroom but slower wherever ratios tie or are exact integers.)
// - Reuse of the node table: a block takes a tile of rows against a range
//   of nodes; the range's avail is staged once in shared memory, clamped,
//   doubled and transposed (dim-major, so neighbouring lanes read
//   neighbouring words; padded with zeros to whole 128-node chunks, so the
//   inner loop has no bounds test), and every row of the tile reads it
//   there. A chunk's node_ok bytes load while its dims compute; the
//   requests and the first tile are in flight together, then the
//   multipliers are computed. Three blocks an SM (80 registers) hide the
//   loads' latency better than two at the compiler's own choice.
// - Any number of dims: the dims are taken in groups of at most G_MAX (one
//   group up to G_MAX dims); past one group, each cell's running min lives
//   in shared memory between the groups, and each group's tile and
//   multipliers are staged in turn.
// - Parallelism at the estimator's 8 x 4000: a row's nodes are spread over
//   a thread-block cluster of up to 8 blocks, and the tile shrinks to one
//   row, so the launch fills 64 SMs instead of 8. The blocks' uint64 partial
//   sums meet in the first block's shared memory through the cluster's
//   distributed shared memory: one launch, no zeroed scratch, no atomics in
//   device memory.
// - Inside a block a warp takes a row and walks its 128-node chunks, 4
//   nodes a lane, so the per-(row, dim) multiplier is one broadcast read
//   for 4 cells.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "divmagic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NPL = 4;              // nodes a lane in one unit
constexpr int CHUNK = 32 * NPL;     // nodes a unit
constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int MAX_TB = 32;          // rows a block
constexpr int G_MAX = 40;          // dims a group
constexpr int TILE_BYTES = 64 * 1024;  // staged avail a block
constexpr long long MAX_I32 = 2147483647LL;
constexpr unsigned long long SENTINEL = 1ULL << 62;

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// grid: clusters of `csize` blocks along x, one cluster per tile of `tb`
// rows; block `rank` of a cluster takes nodes [rank * nb, (rank + 1) * nb),
// `nt` (a multiple of CHUNK) at a time, and the dims `g` at a time.
__global__ void __launch_bounds__(THREADS, 3)
node_sum_kernel(const int64_t* __restrict__ avail, int n_nodes, int r_dims,
                const uint8_t* __restrict__ node_ok, const int64_t* __restrict__ req,
                int b_n, int tb, int nb, int nt, int g, int32_t* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ unsigned long long row_part[MAX_TB];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / csize) * tb;
  const int rows = min(tb, b_n - row0);
  const int n_lo = min(n_nodes, rank * nb);
  const int n_hi = min(n_nodes, n_lo + nb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool grouped = g < r_dims;

  // shared memory: mult[tb * g] | tile[g * nt] | best[tb * nt] (grouped) |
  // shift[tb * g]
  unsigned long long* mult = smem;
  unsigned long long* tile = mult + tb * g;
  unsigned long long* best = tile + (size_t)g * nt;
  int* shift = reinterpret_cast<int*>(best + (grouped ? (size_t)tb * nt : 0));

  // a warp's rows: warp, warp + WARPS, ... with tb >= WARPS; else one row,
  // whose chunks its wr warps split
  const int wr = tb >= WARPS ? 1 : WARPS / tb;
  const int i_first = tb >= WARPS ? warp : warp / wr;
  const int i_step = tb >= WARPS ? WARPS : tb;
  const int part = warp % wr;

  // dims [g0, g0 + g) of the tile [t0, t1)'s avail, dim-major, clamped and
  // doubled; its padding (nodes past t1, dims past r_dims) zero; loads 8 at
  // a time
  auto stage = [&](int t0, int t1, int g0) {
    const int cells = nt * g;
    for (int e0 = 0; e0 < cells; e0 += 8 * THREADS) {
      long long a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * THREADS + threadIdx.x;
        const int n = e / g, r = e - n * g;
        a[j] = e < cells && n < t1 - t0 && g0 + r < r_dims
                   ? avail[(size_t)(t0 + n) * r_dims + g0 + r] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * THREADS + threadIdx.x;
        if (e < cells) {
          const int n = e / g;
          tile[(size_t)(e - n * g) * nt + n] = (unsigned long long)(a[j] > 0 ? a[j] : 0) << 1;
        }
      }
    }
  };

  // the requests of dims [g0, g0 + g) (pair p: row p / g, dim p % g), then
  // their multipliers and shifts; m = 0 marks a dim not requested
  constexpr int PAIRS = MAX_TB * G_MAX / THREADS;  // pairs a thread at most
  long long d_of[PAIRS];
  auto load_req = [&](int g0) {
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int p = threadIdx.x + j * THREADS;
      const int i = p / g, r = p - i * g;
      d_of[j] = p < tb * g && i < rows && g0 + r < r_dims
                    ? req[(size_t)(row0 + i) * r_dims + g0 + r] : 0;
    }
  };
  auto set_multipliers = [&]() {
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int p = threadIdx.x + j * THREADS;
      if (p < tb * g) {
        unsigned long long m = 0;
        int l = 0;
        if (d_of[j] > 0) magic((unsigned long long)d_of[j], m, l);
        mult[p] = m;
        shift[p] = l;
      }
    }
  };

  // in flight together: the requests and the first tile; then the
  // multipliers
  load_req(0);
  stage(n_lo, min(n_hi, n_lo + nt), 0);
  set_multipliers();
  if (threadIdx.x < MAX_TB) row_part[threadIdx.x] = 0;
  __syncthreads();

  for (int t0 = n_lo; t0 < n_hi; t0 += nt) {
    const int t1 = min(n_hi, t0 + nt);
    for (int g0 = 0; g0 < r_dims; g0 += g) {
      if (t0 != n_lo || g0 != 0) {
        __syncthreads();  // the previous tile is consumed
        if (grouped) load_req(g0);
        stage(t0, t1, g0);
        if (grouped) set_multipliers();
        __syncthreads();
      }
      const bool last = g0 + g >= r_dims;  // the cell's min is whole
      for (int i = i_first; i < rows; i += i_step) {
        const uint8_t* ok = node_ok + (size_t)(row0 + i) * n_nodes + t0 + lane;
        unsigned long long acc = 0;
        for (int c = part * CHUNK; c < t1 - t0; c += wr * CHUNK) {
          // the chunk's mask bytes load over its dims
          bool live[NPL];
          unsigned long long mn[NPL];
#pragma unroll
          for (int p = 0; p < NPL; ++p) {
            live[p] = last && c + p * 32 + lane < t1 - t0 && ok[c + p * 32];
            mn[p] = g0 ? best[(size_t)i * nt + c + p * 32 + lane] : ~0ULL;
          }
          for (int r = 0; r < g; ++r) {
            const unsigned long long m = mult[i * g + r];
            if (m == 0) continue;  // not requested: uniform over the warp
            const int l = shift[i * g + r];
            const unsigned long long* col = tile + (size_t)r * nt + c + lane;
#pragma unroll
            for (int p = 0; p < NPL; ++p) mn[p] = umin64(mn[p], __umul64hi(m, col[p * 32]) >> l);
          }
#pragma unroll
          for (int p = 0; p < NPL; ++p) {
            if (!last) best[(size_t)i * nt + c + p * 32 + lane] = mn[p];
            acc += live[p] && mn[p] < SENTINEL ? mn[p] : 0ULL;  // >= 2^62 reads as 0
          }
        }
        if (last) {
          // the row's partial: the lanes, then one shared-memory add a warp
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (lane == 0 && acc) atomicAdd(&row_part[i], acc);
        }
      }
    }
  }

  // the blocks of the cluster meet in the first block's row_part
  cluster.sync();
  if (rank == 0 && threadIdx.x < rows) {
    unsigned long long total = 0;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)  // the reads in flight together
      total += k < csize ? cluster.map_shared_rank(row_part, k)[threadIdx.x] : 0ULL;
    long long s = (long long)total;  // the wrapped int64 sum
    s = s < MAX_I32 ? s : MAX_I32;
    out[row0 + threadIdx.x] = (int32_t)(uint32_t)(unsigned long long)s;
  }
  cluster.sync();  // the other blocks' row_part stays alive until read
}

struct Shape {
  int csize, tb, nb, nt, g;
  size_t smem;
};

Shape shape_of(int n_nodes, int r_dims, int b_n) {
  Shape s;
  s.csize = (n_nodes + 255) / 256;
  s.csize = s.csize < 1 ? 1 : (s.csize > MAX_CLUSTER ? MAX_CLUSTER : s.csize);
  s.nb = (n_nodes + s.csize - 1) / s.csize;
  s.nb = (s.nb + CHUNK - 1) / CHUNK * CHUNK;
  if (s.nb < CHUNK) s.nb = CHUNK;
  // rows a block: the most (up to 32) that still leaves two blocks an SM
  s.tb = 1;
  for (int tb = MAX_TB; tb > 1; tb >>= 1) {
    if ((long long)((b_n + tb - 1) / tb) * s.csize >= 2 * 132) {
      s.tb = tb;
      break;
    }
  }
  // dims a group: all of them up to G_MAX, else as even groups as fit
  const int groups = r_dims > G_MAX ? (r_dims + G_MAX - 1) / G_MAX : 1;
  s.g = r_dims > 0 ? (r_dims + groups - 1) / groups : 1;
  // a tile: TILE_BYTES of avail (and of running mins, past one group)
  const int per_node = 8 * s.g + (groups > 1 ? 8 * s.tb : 0);
  const int fit = TILE_BYTES / per_node / CHUNK * CHUNK;
  s.nt = fit < CHUNK ? CHUNK : fit;
  s.nt = s.nt < s.nb ? s.nt : s.nb;
  s.smem = (size_t)s.tb * s.g * (8 + 4) + (size_t)s.nt * per_node;
  return s;
}

template <typename Kernel, typename... Args>
int launch_clustered(Kernel kernel, int blocks, int csize, size_t smem, cudaStream_t stream,
                     Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// out int32[B] = node-sum estimate of req int64[B, R] over avail int64[N, R]
// and node_ok bool[B, N]
extern "C" int node_sum_launch(const int64_t* avail, int n_nodes, int r_dims,
                               const uint8_t* node_ok, const int64_t* req,
                               int b_n, int32_t* out, cudaStream_t stream) {
  if (b_n == 0) return 0;
  const Shape s = shape_of(n_nodes, r_dims, b_n);
  if (s.smem > 48 * 1024) {  // at most 87 KB (32 rows x 40 dims, grouped)
    const int err = (int)cudaFuncSetAttribute(
        node_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err) return err;
  }
  const int err = launch_clustered(node_sum_kernel, (b_n + s.tb - 1) / s.tb * s.csize, s.csize,
                                   s.smem, stream, avail, n_nodes, r_dims, node_ok, req, b_n,
                                   s.tb, s.nb, s.nt, s.g, out);
  if (err) return err;
  return (int)cudaGetLastError();
}
