// K17 first_fit_group: the ordered-failover group selection of the ranked
// ClusterAffinities path, one block per binding row.
//
// Replaces karmada_tpu/ops/masks.py:100 first_fit_group (its body,
// _first_fit_group_kernel, at masks.py:140), and with it the bool[B, T, C]
// candidate stack the JAX engine builds around the call
// (base[:, None, :] & terms[cp_idx]): this kernel combines each row's base
// mask with its placement's term masks as it reads them.
//
// For row b, u = cp_idx[b] (wrapped like a negative numpy index, then
// clamped to [0, U) as a jnp gather clamps) and
// cand[t, c] = base[b, c] & terms[u, t, c]:
//   avail_sum[t] = sum_c cand * avail[b, c]   (int64)
//   prev_sum[t]  = sum_c cand * prev[b, c]    (int64)
//   prev_full    = sum_c prev[b, c]           (every cluster, masked or not)
//   scale_down = dyn & ~fr & (prev_sum > num), scale_up with <, steady with ==
//   target     = scale_up ? num - prev_sum : num
//   w_sum      = fr ? avail_sum + prev_sum : (scale_down ? prev_full : avail_sum)
//   unsched    = dyn & ~steady & (w_sum < target)
//   fit_t      = any_c cand[t, c] & ~unsched & (t < term_len[u])
//   rank[b]    = first t with fit_t, else max(term_len[u] - 1, 0); fit[b]
//   selected[b, c] = (with_base ? base[b, c] : 1) & terms[u, rank[b], c]
// Every sum and the predicate run in int64: at 5000 clusters a sum of int32
// answers passes 2^31. (A rank at or past T, which only a term_len above T
// gives, reads term T - 1 for ``selected``; the engine never passes one.)
//
// What bounds it on an H100: bytes. A dynamic row reads avail and prev (8 B
// a cluster) and base (1 B) and writes selected (1 B); its placement's term
// masks (U x T x C bytes, a few placements a chunk) come from L2 after the
// first row that names them. At 4096 x 3 x 5000 that is about 205 MB, 0.061
// ms at 3.35 TB/s; the operations (a compare and two int64 adds a term and
// cell) are far below the integer peak. The design reads each row once per
// group of GROUP terms: a block owns a row, each thread strides over the
// clusters 4 at a time (16-byte loads of avail and prev, 4-byte loads of the
// masks) and keeps, for each term of the group, int64 partial sums and an
// any-flag in registers. A warp-shuffle reduction and then shared memory
// hand the group's totals to thread 0, which evaluates the predicate term by
// term and publishes the first fitting term; a later group is read only when
// no term of the earlier ones fits, so any T is served at a re-read a group.
// Rows whose strategy is not dynamic need only the any-flags: they read no
// avail and no prev. Terms at or past term_len are never read. After the
// barrier that publishes the rank, the block writes the row's selected mask
// from that same rank.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 8;  // terms summed in registers per pass over a row
constexpr int MAX_GRID = 65535;  // blocks; more rows take a grid stride

// W consecutive cells: W bytes of a mask packed in a uint32, W int32 loads
template <int W>
struct Cells;

template <>
struct Cells<4> {
  static __device__ __forceinline__ uint32_t mask(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ void ints(const int32_t* p, int32_t* v) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  static __device__ __forceinline__ void store(uint8_t* p, uint32_t m) {
    *reinterpret_cast<uint32_t*>(p) = m;
  }
};

template <>
struct Cells<1> {
  static __device__ __forceinline__ uint32_t mask(const uint8_t* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void ints(const int32_t* p, int32_t* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(uint8_t* p, uint32_t m) {
    *p = (uint8_t)m;
  }
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int W>
__global__ void __launch_bounds__(THREADS) first_fit_group_kernel(
    const uint8_t* __restrict__ base, const uint8_t* __restrict__ terms,
    const int32_t* __restrict__ cp_idx, const int32_t* __restrict__ term_len,
    const int32_t* __restrict__ avail, const int32_t* __restrict__ replicas,
    const int32_t* __restrict__ prev, const uint8_t* __restrict__ dynamic,
    const uint8_t* __restrict__ fresh, int b_n, int u_n, int t_n, int c_n,
    int with_base, int32_t* __restrict__ rank_out,
    uint8_t* __restrict__ fit_out, uint8_t* __restrict__ selected) {
  __shared__ long long red[WARPS][2 * GROUP + 1];  // avail, prev sums; prev_full
  __shared__ uint32_t any_red[WARPS];
  __shared__ int s_rank;  // the group's first fitting term, else -1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = c_n / W;
  for (int b = blockIdx.x; b < b_n; b += gridDim.x) {
    int u = cp_idx[b];
    if (u < 0) u += u_n;
    u = u < 0 ? 0 : (u >= u_n ? u_n - 1 : u);
    const int tl = term_len[u];
    const int live = tl < 0 ? 0 : (tl < t_n ? tl : t_n);  // terms read
    const bool dyn = dynamic[b] != 0, fr = fresh[b] != 0;
    const long long num = replicas[b];
    const uint8_t* base_row = base + (size_t)b * c_n;
    const int32_t* avail_row = avail + (size_t)b * c_n;
    const int32_t* prev_row = prev + (size_t)b * c_n;
    const uint8_t* term_rows = terms + (size_t)u * t_n * c_n;
    long long prev_full = 0;  // thread 0's, from the first group on
    int rank = -1;
    for (int g0 = 0; g0 < live && rank < 0; g0 += GROUP) {
      const int gn = live - g0 < GROUP ? live - g0 : GROUP;
      long long asum[GROUP], psum[GROUP];
#pragma unroll
      for (int t = 0; t < GROUP; ++t) asum[t] = 0, psum[t] = 0;
      long long pfull = 0;
      uint32_t any = 0;
      for (int j = tid; j < chunks; j += THREADS) {
        const size_t c0 = (size_t)j * W;
        const uint32_t bm = Cells<W>::mask(base_row + c0);
        int32_t av[W], pv[W];
        if (dyn) {
          Cells<W>::ints(avail_row + c0, av);
          Cells<W>::ints(prev_row + c0, pv);
          if (g0 == 0) {
#pragma unroll
            for (int k = 0; k < W; ++k) pfull += pv[k];
          }
        }
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          if (t < gn) {
            const uint32_t cm =
                bm & Cells<W>::mask(term_rows + (size_t)(g0 + t) * c_n + c0);
            if (cm) {
              any |= 1u << t;
              if (dyn) {
#pragma unroll
                for (int k = 0; k < W; ++k) {
                  if ((cm >> (8 * k)) & 1u) asum[t] += av[k], psum[t] += pv[k];
                }
              }
            }
          }
        }
      }
      // block reduction: warp shuffles, then one slot a warp in shared memory
#pragma unroll
      for (int t = 0; t < GROUP; ++t) {
        asum[t] = warp_sum(asum[t]);
        psum[t] = warp_sum(psum[t]);
      }
      pfull = warp_sum(pfull);
      any = __reduce_or_sync(0xffffffffu, any);
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < GROUP; ++t) red[warp][t] = asum[t], red[warp][GROUP + t] = psum[t];
        red[warp][2 * GROUP] = pfull;
        any_red[warp] = any;
      }
      __syncthreads();
      if (tid == 0) {
        uint32_t any_all = 0;
        for (int w = 0; w < WARPS; ++w) any_all |= any_red[w];
        if (g0 == 0) {
          for (int w = 0; w < WARPS; ++w) prev_full += red[w][2 * GROUP];
        }
        int found = -1;
        for (int t = 0; t < gn && found < 0; ++t) {
          long long as = 0, ps = 0;
          for (int w = 0; w < WARPS; ++w) as += red[w][t], ps += red[w][GROUP + t];
          const bool cohort = dyn && !fr;
          const bool scale_down = cohort && ps > num;
          const bool scale_up = cohort && ps < num;
          const bool steady = cohort && ps == num;
          const long long target = scale_up ? num - ps : num;
          const long long w_sum = fr ? as + ps : (scale_down ? prev_full : as);
          const bool unsched = dyn && !steady && w_sum < target;
          if (((any_all >> t) & 1u) && !unsched) found = g0 + t;
        }
        s_rank = found;
      }
      __syncthreads();
      rank = s_rank;
    }
    const bool fit = rank >= 0;
    if (!fit) rank = tl - 1 > 0 ? tl - 1 : 0;
    if (tid == 0) {
      rank_out[b] = rank;
      fit_out[b] = fit;
    }
    const uint8_t* sel_row = term_rows + (size_t)(rank < t_n ? rank : t_n - 1) * c_n;
    uint8_t* out_row = selected + (size_t)b * c_n;
    for (int j = tid; j < chunks; j += THREADS) {
      const size_t c0 = (size_t)j * W;
      const uint32_t tm = Cells<W>::mask(sel_row + c0);
      Cells<W>::store(out_row + c0, with_base ? tm & Cells<W>::mask(base_row + c0) : tm);
    }
  }
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) % to) == 0;
}

}  // namespace

// rank int32[B], fit bool[B], selected bool[B, C] of the ordered-failover
// group selection over base bool[B, C], terms bool[U, T, C], cp_idx
// int32[B], term_len int32[U], avail / prev int32[B, C], replicas int32[B],
// dynamic / fresh bool[B]
extern "C" int first_fit_group_launch(
    const uint8_t* base, const uint8_t* terms, const int32_t* cp_idx,
    const int32_t* term_len, const int32_t* avail, const int32_t* replicas,
    const int32_t* prev, const uint8_t* dynamic, const uint8_t* fresh,
    int b_n, int u_n, int t_n, int c_n, int with_base, int32_t* rank,
    uint8_t* fit, uint8_t* selected, cudaStream_t stream) {
  if (b_n < 0 || c_n < 0 || (b_n > 0 && (u_n <= 0 || t_n <= 0)))
    return (int)cudaErrorInvalidValue;
  if (b_n == 0) return 0;
  const dim3 grid(b_n < MAX_GRID ? b_n : MAX_GRID);
  // 4 cells a load when every row starts on a 16-byte (ints) or 4-byte
  // (masks) boundary, else one
  const bool vec = c_n % 4 == 0 && aligned(avail, 16) && aligned(prev, 16) &&
                   aligned(base, 4) && aligned(terms, 4) && aligned(selected, 4);
  if (vec)
    first_fit_group_kernel<4><<<grid, THREADS, 0, stream>>>(
        base, terms, cp_idx, term_len, avail, replicas, prev, dynamic, fresh,
        b_n, u_n, t_n, c_n, with_base, rank, fit, selected);
  else
    first_fit_group_kernel<1><<<grid, THREADS, 0, stream>>>(
        base, terms, cp_idx, term_len, avail, replicas, prev, dynamic, fresh,
        b_n, u_n, t_n, c_n, with_base, rank, fit, selected);
  return (int)cudaGetLastError();
}
