// K2 divide_replicas: the unified replica division of one binding chunk.
//
// Replaces:
//   karmada_tpu/ops/divide.py:110    _divide_one (all four strategies,
//                                    fresh / scale-up / scale-down / steady)
//   karmada_tpu/ops/divide.py:233    divide_replicas (its vmap over rows)
//   karmada_tpu/ops/divide.py:52     _aggregated_prefix_mask
//   karmada_tpu/ops/dispense.py:54   take_by_weight (largest remainder),
//                                    :240 take_by_weight_batch, and :101
//                                    take_by_weight_fast, which is proven
//                                    identical to the wide form under its
//                                    gates, so only the wide form lives here
//
// One thread block per binding row. The block computes the JAX kernel's
// wide (int64-accumulating) arithmetic literally, int32 wrap-around
// included, so it equals divide.py for every int32 input and not only for
// the ranges the engine feeds it:
//   1. block sums over C: assigned (candidate prev), the full prev, the
//      candidate avail, the fresh weights avail+prev, the static weights;
//      from them the cohort (steady / scale-up / scale-down / fresh) and the
//      unschedulable verdict (sum of dynamic weights < target, in int64);
//   2. Aggregated rows: the minimal (prev desc, avail desc, idx asc) prefix
//      whose availability covers the target (divide.py:95-107);
//   3. weights, lastReplicas and init per strategy, then floors
//      w*num // sum(w) in int64 and remain = num - sum(floors);
//   4. the remain-th largest (w desc, last desc, idx asc) tuple as the bonus
//      threshold (dispense.py:81-91), then the steady, duplicated,
//      unschedulable and zero-replica overrides.
//
// The two orders are strict total orders. The dispense order is a tuple of
// two int32 and an index, 78 bits, which no 64-bit word holds: it is sorted
// as (uint64 key, uint16 idx) pairs and compared as a tuple, never as a
// truncated packed key. The Aggregated order (1 + 32 + 14 bits) packs into
// one uint64. Both sort by a block-level bitonic network in dynamic shared
// memory, N = next power of two >= C: 10 bytes an element, so C <= 16384
// (the 10,000-cluster sharded tier fits). Rows that need no bonus (remain 0,
// zero weights, steady, duplicated, unschedulable) and non-Aggregated rows
// skip the sorts. The keys negate int32 values with wrap-around exactly as
// lax.sort sees -weights and -last, so INT32_MIN orders as it does in JAX.
//
// What bounds it on an H100: bytes. It must read candidates (1 B), static_w,
// avail and prev (4 B each) for every element, 9 B of row scalars, and write
// the int32 assignment and one flag a row: 17*B*C + 10*B bytes, about 348 MB
// and 104 us at 3.35 TB/s for the north-star chunk (4096 x 5000). The row's
// inputs are re-read from L1/L2 by each pass instead of held in registers;
// the sorts cost about log2(N)^2/2 shared-memory stages for the rows that
// need them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DUPLICATED = 0;
constexpr int STATIC_WEIGHT = 1;
constexpr int DYNAMIC_WEIGHT = 2;
constexpr int AGGREGATED = 3;
constexpr unsigned long long PAD_KEY = ~0ull;
constexpr uint16_t PAD_IDX = 0xffff;

// int32 arithmetic with two's-complement wrap-around, as XLA computes it
__device__ __forceinline__ int32_t wrap32(long long v) {
  return (int32_t)(uint32_t)(unsigned long long)v;
}
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t neg32(int32_t v) {
  return (int32_t)(0u - (uint32_t)v);
}
// signed int32 order as unsigned order, and back
__device__ __forceinline__ uint32_t ord32(int32_t v) {
  return (uint32_t)v ^ 0x80000000u;
}
__device__ __forceinline__ int32_t unord32(uint32_t u) {
  return (int32_t)(u ^ 0x80000000u);
}
// floor division for d > 0 (C++ '/' truncates toward zero)
__device__ __forceinline__ long long floordiv(long long a, long long d) {
  long long q = a / d;
  if (a % d != 0 && a < 0) --q;
  return q;
}

// block-wide int64 sum, returned to every thread
__device__ long long block_sum(long long v, long long* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < WARPS ? scratch[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) scratch[WARPS] = s;
  }
  __syncthreads();
  const long long total = scratch[WARPS];
  __syncthreads();
  return total;
}

// block-wide exclusive prefix sum of one int64 per thread, in thread order
__device__ long long block_exclusive_scan(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < WARPS ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) scratch[lane] = s;
  }
  __syncthreads();
  const long long res = (warp > 0 ? scratch[warp - 1] : 0) + x - v;
  __syncthreads();
  return res;
}

// ascending bitonic sort of n (a power of two) keys in shared memory; with
// WITH_IDX the order is the (key, idx) tuple and idx moves with its key
template <bool WITH_IDX>
__device__ void bitonic_sort(unsigned long long* key, uint16_t* idx, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += THREADS) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const bool asc = (lo & k) == 0;
        const unsigned long long kl = key[lo], kh = key[hi];
        bool gt;
        if (WITH_IDX) {
          gt = kl > kh || (kl == kh && idx[lo] > idx[hi]);
        } else {
          gt = kl > kh;
        }
        if (gt == asc) {
          key[lo] = kh;
          key[hi] = kl;
          if (WITH_IDX) {
            const uint16_t il = idx[lo];
            idx[lo] = idx[hi];
            idx[hi] = il;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(THREADS) divide_replicas_kernel(
    const int32_t* __restrict__ strategy, const int32_t* __restrict__ replicas,
    const uint8_t* __restrict__ candidates,
    const int32_t* __restrict__ static_w, const int32_t* __restrict__ avail,
    const int32_t* __restrict__ prev, const uint8_t* __restrict__ fresh,
    int c_n, int n_pow2, int has_aggregated, int32_t* __restrict__ out,
    uint8_t* __restrict__ unsched_out) {
  extern __shared__ unsigned long long keys[];  // [n_pow2], then uint16 idx
  uint16_t* idxs = reinterpret_cast<uint16_t*>(keys + n_pow2);
  __shared__ long long scratch[WARPS + 1];

  const int b = blockIdx.x;
  const size_t row = (size_t)b * c_n;
  const uint8_t* cand_r = candidates + row;
  const int32_t* sw_r = static_w + row;
  const int32_t* av_r = avail + row;
  const int32_t* pv_r = prev + row;
  int32_t* out_r = out + row;

  const int32_t strat = strategy[b];
  const int32_t reps = replicas[b];
  const bool fr = fresh[b] != 0;
  const bool is_dup = strat == DUPLICATED;
  const bool is_static = strat == STATIC_WEIGHT;
  const bool is_dyn = strat == DYNAMIC_WEIGHT || strat == AGGREGATED;
  const bool agg_row = has_aggregated && strat == AGGREGATED;

  // --- 1. row sums, cohort, unschedulable ---------------------------------
  long long s_assigned = 0, s_prev = 0, s_avail = 0, s_fresh = 0, s_sw = 0;
  for (int j = threadIdx.x; j < c_n; j += THREADS) {
    const bool cd = cand_r[j] != 0;
    const int32_t pv = pv_r[j];
    const int32_t pc = cd ? pv : 0;
    const int32_t av = cd ? av_r[j] : 0;
    s_assigned += pc;
    s_prev += pv;
    s_avail += av;
    s_fresh += add32(av, pc);
    s_sw += cd ? sw_r[j] : 0;
  }
  const long long assigned = block_sum(s_assigned, scratch);
  const long long sum_prev = block_sum(s_prev, scratch);
  const long long sum_avail = block_sum(s_avail, scratch);
  const long long sum_fresh = block_sum(s_fresh, scratch);
  const long long sum_sw = block_sum(s_sw, scratch);

  const bool scale_down = is_dyn && !fr && assigned > reps;
  const bool scale_up = is_dyn && !fr && assigned < reps;
  const bool steady = is_dyn && !fr && assigned == reps;
  const bool is_fresh = is_dyn && fr;
  const long long target = scale_up ? (long long)reps - assigned : (long long)reps;
  const long long sum_wdyn =
      is_fresh ? sum_fresh : (scale_down ? sum_prev : sum_avail);
  const bool unsched = is_dyn && !steady && sum_wdyn < target;

  // dynamic weight of column j (divide.py:140-144), and its prefix-order
  // class: 0 for a previously used cluster in scale-up, else 1
  auto dyn_weight = [&](int j, int32_t& pc, int& pk) -> int32_t {
    const bool cd = cand_r[j] != 0;
    const int32_t pv = pv_r[j];
    pc = cd ? pv : 0;
    pk = (pc > 0 && scale_up) ? 0 : 1;
    const int32_t av = cd ? av_r[j] : 0;
    return is_fresh ? add32(av, pc) : (scale_down ? pv : av);
  };

  // --- 2. Aggregated prefix ------------------------------------------------
  // the kept set is every column ordered at or before the cut (thr_p, thr_w,
  // thr_i); only rows whose weights reach the dispense need it
  bool keep_any = false;
  int keep_p = 0, keep_i = 0;
  int32_t keep_w = 0;
  if (agg_row && !steady && !unsched && reps != 0) {
    for (int j = threadIdx.x; j < n_pow2; j += THREADS) {
      unsigned long long k = PAD_KEY;
      if (j < c_n) {
        int32_t pc;
        int pk;
        const int32_t w = dyn_weight(j, pc, pk);
        k = ((unsigned long long)pk << 46) |
            ((unsigned long long)ord32(neg32(w)) << 14) |
            (unsigned long long)j;
      }
      keys[j] = k;
    }
    __syncthreads();
    bitonic_sort<false>(keys, nullptr, n_pow2);
    // cum_before at sorted position k, in JAX's literal form:
    // cumsum(int64(-nw))[k] + nw[k] with nw = -w wrapped (divide.py:98)
    const int per = (n_pow2 + THREADS - 1) / THREADS;
    const int begin = threadIdx.x * per;
    const int end = min(begin + per, c_n);
    long long local = 0;
    for (int k = begin; k < end; ++k)
      local += neg32(unord32((uint32_t)(keys[k] >> 14)));
    long long run = block_exclusive_scan(local, scratch);
    long long cnt = 0;
    for (int k = begin; k < end; ++k) {
      const int32_t nw = unord32((uint32_t)(keys[k] >> 14));
      run += neg32(nw);
      cnt += (run + nw) < target;
    }
    const long long n_keep = block_sum(cnt, scratch);
    keep_any = n_keep > 0;
    long long pos = n_keep - 1;
    pos = pos < 0 ? 0 : (pos > c_n - 1 ? c_n - 1 : pos);
    const unsigned long long kk = keys[pos];
    keep_p = (int)(kk >> 46);
    keep_w = neg32(unord32((uint32_t)(kk >> 14)));
    keep_i = (int)(kk & 0x3fffull);
    __syncthreads();  // keys are reused below
  }

  // --- 3. weights, last, init; floors ----------------------------------------
  auto weight = [&](int j, int32_t& last, int32_t& init, int32_t& pc) -> int32_t {
    int32_t w;
    if (is_static) {
      const bool cd = cand_r[j] != 0;
      const int32_t pv = pv_r[j];
      pc = cd ? pv : 0;
      w = cd ? sw_r[j] : 0;
      if (!(sum_sw > 0)) w = cd ? 1 : 0;  // all-zero static weights
      last = pc;
      init = 0;
    } else {
      int pk;
      w = dyn_weight(j, pc, pk);
      if (agg_row &&
          !(keep_any &&
            (pk < keep_p ||
             (pk == keep_p && (w > keep_w || (w == keep_w && j <= keep_i))))))
        w = 0;
      init = scale_up ? pc : 0;
      last = init;
    }
    if (is_dup || steady || unsched) w = 0;  // no dispense
    return w;
  };

  const int32_t num = wrap32(is_static ? (long long)reps : target);
  long long s_total = 0;
  for (int j = threadIdx.x; j < c_n; j += THREADS) {
    int32_t last, init, pc;
    s_total += weight(j, last, init, pc);
  }
  const long long total = block_sum(s_total, scratch);
  const long long safe_total = total > 1 ? total : 1;
  long long s_floor = 0;
  for (int j = threadIdx.x; j < c_n; j += THREADS) {
    int32_t last, init, pc;
    const int32_t w = weight(j, last, init, pc);
    s_floor += wrap32(floordiv((long long)w * num, safe_total));
  }
  const long long remain = (long long)num - block_sum(s_floor, scratch);

  // --- 4. bonus threshold: the remain-th largest (w, last, -idx) -----------
  const bool need_bonus = remain > 0 && total > 0 && reps != 0;
  int32_t thr_w = 0, thr_l = 0;
  int thr_i = 0;
  if (need_bonus) {
    for (int j = threadIdx.x; j < n_pow2; j += THREADS) {
      unsigned long long k = PAD_KEY;
      uint16_t ix = PAD_IDX;
      if (j < c_n) {
        int32_t last, init, pc;
        const int32_t w = weight(j, last, init, pc);
        k = ((unsigned long long)ord32(neg32(w)) << 32) | ord32(neg32(last));
        ix = (uint16_t)j;
      }
      keys[j] = k;
      idxs[j] = ix;
    }
    __syncthreads();
    bitonic_sort<true>(keys, idxs, n_pow2);
    long long pos = remain - 1;
    pos = pos > c_n - 1 ? c_n - 1 : pos;
    const unsigned long long kk = keys[pos];
    thr_w = neg32(unord32((uint32_t)(kk >> 32)));
    thr_l = neg32(unord32((uint32_t)kk));
    thr_i = idxs[pos];
  }

  // --- 5. dispense and overrides ---------------------------------------------
  for (int j = threadIdx.x; j < c_n; j += THREADS) {
    int32_t last, init, pc;
    const int32_t w = weight(j, last, init, pc);
    const int32_t fl = wrap32(floordiv((long long)w * num, safe_total));
    int32_t bonus = 0;
    if (need_bonus)
      bonus = (w > thr_w) ||
              (w == thr_w && (last > thr_l || (last == thr_l && j <= thr_i)));
    int32_t o = add32(init, total > 0 ? add32(fl, bonus) : 0);
    if (steady) o = pc;
    if (is_dup) o = cand_r[j] != 0 ? reps : 0;
    if (unsched) o = 0;
    if (reps == 0) o = 0;
    out_r[j] = o;
  }
  if (threadIdx.x == 0) unsched_out[b] = unsched ? 1 : 0;
}

}  // namespace

extern "C" int divide_replicas_max_clusters() { return 16384; }

extern "C" int divide_replicas_launch(
    const int32_t* strategy, const int32_t* replicas,
    const uint8_t* candidates, const int32_t* static_w, const int32_t* avail,
    const int32_t* prev, const uint8_t* fresh, int b_n, int c_n,
    int has_aggregated, int32_t* out, uint8_t* unsched, cudaStream_t stream) {
  if (b_n == 0) return 0;
  if (c_n > divide_replicas_max_clusters()) return (int)cudaErrorInvalidValue;
  int n_pow2 = 1;
  while (n_pow2 < c_n) n_pow2 <<= 1;
  const size_t smem =
      (size_t)n_pow2 * (sizeof(unsigned long long) + sizeof(uint16_t));
  cudaError_t err = cudaFuncSetAttribute(
      divide_replicas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  divide_replicas_kernel<<<b_n, THREADS, smem, stream>>>(
      strategy, replicas, candidates, static_w, avail, prev, fresh, c_n,
      n_pow2, has_aggregated, out, unsched);
  return (int)cudaGetLastError();
}
