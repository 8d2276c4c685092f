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
// the ranges the engine feeds it.
//
// What bounds it on an H100: bytes. It must read candidates (1 B), static_w,
// avail and prev (4 B each) for every element, 9 B of row scalars, and write
// the int32 assignment and one flag a row: 17*B*C + 10*B bytes, about 348 MB
// and 104 us at 3.35 TB/s for the north-star chunk (4096 x 5000).
//
// The design, for that bound:
//   - Each input is read once. A thread holds E = 12 elements of the row in
//     registers (three 16-byte vectors a stream, neighbouring lanes on
//     neighbouring vectors), first as raw inputs, then as (weight, last).
//     The block has 32 * ceil(C / 384) threads, at most 1024, so one
//     register tile covers C <= 12288; a wider row loops over tiles and
//     re-reads them from global memory in each pass. Nothing per element
//     lives in shared memory, and no cluster count is refused.
//   - Five passes over the row, each ending in one fused block reduction
//     (one barrier: two buffers in turn; an int64 warp sum is three 32-bit
//     redux sums) or selection:
//     1. the cohort sums (assigned, full prev, candidate avail, fresh
//        weights; or static weights and candidates), from which the cohort,
//        the unschedulable verdict and the dispensed total follow; rows with
//        no dispense (Duplicated, steady, unschedulable, zero replicas) are
//        written here;
//     2. Aggregated rows: the cut of the (prev desc, avail desc, idx asc)
//        prefix (divide.py:95-107) by weighted radix selection, below;
//     3. the floors w*num // total and the selection keys' ranges;
//     4. the bonus threshold: the element of rank remain - 1 in the
//        (w desc, last desc, idx asc) order (dispense.py:81-91), by radix
//        selection, below;
//     5. the dispense and the overrides.
//   - The floor w*num // total (|w*num| <= 2^62, 1 <= total < 2^63) costs a
//     64-bit multiply-high and one fix-up, no division: with
//     m = floor((2^64 - 1) / d) and n <= 2^62, q0 = floor(n*m / 2^64)
//     satisfies n/d - 1/2 < n*m/2^64 <= n/d (since n*(1 + 1/d) / 2^64 <= 1/2),
//     so q0 is floor(n/d) or one less, and r = n - q0*d >= d decides which.
//     A negative numerator takes -(q + (r != 0)). Where 0 <= w*num < 2^31
//     and d < 2^31 (every engine row), the same holds in 32 bits: with
//     m = floor((2^32 - 1) / d), n/d - 1 < n*m/2^32 <= n/d, since
//     n*(1 + 1/d) / 2^32 <= 1, and one fix-up again decides.
//   - The bonus threshold, by exact radix selection instead of a sort: the
//     key is (ord(-w), ord(-last)) with the int32 negations wrapped as JAX
//     wraps them. Digits of 4 bits of the high word relative to its row
//     minimum, then of the low word; each round is one histogram (per-thread
//     packed byte counters, warp sums, 16 shared counters), one barrier, and
//     a scan every warp makes of the counters to find the bucket holding
//     the rank. Once at most GATHER = 64 candidates remain they are gathered
//     into shared memory and each is ranked against all by the full tuple;
//     if more remain after every digit (equal keys), the one of the
//     remaining rank in index order comes from one block-wide count in
//     index order. Ties, zero weights and INT32_MIN order exactly as the
//     sorted tuples do; no index is packed into a key.
//   - The Aggregated cut, by weighted selection: when every dynamic weight
//     of the row is >= 0, the before-sums in (pk asc, w desc, idx asc)
//     order are non-decreasing, so the cut (the last position whose
//     before-sum is below the target) lies in the pk class and then the
//     2-bit digit bucket of w where the running sum crosses the target
//     (counts and int64 weight sums per bucket). Inside the final group of
//     equal w > 0 with before-sum G0 the cut is the
//     min(n, ceil((target - G0) / w))-th element in index order.
//   - A row with a negative dynamic weight (an int32 wrap of avail + prev,
//     or a negative input) has no monotone before-sum, and JAX counts the
//     positions literally (divide.py:98-100). The main kernel hands such a
//     row to a second kernel, which sorts its (pk, -w, idx) keys by a
//     bitonic network in global scratch (allocated by the wrapper, one
//     slice a block) and counts literally. Both launch on every call; the
//     second exits at once when no row was handed over.
//
// divide_replicas_phases_launch runs the same kernels with a barrier and a
// clock64 read at the end of each of the five passes, writing each block's
// cycles per pass (a row handed to the second kernel records the cycles of
// the first kernel only); the engine never calls it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int E = 12;  // elements a thread holds in registers
constexpr int V = E / 4;  // its 4-element vectors
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int N_PHASES = 5;
constexpr int GATHER = 64;  // candidates a selection ranks directly
constexpr int DUPLICATED = 0;
constexpr int STATIC_WEIGHT = 1;
constexpr int DYNAMIC_WEIGHT = 2;
constexpr int AGGREGATED = 3;
constexpr unsigned FULL = 0xffffffffu;

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

// floor(a / d) for d >= 1 and |a| <= 2^62, with m = floor((2^64 - 1) / d)
// (see the note at the top)
__device__ __forceinline__ long long floordiv_r(long long a, unsigned long long d,
                                                unsigned long long m) {
  const bool neg = a < 0;
  const unsigned long long n = neg ? 0ull - (unsigned long long)a : (unsigned long long)a;
  unsigned long long q = __umul64hi(n, m);
  unsigned long long r = n - q * d;
  if (r >= d) {
    ++q;
    r -= d;
  }
  return neg ? -(long long)(q + (r != 0)) : (long long)q;
}

struct Args {
  const int32_t* strategy;
  const int32_t* replicas;
  const uint8_t* cand;
  const int32_t* sw;
  const int32_t* av;
  const int32_t* pv;
  const uint8_t* fresh;
  int c_n;
  int has_agg;
  int vec;  // 16-byte vectors: C % 4 == 0 and aligned pointers
  int32_t* out;
  uint8_t* unsched;
  int* defer;  // [0] rows handed to the literal kernel, then their ids
};

struct Shared {
  // block reductions, up to 8 values a warp; two buffers used in turn, so
  // one barrier a reduction suffices
  long long red[2][MAX_WARPS * 8];
  // radix counters, three buffers used in turn: round k counts into
  // buffer k % 3 and, past its barrier, zeroes buffer (k - 1) % 3, which
  // every warp read before that barrier
  unsigned hist[3][16];
  int wcnt[MAX_WARPS];  // per-warp counts of the index-order selection
  int sel_idx;
  int32_t sel_w, sel_l;
  // the last few candidates of a selection, ranked directly (GATHER at
  // most: a bound of the search, not of the row)
  int gcount;
  int32_t gw[GATHER], gl[GATHER];
  int gi[GATHER], grank[GATHER];  // grank zero between selections
};

// value kinds of block_reduce, two bits each: a sum of int64, the min or
// max of int32 values, a sum below 2^32
constexpr unsigned SUM = 0, MIN32 = 1, MAX32 = 2, SUM32 = 3;

__device__ __forceinline__ long long warp_reduce(long long v, unsigned kind) {
  if (kind == MIN32) return __reduce_min_sync(FULL, (int)v);
  if (kind == MAX32) return __reduce_max_sync(FULL, (int)v);
  if (kind == SUM32) return (long long)__reduce_add_sync(FULL, (unsigned)v);
  // an int64 sum as three 32-bit sums: v = p0 + p1 * 2^21 + p2 * 2^42 with
  // p0, p1 in [0, 2^21) and p2 = v >> 42 in [-2^21, 2^21), so none of the
  // three sums over 32 lanes leaves 32 bits
  const unsigned s0 = __reduce_add_sync(FULL, (unsigned)v & 0x1fffffu);
  const unsigned s1 = __reduce_add_sync(FULL, (unsigned)(v >> 21) & 0x1fffffu);
  const int s2 = (int)__reduce_add_sync(FULL, (unsigned)(int)(v >> 42));
  return (long long)s0 + (long long)s1 * (1ll << 21) + (long long)s2 * (1ll << 42);
}

// block-wide reduction of N values, value i of kind (KINDS >> 2i) & 3; the
// result lands in every thread's v. One barrier: callers alternate the two
// buffers of Shared::red, so a buffer is rewritten only after the next
// reduction's barrier, past every read of it.
template <int N, unsigned KINDS>
__device__ __forceinline__ void block_reduce(long long (&v)[N], long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = warp_reduce(v[i], (KINDS >> (2 * i)) & 3u);
    if (lane == 0) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned kind = (KINDS >> (2 * i)) & 3u;
    const long long id = kind == MIN32 ? INT_MAX : kind == MAX32 ? INT_MIN : 0;
    v[i] = warp_reduce(lane < nw ? red[lane * N + i] : id, kind);
  }
}

// block-wide exclusive prefix sum of one int64 per thread, in thread order
__device__ long long block_exclusive_scan(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  const long long mine = lane < nw ? red[lane] : 0;
  long long s = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += y;
  }
  const long long before = __shfl_sync(FULL, s - mine, warp);
  __syncthreads();
  return before + x - v;
}

// ascending bitonic sort of n (a power of two) keys in global scratch owned
// by this block; __syncthreads makes each stage's writes visible to the next
__device__ void bitonic_sort_global(unsigned long long* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const bool asc = (lo & k) == 0;
        const unsigned long long kl = key[lo], kh = key[hi];
        if ((kl > kh) == asc) {
          key[lo] = kh;
          key[hi] = kl;
        }
      }
      __syncthreads();
    }
  }
}

// One row. LITERAL is the second kernel: it takes the rows the first handed
// over and counts their Aggregated cut literally over sorted keys.
// red_i and hround carry the turns of Shared's buffers from row to row.
template <bool LITERAL, bool PHASES>
__device__ __forceinline__ void divide_row(const Args& a, const int b, Shared& sm,
                                           int& red_i, int& hround,
                                           unsigned long long* keys, const int n_pow2,
                                           long long* cycles) {
  auto red = [&]() {
    red_i ^= 1;
    return sm.red[red_i];
  };
  long long t_prev = clock64();
  auto mark = [&](int p) {
    if (PHASES) {
      __syncthreads();
      const long long t = clock64();
      if (threadIdx.x == 0) cycles[(size_t)b * N_PHASES + p] = t - t_prev;
      t_prev = t;
    }
  };
  const int c_n = a.c_n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = E * blockDim.x;
  const int ntiles = (c_n + tile - 1) / tile;
  const int tbase = warp * (32 * E) + lane * 4;
  const size_t row = (size_t)b * c_n;

  const int32_t strat = a.strategy[b];
  const int32_t reps = a.replicas[b];
  const bool fr = a.fresh[b] != 0;
  const bool is_dup = strat == DUPLICATED;
  const bool is_static = strat == STATIC_WEIGHT;
  const bool is_dyn = strat == DYNAMIC_WEIGHT || strat == AGGREGATED;
  const bool agg_row = a.has_agg && strat == AGGREGATED;

  // this thread's elements: e = 4k + i is column t*tile + tbase + 128k + i
  int32_t ra[E], rb[E];  // raw (static_w or avail, prev), then (w, last)
  uint32_t cm = 0;  // candidate bits
  auto idx_of = [&](int t, int e) { return t * tile + tbase + (e >> 2) * 128 + (e & 3); };

  auto load = [&](int t) {
    cm = 0;
    const int32_t* wsrc = is_static ? a.sw : a.av;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j0 = t * tile + tbase + k * 128;
      if (a.vec) {
        int4 x = make_int4(0, 0, 0, 0), y = make_int4(0, 0, 0, 0);
        uint32_t c4 = 0;
        if (j0 < c_n) {
          c4 = __ldg(reinterpret_cast<const unsigned*>(a.cand + row + j0));
          if (!is_dup) {
            x = __ldg(reinterpret_cast<const int4*>(wsrc + row + j0));
            y = __ldg(reinterpret_cast<const int4*>(a.pv + row + j0));
          }
        }
        ra[4 * k] = x.x;
        ra[4 * k + 1] = x.y;
        ra[4 * k + 2] = x.z;
        ra[4 * k + 3] = x.w;
        rb[4 * k] = y.x;
        rb[4 * k + 1] = y.y;
        rb[4 * k + 2] = y.z;
        rb[4 * k + 3] = y.w;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((c4 >> (8 * i)) & 0xffu) cm |= 1u << (4 * k + i);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + i;
          int32_t x = 0, y = 0;
          if (j < c_n) {
            if (__ldg(a.cand + row + j) != 0) cm |= 1u << (4 * k + i);
            if (!is_dup) {
              x = __ldg(wsrc + row + j);
              y = __ldg(a.pv + row + j);
            }
          }
          ra[4 * k + i] = x;
          rb[4 * k + i] = y;
        }
      }
    }
  };

  // --- 1. cohort sums, cohort, unschedulable -------------------------------
  // static rows: {sum of candidate static weights, candidates}; the others:
  // {assigned, full prev, candidate avail, fresh weights avail + prev}
  long long s[4] = {0, 0, 0, 0};
  for (int t = 0; t < ntiles; ++t) {
    load(t);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool cd = (cm >> e) & 1u;
      if (is_static) {
        s[0] += cd ? ra[e] : 0;
        s[1] += cd ? 1 : 0;
      } else {
        const int32_t pc = cd ? rb[e] : 0;
        const int32_t avm = cd ? ra[e] : 0;
        s[0] += pc;
        s[1] += rb[e];
        s[2] += avm;
        s[3] += add32(avm, pc);
      }
    }
  }
  block_reduce<4, SUM>(s, red());
  const long long assigned = s[0];
  const bool scale_down = is_dyn && !fr && assigned > reps;
  const bool scale_up = is_dyn && !fr && assigned < reps;
  const bool steady = is_dyn && !fr && assigned == reps;
  const bool is_fresh = is_dyn && fr;
  const long long target = scale_up ? (long long)reps - assigned : (long long)reps;
  const long long sum_wdyn = is_fresh ? s[3] : (scale_down ? s[1] : s[2]);
  const bool unsched = is_dyn && !steady && sum_wdyn < target;
  const bool sw_pos = s[0] > 0;  // static rows: not all-zero weights
  if (threadIdx.x == 0) a.unsched[b] = unsched ? 1 : 0;
  mark(0);

  auto store = [&](int t, int k, const int4 o) {
    const int j0 = t * tile + tbase + k * 128;
    if (a.vec) {
      if (j0 < c_n) *reinterpret_cast<int4*>(a.out + row + j0) = o;
    } else {
      if (j0 < c_n) a.out[row + j0] = o.x;
      if (j0 + 1 < c_n) a.out[row + j0 + 1] = o.y;
      if (j0 + 2 < c_n) a.out[row + j0 + 2] = o.z;
      if (j0 + 3 < c_n) a.out[row + j0 + 3] = o.w;
    }
  };

  // rows with no dispense are written from the raw inputs
  if (is_dup || steady || unsched || reps == 0) {
    mark(1);
    mark(2);
    mark(3);
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) load(t);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        int32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * k + i;
          const bool cd = (cm >> e) & 1u;
          o[i] = (reps == 0 || unsched) ? 0 : is_dup ? (cd ? reps : 0) : (cd ? rb[e] : 0);
        }
        store(t, k, make_int4(o[0], o[1], o[2], o[3]));
      }
    }
    mark(4);
    return;
  }

  // (w, last) in place of the raw inputs (divide.py:140-147, :178-180)
  auto to_weights = [&]() {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool cd = (cm >> e) & 1u;
      const int32_t pc = cd ? rb[e] : 0;
      int32_t w, last;
      if (is_static) {
        w = cd ? ra[e] : 0;
        if (!sw_pos) w = cd ? 1 : 0;  // all-zero static weights
        last = pc;
      } else {
        const int32_t avm = cd ? ra[e] : 0;
        w = is_fresh ? add32(avm, pc) : (scale_down ? rb[e] : avm);
        last = scale_up ? pc : 0;
      }
      ra[e] = w;
      rb[e] = last;
    }
  };
  // the Aggregated prefix order's class: 0 for a previously used cluster in
  // scale-up (last = prev there), else 1
  auto pk_of = [&](int e) { return (scale_up && rb[e] > 0) ? 0 : 1; };
  bool keep_any = false;
  int cut_p = 0, cut_i = 0;
  int32_t cut_w = 0;
  auto apply_cut = [&](int t) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = pk_of(e);
      const int32_t w = ra[e];
      const bool keep =
          keep_any &&
          (p < cut_p || (p == cut_p && (w > cut_w || (w == cut_w && idx_of(t, e) <= cut_i))));
      if (!keep) ra[e] = 0;
    }
  };
  // a tile's registers at a stage: 1 weights, 2 weights past the cut (one
  // tile is transformed in place once, below)
  auto prepare = [&](int t, int stage) {
    if (ntiles > 1) {
      load(t);
      to_weights();
      if (stage >= 2 && agg_row) apply_cut(t);
    }
  };
  if (ntiles == 1) to_weights();

  // index-order selection: the element of rank r (0-based) among the
  // columns ``pred`` holds for, into sm.sel_idx / sel_w / sel_l
  auto select_index = [&](long long r, int stage, auto&& pred) {
    for (int t = 0; t < ntiles; ++t) {
      prepare(t, stage);
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (idx_of(t, e) < c_n && pred(t, e)) bits |= 1u << e;
      int ck[V], wk[V], wt = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ck[k] = __popc((bits >> (4 * k)) & 0xfu);
        wk[k] = (int)__reduce_add_sync(FULL, (unsigned)ck[k]);
        wt += wk[k];
      }
      if (lane == 0) sm.wcnt[warp] = wt;
      __syncthreads();
      const int x = lane < nwarps ? sm.wcnt[lane] : 0;
      int incl = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int tile_total = __shfl_sync(FULL, incl, 31);
      const bool here = r < tile_total;
      if (here) {
        const int w_sel = __ffs(__ballot_sync(FULL, incl > r)) - 1;
        const int before = __shfl_sync(FULL, incl - x, w_sel);
        if (warp == w_sel) {
          // the vector of this warp holding the rank, without a dynamic
          // index into the register arrays
          int rr = (int)(r - before), ksel = -1, csel = 0;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (ksel < 0) {
              if (rr < wk[k]) {
                ksel = k;
                csel = ck[k];
              } else {
                rr -= wk[k];
              }
            }
          }
          int inc2 = csel;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, inc2, o);
            if (lane >= o) inc2 += y;
          }
          const int l_sel = __ffs(__ballot_sync(FULL, inc2 > rr)) - 1;
          if (lane == l_sel) {
            int left = rr - (inc2 - csel);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              if ((e >> 2) == ksel && ((bits >> e) & 1u)) {
                if (left == 0) {
                  sm.sel_idx = idx_of(t, e);
                  sm.sel_w = ra[e];
                  sm.sel_l = rb[e];
                }
                --left;
              }
            }
          }
        }
      } else {
        r -= tile_total;
      }
      __syncthreads();
      if (here) break;
    }
  };

  // the bonus threshold among at most GATHER candidates: gathered into
  // shared memory and ranked pairwise by the full (ord(-w), ord(-last), idx)
  // order, the comparisons spread over the block; the one of rank r lands
  // in sm.sel_*
  auto gather_rank = [&](long long r, auto&& pred) {
    for (int t = 0; t < ntiles; ++t) {
      prepare(t, 2);
      uint32_t bits = 0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (idx_of(t, e) < c_n && pred(t, e)) bits |= 1u << e;
      const int cnt = __popc(bits);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int base = 0;
      if (lane == 31 && incl > 0) base = atomicAdd(&sm.gcount, incl);
      int slot = __shfl_sync(FULL, base, 31) + incl - cnt;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((bits >> e) & 1u) {
          sm.gw[slot] = ra[e];
          sm.gl[slot] = rb[e];
          sm.gi[slot] = idx_of(t, e);
          ++slot;
        }
      }
    }
    __syncthreads();
    // every thread compares one candidate j with a slice of the others and
    // adds what it counted below j to j's rank
    const int m = sm.gcount;
    const int slices = m > 0 && (int)blockDim.x >= 2 * m ? (int)blockDim.x / m : 1;
    for (int t = threadIdx.x; t < m * slices; t += blockDim.x) {
      const int j = t % m, sl = t / m;
      const uint32_t hj = ord32(neg32(sm.gw[j])), lj = ord32(neg32(sm.gl[j]));
      const int ij = sm.gi[j];
      int below = 0;
      for (int i = sl * m / slices; i < (sl + 1) * m / slices; ++i) {
        const uint32_t hi = ord32(neg32(sm.gw[i])), li = ord32(neg32(sm.gl[i]));
        below += hi < hj || (hi == hj && (li < lj || (li == lj && sm.gi[i] < ij)));
      }
      if (below) atomicAdd(&sm.grank[j], below);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      if (sm.grank[j] == r) {
        sm.sel_idx = sm.gi[j];
        sm.sel_w = sm.gw[j];
        sm.sel_l = sm.gl[j];
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) sm.grank[j] = 0;
    if (threadIdx.x == 0) sm.gcount = 0;  // read again only past later barriers
  };

  // --- 2. Aggregated cut ---------------------------------------------------
  bool total_known = true;
  long long total = is_static ? (sw_pos ? s[0] : s[1]) : sum_wdyn;
  if (agg_row) {
    // {weight of class 0, size of class 0, min weight, max weight}
    long long r4[4] = {0, 0, INT_MAX, INT_MIN};
    for (int t = 0; t < ntiles; ++t) {
      prepare(t, 1);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (idx_of(t, e) >= c_n) continue;
        if (pk_of(e) == 0) {
          r4[0] += ra[e];
          r4[1] += 1;
        }
        r4[2] = r4[2] < ra[e] ? r4[2] : ra[e];
        r4[3] = r4[3] > ra[e] ? r4[3] : ra[e];
      }
    }
    block_reduce<4, (SUM32 << 2) | (MIN32 << 4) | (MAX32 << 6)>(r4, red());
    const long long tgt = target;
    if (c_n > 0 && r4[2] < 0) {
      if constexpr (!LITERAL) {  // hand the row to the literal kernel
        if (threadIdx.x == 0) a.defer[1 + atomicAdd(a.defer, 1)] = b;
        mark(1);
        mark(2);
        mark(3);
        mark(4);
        return;
      } else {
        // JAX's literal count over the sorted (pk, -w, idx) keys
        for (int t = 0; t < ntiles; ++t) {
          prepare(t, 1);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int j = idx_of(t, e);
            if (j < c_n)
              keys[j] = ((unsigned long long)pk_of(e) << 63) |
                        ((unsigned long long)ord32(neg32(ra[e])) << 31) | (unsigned long long)j;
          }
        }
        for (int j = c_n + threadIdx.x; j < n_pow2; j += blockDim.x) keys[j] = ~0ull;
        __syncthreads();
        bitonic_sort_global(keys, n_pow2);
        auto w_at = [&](int p) { return neg32(unord32((uint32_t)(keys[p] >> 31))); };
        const int per = (c_n + blockDim.x - 1) / blockDim.x;
        const int begin = threadIdx.x * per;
        const int end = begin + per < c_n ? begin + per : c_n;
        long long local = 0;
        for (int p = begin; p < end; ++p) local += w_at(p);
        long long run = block_exclusive_scan(local, red());
        long long cnt[1] = {0};
        for (int p = begin; p < end; ++p) {
          const int32_t w = w_at(p);
          run += w;  // cumsum of -(-w), then + (-w): divide.py:98
          cnt[0] += (run + (long long)neg32(w)) < tgt ? 1 : 0;
        }
        block_reduce<1, SUM>(cnt, red());
        keep_any = cnt[0] > 0;
        long long pos = cnt[0] - 1;
        pos = pos < 0 ? 0 : (pos > c_n - 1 ? c_n - 1 : pos);
        const unsigned long long kk = keys[pos];
        cut_p = (int)(kk >> 63);
        cut_w = neg32(unord32((uint32_t)(kk >> 31)));
        cut_i = (int)(kk & 0x7fffffffull);
        total_known = false;
        __syncthreads();  // this block's next row rewrites keys
      }
    } else if (tgt <= 0 || c_n == 0) {
      keep_any = false;
      total = 0;
    } else {
      // weighted selection: the pk class, then 2-bit digits of wmax - w
      const long long n0 = r4[1], n1 = c_n - n0;
      const int g = (r4[0] < tgt && n1 > 0) ? 1 : 0;
      long long gsum = g ? r4[0] : 0;  // weight ordered before the group
      long long n = g ? n1 : n0;
      const int32_t wmax = (int32_t)r4[3];
      const uint32_t span = (uint32_t)(wmax - (int32_t)r4[2]);
      uint32_t val = 0, msk = 0;
      auto in_group = [&](int t, int e) {
        return pk_of(e) == g && ((((uint32_t)(wmax - ra[e])) ^ val) & msk) == 0;
      };
      const int top = span ? 32 - __clz(span) : 0;
      for (int sh = ((top + 1) / 2) * 2 - 2; sh >= 0 && n > 1; sh -= 2) {
        long long h[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // counts, then weights
        for (int t = 0; t < ntiles; ++t) {
          prepare(t, 1);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (idx_of(t, e) >= c_n || !in_group(t, e)) continue;
            const int d = (int)(((uint32_t)(wmax - ra[e]) >> sh) & 3u);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (d == q) {
                h[q] += 1;
                h[4 + q] += ra[e];
              }
            }
          }
        }
        block_reduce<8, SUM32 | (SUM32 << 2) | (SUM32 << 4) | (SUM32 << 6)>(h, red());
        long long before = gsum, chosen_before = gsum, nq = 0;
        int dsel = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (h[q] > 0 && before < tgt) {
            dsel = q;
            chosen_before = before;
            nq = h[q];
          }
          before += h[4 + q];
        }
        gsum = chosen_before;
        n = nq;
        val |= (uint32_t)dsel << sh;
        msk |= 3u << sh;
      }
      // the k-th of the group in index order; a group of more than one
      // element has every digit fixed, so weight wmax - val
      long long k = 1;
      if (n > 1) {
        const long long wg = (long long)(int32_t)(wmax - (int32_t)val);
        k = n;
        if (wg > 0) {
          const long long need = (tgt - gsum + wg - 1) / wg;
          k = need < n ? need : n;
        }
      }
      select_index(k - 1, 1, in_group);
      keep_any = true;
      cut_p = g;
      cut_i = sm.sel_idx;
      cut_w = sm.sel_w;
      total = gsum + k * (long long)cut_w;
    }
    if (ntiles == 1) apply_cut(0);
  }
  mark(1);

  // --- 3. floors and the selection keys' ranges ----------------------------
  if (!total_known) {
    long long tt[1] = {0};
    for (int t = 0; t < ntiles; ++t) {
      prepare(t, 2);
#pragma unroll
      for (int e = 0; e < E; ++e) tt[0] += ra[e];  // zero past the row
    }
    block_reduce<1, SUM>(tt, red());
    total = tt[0];
  }
  const int32_t num = wrap32(is_static ? (long long)reps : target);
  const unsigned long long safe = total > 1 ? (unsigned long long)total : 1ull;
  const unsigned long long recip = ~0ull / safe;
  // w*num // total in 32 bits where 0 <= w*num < 2^31 and total < 2^31
  // (w <= wlim), in 64 bits elsewhere (see the note at the top)
  const bool small = num >= 0 && safe < (1ull << 31);
  const int32_t wlim = !small ? -1 : (num == 0 ? INT_MAX : (int32_t)(0x7fffffff / num));
  const uint32_t recip32 = small ? 0xffffffffu / (uint32_t)safe : 0u;
  auto floor_of = [&](int32_t w) -> int32_t {
    if (w >= 0 && w <= wlim) {
      const uint32_t p = (uint32_t)w * (uint32_t)num;
      uint32_t q = __umulhi(p, recip32);
      if (p - q * (uint32_t)safe >= (uint32_t)safe) ++q;
      return (int32_t)q;
    }
    return wrap32(floordiv_r((long long)w * num, safe, recip));
  };
  // one histogram round of the bonus selection: per-thread byte counters
  // of the 16 buckets of a digit, warp sums in 16-bit fields, the block's
  // counters in sm.hist[hround]
  auto count_digits = [&](unsigned long long c0, unsigned long long c1) {
    const unsigned long long M = 0x00ff00ff00ff00ffull;
    const unsigned long long e0 = c0 & M, o0 = (c0 >> 8) & M;
    const unsigned long long e1 = c1 & M, o1 = (c1 >> 8) & M;
    unsigned wd[8] = {(unsigned)e0, (unsigned)(e0 >> 32), (unsigned)o0, (unsigned)(o0 >> 32),
                      (unsigned)e1, (unsigned)(e1 >> 32), (unsigned)o1, (unsigned)(o1 >> 32)};
#pragma unroll
    for (int q = 0; q < 8; ++q) wd[q] = __reduce_add_sync(FULL, wd[q]);
    if (lane < 16) {
      // bucket lane: byte (lane & 7) of c(lane >> 3), split even/odd
      const int tt = lane & 7, p = tt >> 1;
      const int word = (lane >> 3) * 4 + (tt & 1) * 2 + (p >> 1);
      unsigned x = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q == word) x = wd[q];
      const unsigned cnt = (x >> (16 * (p & 1))) & 0xffffu;
      if (cnt) atomicAdd(&sm.hist[hround][lane], cnt);
    }
  };
  auto add_digit = [](unsigned d, unsigned long long& c0, unsigned long long& c1) {
    const unsigned long long inc = 1ull << ((d & 7u) << 3);
    if (d & 8u) {
      c1 += inc;
    } else {
      c0 += inc;
    }
  };
  // {sum of floors, min/max of -w, min/max of -last}: the selection keys'
  // ranges, since ord() is monotone
  long long f5[5] = {0, INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  if (total > 0) {
    for (int t = 0; t < ntiles; ++t) {
      prepare(t, 2);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (idx_of(t, e) >= c_n) continue;
        f5[0] += floor_of(ra[e]);
        const long long hi = neg32(ra[e]), lo = neg32(rb[e]);
        f5[1] = f5[1] < hi ? f5[1] : hi;
        f5[2] = f5[2] > hi ? f5[2] : hi;
        f5[3] = f5[3] < lo ? f5[3] : lo;
        f5[4] = f5[4] > lo ? f5[4] : lo;
      }
    }
    block_reduce<5, (MIN32 << 2) | (MAX32 << 4) | (MIN32 << 6) | (MAX32 << 8)>(f5, red());
  }
  const long long remain = (long long)num - f5[0];
  const bool need_bonus = remain > 0 && total > 0;
  mark(2);

  // --- 4. bonus threshold: rank remain - 1 of (w desc, last desc, idx asc) -
  long long r = remain - 1;
  r = r > c_n - 1 ? c_n - 1 : r;
  unsigned n = (unsigned)c_n;  // candidates left
  // the keys relative to their row minimum, and the candidates' fixed digits
  const uint32_t hmin = ord32((int32_t)f5[1]), lmin = ord32((int32_t)f5[3]);
  uint32_t hval = 0, hmsk = 0, lval = 0, lmsk = 0;
  // past a round's barrier: zero the counters of the round before (every
  // warp read them before this barrier), and let every warp find the
  // bucket holding the rank
  auto pick = [&](int level, int sh) {
    const unsigned* hist = sm.hist[hround];
    if (threadIdx.x < 16) sm.hist[(hround + 2) % 3][threadIdx.x] = 0;
    hround = (hround + 1) % 3;
    const unsigned h = lane < 16 ? hist[lane] : 0u;
    unsigned incl = h;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    const uint32_t d = __ffs(__ballot_sync(FULL, lane < 16 && (long long)incl > r)) - 1;
    r -= __shfl_sync(FULL, incl - h, d);
    n = __shfl_sync(FULL, h, d);
    if (level == 0) {
      hval |= d << sh;
      hmsk |= 15u << sh;
    } else {
      lval |= d << sh;
      lmsk |= 15u << sh;
    }
  };

  int32_t thr_w = 0, thr_l = 0;
  int thr_i = 0;
  if (need_bonus) {
    auto is_cand = [&](int t, int e) {
      const uint32_t dh = ord32(neg32(ra[e])) - hmin, dl = ord32(neg32(rb[e])) - lmin;
      return ((dh ^ hval) & hmsk) == 0 && ((dl ^ lval) & lmsk) == 0;
    };
    for (int level = 0; level < 2 && n > GATHER; ++level) {
      const uint32_t kmin = level == 0 ? hmin : lmin;
      const uint32_t span = ord32((int32_t)(level == 0 ? f5[2] : f5[4])) - kmin;
      const int top = span ? 32 - __clz(span) : 0;
      for (int sh = ((top + 3) / 4) * 4 - 4; sh >= 0 && n > GATHER; sh -= 4) {
        for (int t = 0; t < ntiles; ++t) {
          prepare(t, 2);
          unsigned long long c0 = 0, c1 = 0;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            if (idx_of(t, e) >= c_n || !is_cand(t, e)) continue;
            add_digit(((ord32(neg32(level == 0 ? ra[e] : rb[e])) - kmin) >> sh) & 15u, c0, c1);
          }
          count_digits(c0, c1);
        }
        __syncthreads();
        pick(level, sh);
      }
    }
    if (n <= GATHER) {
      gather_rank(r, is_cand);
    } else {
      select_index(r, 2, is_cand);
    }
    thr_i = sm.sel_idx;
    thr_w = sm.sel_w;
    thr_l = sm.sel_l;
  }
  mark(3);

  // --- 5. dispense ---------------------------------------------------------
  for (int t = 0; t < ntiles; ++t) {
    prepare(t, 2);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      int32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * k + i;
        const int32_t w = ra[e], last = rb[e];
        const int32_t init = is_static ? 0 : last;
        int32_t add = 0;
        if (total > 0) {
          const int32_t fl = floor_of(w);
          const bool bonus =
              need_bonus &&
              (w > thr_w ||
               (w == thr_w && (last > thr_l || (last == thr_l && idx_of(t, e) <= thr_i))));
          add = add32(fl, bonus ? 1 : 0);
        }
        o[i] = add32(init, add);
      }
      store(t, k, make_int4(o[0], o[1], o[2], o[3]));
    }
  }
  mark(4);
}

template <bool PHASES>
__global__ void __launch_bounds__(MAX_THREADS)
    divide_replicas_kernel(const Args a, long long* __restrict__ cycles) {
  __shared__ Shared sm;
  for (int i = threadIdx.x; i < 3 * 16; i += blockDim.x) sm.hist[i / 16][i % 16] = 0;
  for (int i = threadIdx.x; i < GATHER; i += blockDim.x) sm.grank[i] = 0;
  if (threadIdx.x == 0) sm.gcount = 0;
  __syncthreads();
  int red_i = 0, hround = 0;
  divide_row<false, PHASES>(a, blockIdx.x, sm, red_i, hround, nullptr, 0, cycles);
}

// the rows the main kernel handed over, each block with its own scratch
__global__ void __launch_bounds__(MAX_THREADS)
    divide_literal_kernel(const Args a, unsigned long long* __restrict__ scratch, int n_pow2) {
  __shared__ Shared sm;
  for (int i = threadIdx.x; i < 3 * 16; i += blockDim.x) sm.hist[i / 16][i % 16] = 0;
  for (int i = threadIdx.x; i < GATHER; i += blockDim.x) sm.grank[i] = 0;
  if (threadIdx.x == 0) sm.gcount = 0;
  __syncthreads();
  int red_i = 0, hround = 0;
  const int n = *reinterpret_cast<volatile int*>(a.defer);
  for (int i = blockIdx.x; i < n; i += gridDim.x)
    divide_row<true, false>(a, a.defer[1 + i], sm, red_i, hround,
                            scratch + (size_t)blockIdx.x * n_pow2, n_pow2, nullptr);
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p & (n - 1)) == 0; }

template <bool PHASES>
int launch(const int32_t* strategy, const int32_t* replicas, const uint8_t* candidates,
           const int32_t* static_w, const int32_t* avail, const int32_t* prev,
           const uint8_t* fresh, int b_n, int c_n, int has_aggregated, int32_t* out,
           uint8_t* unsched, int* defer, unsigned long long* scratch, int lit_blocks,
           long long* cycles, cudaStream_t stream) {
  if (b_n == 0) return 0;
  if (c_n < 0 || lit_blocks < 1) return (int)cudaErrorInvalidValue;
  const int vec = c_n % 4 == 0 && aligned(candidates, 4) && aligned(static_w, 16) &&
                  aligned(avail, 16) && aligned(prev, 16) && aligned(out, 16);
  const Args a{strategy, replicas, candidates, static_w, avail, prev, fresh,
               c_n, has_aggregated, vec, out, unsched, defer};
  long long warps = ((long long)c_n + 32 * E - 1) / (32 * E);
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  int n_pow2 = 1;
  while (n_pow2 < c_n) n_pow2 <<= 1;
  cudaError_t err = cudaMemsetAsync(defer, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  divide_replicas_kernel<PHASES><<<b_n, (int)warps * 32, 0, stream>>>(a, cycles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  divide_literal_kernel<<<lit_blocks, MAX_THREADS, 0, stream>>>(a, scratch, n_pow2);
  return (int)cudaGetLastError();
}

}  // namespace

// out int32[B, C] and unsched uint8[B] = divide_replicas(...); defer
// int32[B + 1] and scratch uint64[lit_blocks * next_pow2(C)] are the
// wrapper's scratch, lit_blocks the second kernel's blocks
extern "C" int divide_replicas_launch(
    const int32_t* strategy, const int32_t* replicas, const uint8_t* candidates,
    const int32_t* static_w, const int32_t* avail, const int32_t* prev, const uint8_t* fresh,
    int b_n, int c_n, int has_aggregated, int32_t* out, uint8_t* unsched, int* defer,
    unsigned long long* scratch, int lit_blocks, cudaStream_t stream) {
  return launch<false>(strategy, replicas, candidates, static_w, avail, prev, fresh, b_n, c_n,
                       has_aggregated, out, unsched, defer, scratch, lit_blocks, nullptr,
                       stream);
}

// the same, also writing each row's block cycles per pass to cycles
// int64[B, 5]
extern "C" int divide_replicas_phases_launch(
    const int32_t* strategy, const int32_t* replicas, const uint8_t* candidates,
    const int32_t* static_w, const int32_t* avail, const int32_t* prev, const uint8_t* fresh,
    int b_n, int c_n, int has_aggregated, int32_t* out, uint8_t* unsched, int* defer,
    unsigned long long* scratch, int lit_blocks, long long* cycles, cudaStream_t stream) {
  return launch<true>(strategy, replicas, candidates, static_w, avail, prev, fresh, b_n, c_n,
                      has_aggregated, out, unsched, defer, scratch, lit_blocks, cycles, stream);
}
