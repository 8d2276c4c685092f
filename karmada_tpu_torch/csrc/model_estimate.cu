// K7 model_overlay: the resource-model grade estimate per (profile, cluster),
// written over the engine's profile table.
//
// Replaces karmada_tpu/models/modeling.py:72 estimate_by_models as the model
// branch of karmada_tpu/scheduler/core.py:2256 _profile_table (:2263-2293)
// runs it.
//
// For one request row q and one cluster c with G grades of R min bounds:
//   first[r]  = the first grade g with mb[c,g,r] >= q[r] and mb[c,g,r] >= 0,
//               G if none (jnp.argmax of a bool: the first true; grades
//               are walked in order, never assumed sorted by bound)
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
// wrapped negative. Division: the dividend is clamped non-negative first
// (max(mb, 0)) and a request is > 0, so floor and truncation agree; it is
// divmagic.cuh's exact multiplier-and-shift product (floor_doubled).
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
// What bounds it on an H100: at the engine's 8 profiles x 5000 clusters x
// 9 grades, the launch: its bytes (1.6 MB) take 0.0006 ms, its launch floor
// 0.0022 ms, and it measures 0.0073 (the first-slice form 0.0119): the
// prologue (the tile's stage and the multipliers' 128/64-bit divisions)
// 0.0040 of it, the grade sums 0.0023. At 1024 profiles its operations
// bound it (0.0069 ms; the table is written, never read) and it measures
// 0.2146 (0.2961): 84% the grade sums, the 64-bit high product of every
// requested (grade, dim) of a cell, over the grades from the least first
// grade among a warp's 32 clusters (PERF.md §6 row 23o, k6_k7_variants.py).
// Spreading a warp's grade terms evenly over its lanes (an item stream with
// shuffles), a per-lane stream of cells after a separate walk, and four
// lanes a cell each ran slower at one of the two shapes.
//
// The design: a block is a tile of clusters (a thread each) times a few
// profile lanes, over a slice of the profile rows; the grid is one wave of
// resident blocks (row_tiles.cuh), the slices as many as that wave leaves
// room for. The block copies its tile's [G][R] bounds and counts into
// shared memory once, coalesced (the [C][G][R] layout makes a tile one
// contiguous span; cp.async, in flight while the first multipliers are
// built), with a cluster's words an odd count apart so that a warp's reads
// meet no bank twice; each thread then rewrites the words it copied as
// 2 max(mb, 0), the doubled dividend floor_doubled takes (for q > 0, mb >=
// q and mb >= 0 reads as 2 max(mb, 0) >= 2q). Per chunk of profile rows it
// builds each requested dim's multiplier and shift once (divmagic.cuh: the
// block's threads share the 128/64-bit divisions), so a cell's divisions
// are high products. A cell walks the grades once in order until every
// requested dim has a compliant grade, then sums the grades from there.
// Up to 4 dims a profile's multipliers, shifts and requests sit in
// registers (RT = 4); the general body (any R) reads them from shared
// memory and walks each dim's grades apart, and at R = 4 it is 22% slower
// on the engine's table (0.0089 ms), 8% at 1024 profiles.
//
// The tile is sized from G x R at launch: 256 / lanes clusters (lanes = the
// profile lanes, up to 8, at most the profile count), halved down to 32
// while the stage exceeds 64 KB. A stage over 100 KB at 32 clusters (G x R
// past ~380) reads the bounds from global memory instead, through the
// general body: 0.0932 ms at 64 x 5000 x 16 grades x 41 dims (the bound
// 0.0089, the first-slice form 0.4771); the same tile staged in a 175 KB
// stage, one block an SM, took 0.2211. R up to 10,000.

#include <cstdint>
#include <cuda_runtime.h>

#include "divmagic.cuh"
#include "row_tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_I32 = 2147483647LL;
constexpr unsigned long long SENTINEL = 1ULL << 62;
constexpr int MAGIC_PAIRS = 256;  // (profile, dim) multipliers a chunk, about
constexpr size_t TILE_BYTES = 64 * 1024;    // a tile's stage, halving above it
constexpr size_t STAGE_MOST = 100 * 1024;   // the largest stage, at 32 clusters
constexpr size_t SMEM_MOST = 220 * 1024;

struct Args {
  const int64_t* mb;
  const int32_t* counts;
  const uint8_t* covered;
  const int64_t* req;
  const uint8_t* has_models;
  const uint8_t* has_summary;
  const int64_t* cap;
  int32_t* table;
  int c_n, g_n, r_dims, u_n, pods_dim;
  int tc_log2;    // clusters a block: 1 << tc_log2; THREADS >> tc_log2 profile lanes
  int stride;     // staged bound words a cluster: G x R, odd
  int gstride;    // staged counts a cluster: G, odd
  int pc;         // profiles a chunk of multipliers (a multiple of the lanes)
  int per_block;  // profile rows a block
};

__device__ __forceinline__ unsigned long long doubled(long long m) {
  return m > 0 ? (unsigned long long)m << 1 : 0ULL;
}

// RT: 4 for R <= 4 (a profile's multipliers in registers), 0 for any R.
// STAGED: the tile's bounds and counts in shared memory, else read from
// global memory (the general body only).
template <int RT, bool STAGED>
__global__ void __launch_bounds__(THREADS) model_overlay_kernel(Args a) {
  static_assert(RT == 0 || STAGED, "the register body reads a staged tile");
  extern __shared__ unsigned long long smem[];
  const int R = a.r_dims, G = a.g_n, GR = G * R;
  const int tc = 1 << a.tc_log2, lanes = THREADS >> a.tc_log2;
  const int ci = threadIdx.x & (tc - 1), lane_p = threadIdx.x >> a.tc_log2;
  const int c0 = blockIdx.x * tc;
  const int nc = min(tc, a.c_n - c0);
  const int c = c0 + ci;
  const bool live = ci < nc;
  const int u0 = blockIdx.y * a.per_block;
  const int u1 = min(u0 + a.per_block, a.u_n);
  unsigned long long* xs = smem;                                        // [tc][stride]
  unsigned long long* ms = xs + (STAGED ? (size_t)tc * a.stride : 0);   // [pc][R]
  unsigned long long* qs = ms + (size_t)a.pc * R;  // [pc][R]: 2q, 0 where not requested
  int32_t* cs = reinterpret_cast<int32_t*>(qs + (size_t)a.pc * R);  // [tc][gstride]
  int* ls = cs + (STAGED ? (size_t)tc * a.gstride : 0);              // [pc][R]

  // the tile's nc x G x R bound words (one contiguous span) and nc x G
  // counts, coalesced; word w is word k of cluster cl, advanced by steps
  // of THREADS without a division. fn(smem word, global word) for each of
  // this thread's words.
  const auto each_word = [&](auto fn, int n, int width, int stride) {
    if (width <= 0) return;
    int cl = threadIdx.x / width, k = threadIdx.x - cl * width;
    const int dq = THREADS / width, dr = THREADS - dq * width;
    for (int w = threadIdx.x; w < n; w += THREADS) {
      fn(cl * stride + k, w);
      cl += dq, k += dr;
      if (k >= width) k -= width, ++cl;
    }
  };
  if (STAGED) {  // copies in flight (cp.async) while the first multipliers are built
    const int64_t* mb_t = a.mb + (size_t)c0 * GR;
    const int32_t* counts_t = a.counts + (size_t)c0 * G;
    each_word([&](int s, int w) { __pipeline_memcpy_async(xs + s, mb_t + w, 8); },
              nc * GR, GR, a.stride);
    each_word([&](int s, int w) { __pipeline_memcpy_async(cs + s, counts_t + w, 4); },
              nc * G, G, a.gstride);
    __pipeline_commit();
  }
  // the multipliers, shifts and doubled requests of profiles [ub, ub + np)
  const auto multipliers = [&](int ub, int np) {
    for (int w = threadIdx.x; w < np * R; w += THREADS) {
      const int p = w / R, r = w - p * R;
      const long long q = r == a.pods_dim ? 0 : __ldg(a.req + (size_t)(ub + p) * R + r);
      unsigned long long m = 0;
      int l = 0;
      if (q > 0) magic((unsigned long long)q, m, l);
      ms[w] = m;
      qs[w] = q > 0 ? (unsigned long long)q << 1 : 0ULL;
      ls[w] = l;
    }
  };
  if (u0 < u1) multipliers(u0, min(a.pc, u1 - u0));
  if (STAGED) {
    // this thread's own copies landed: each bound as 2 max(mb, 0), the
    // doubled dividend floor_doubled takes (for q > 0, mb >= q and mb >= 0
    // reads as 2 max(mb, 0) >= 2q)
    __pipeline_wait_prior(0);
    each_word([&](int s, int) { xs[s] = doubled((long long)xs[s]); }, nc * GR, GR, a.stride);
  }
  __syncthreads();
  // the cluster's constants
  bool summary = false, models = false;
  int32_t pods_cap = (int32_t)MAX_I32;
  unsigned long long covm = 0;  // covered dims below 64
  if (live) {
    summary = a.has_summary[c] != 0;
    models = a.has_models[c] != 0;
    if (a.pods_dim >= 0) {
      long long p = a.cap[(size_t)c * R + a.pods_dim];
      p = p > 0 ? p : 0;
      pods_cap = (int32_t)(p < MAX_I32 ? p : MAX_I32);
    }
    for (int r = 0; r < R && r < 64; ++r)
      if (a.covered[(size_t)c * R + r]) covm |= 1ULL << r;
  }
  const unsigned long long* xc = xs + (size_t)ci * a.stride;
  const int32_t* cc = cs + (size_t)ci * a.gstride;
  const int64_t* mb_c = a.mb + (size_t)(live ? c : c0) * GR;
  const int32_t* counts_c = a.counts + (size_t)(live ? c : c0) * G;
  const auto X = [&](int g, int r) -> unsigned long long {
    if (STAGED) return xc[g * R + r];
    return doubled(__ldg(mb_c + g * R + r));
  };
  const auto CNT = [&](int g) -> int32_t {
    if (STAGED) return cc[g];
    return __ldg(counts_c + g);
  };
  const auto covers = [&](int r) -> bool {
    return r < 64 ? ((covm >> r) & 1) != 0 : a.covered[(size_t)c * R + r] != 0;
  };

  for (int ub = u0; ub < u1; ub += a.pc) {
    const int np = min(a.pc, u1 - ub);
    if (ub != u0) {
      __syncthreads();  // the previous chunk's multipliers read
      multipliers(ub, np);
      __syncthreads();
    }
    if (!live || (summary && !models)) continue;  // the general answer stands
    for (int p = lane_p; p < np; p += lanes) {
      int32_t* out = a.table + (size_t)(ub + p) * a.c_n + c;
      if (!summary) {
        *out = -1;
        continue;
      }
      const unsigned long long* q2 = qs + (size_t)p * R;
      const unsigned long long* mm = ms + (size_t)p * R;
      const int* ll = ls + (size_t)p * R;
      int idx = G;
      unsigned long long total = 0;
      if constexpr (RT == 4) {
        unsigned long long qr[4], mr[4];
        int lr[4];
        bool app = true, found[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qr[r] = r < R ? q2[r] : 0ULL;
          mr[r] = r < R ? mm[r] : 0ULL;
          lr[r] = r < R ? ll[r] : 0;
          found[r] = qr[r] == 0;
          if (!found[r] && !((covm >> r) & 1)) app = false;
        }
        if (!app) continue;
        // the first grade by which every requested dim has a compliant one
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (!found[r]) found[r] = X(g, r) >= qr[r];
          if (found[0] && found[1] && found[2] && found[3]) {
            idx = g;
            break;
          }
        }
        for (int g = idx; g < G; ++g) {
          unsigned long long per = SENTINEL;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (qr[r]) {
              const unsigned long long d = floor_doubled(mr[r], lr[r], X(g, r));
              per = d < per ? d : per;
            }
          if (per >= SENTINEL) per = 0;
          if (per < 1) per = 1;
          total += (unsigned long long)(long long)CNT(g) * per;
        }
      } else {
        bool app = true;
        for (int r = 0; r < R; ++r)
          if (q2[r] && !covers(r)) app = false;
        if (!app) continue;
        idx = 0;
        for (int r = 0; r < R && idx < G; ++r) {
          if (!q2[r]) continue;
          int first = G;
          for (int g = 0; g < G; ++g)
            if (X(g, r) >= q2[r]) {
              first = g;
              break;
            }
          idx = first > idx ? first : idx;
        }
        for (int g = idx; g < G; ++g) {
          unsigned long long per = SENTINEL;
          for (int r = 0; r < R; ++r)
            if (q2[r]) {
              const unsigned long long d = floor_doubled(mm[r], ll[r], X(g, r));
              per = d < per ? d : per;
            }
          if (per >= SENTINEL) per = 0;
          if (per < 1) per = 1;
          total += (unsigned long long)(long long)CNT(g) * per;
        }
      }
      long long s = (long long)total;  // the wrapped int64 sum
      s = s < MAX_I32 ? s : MAX_I32;
      int32_t t = (int32_t)(uint32_t)(unsigned long long)s;
      if (a.pods_dim >= 0) t = t < pods_cap ? t : pods_cap;
      *out = t;
    }
  }
}

struct Shape {
  int tc_log2, stride, gstride, pc;
  bool staged;
  size_t smem;
};

// the block's tile and stage for G grades x R dims at U profiles: profile
// lanes up to 8 (at most U), clusters the rest of the block's threads,
// halved (down to a warp) while the stage exceeds TILE_BYTES
Shape shape_of(int g_n, int r_dims, int u_n) {
  Shape s;
  s.stride = (g_n * r_dims) | 1;
  s.gstride = g_n | 1;
  int lanes = 1;
  while (lanes < 8 && lanes * 2 <= u_n) lanes *= 2;
  const auto stage = [&](int tc) {
    return (size_t)tc * s.stride * 8 + (size_t)tc * s.gstride * 4;
  };
  int tc = THREADS / lanes;
  while (tc > 32 && stage(tc) > TILE_BYTES) tc >>= 1;  // a warp's clusters share a profile
  s.staged = stage(tc) <= STAGE_MOST;
  if (!s.staged) {
    tc = THREADS / lanes;
    if ((size_t)lanes * r_dims * 20 > SMEM_MOST / 2) tc = THREADS;  // wide R: one lane
  }
  lanes = THREADS / tc;
  s.tc_log2 = 0;
  while ((1 << s.tc_log2) < tc) ++s.tc_log2;
  const int r1 = r_dims > 0 ? r_dims : 1;
  const int chunks = MAGIC_PAIRS / (lanes * r1);
  const int most = (u_n + lanes - 1) / lanes;  // a lane's profiles at most
  s.pc = lanes * (chunks < 1 ? 1 : (chunks > most ? most : chunks));
  s.smem = (s.staged ? stage(tc) : 0) + (size_t)s.pc * r_dims * 20;
  return s;
}

const void* kernel_of(const Shape& s, int r_dims) {
  if (!s.staged) return (const void*)model_overlay_kernel<0, false>;
  if (r_dims > 4) return (const void*)model_overlay_kernel<0, true>;
  return (const void*)model_overlay_kernel<4, true>;
}

// the grid of shape s over C clusters x U profiles: every tile, and as many
// profile slices as one wave of resident blocks leaves room for (at least
// the lanes' profiles a block); per_block = profile rows a block
dim3 grid_of(const Shape& s, const void* kernel, int c_n, int u_n, int* per_block) {
  const int tc = 1 << s.tc_log2, lanes = THREADS / tc;
  const long long tiles = (c_n + tc - 1) / tc;
  const long long wave = (long long)resident_blocks(kernel, THREADS, s.smem) * sm_count();
  long long slices = (wave + tiles - 1) / tiles;
  const long long most = (u_n + lanes - 1) / lanes;
  slices = slices < 1 ? 1 : (slices > most ? most : slices);
  const int pb = (int)((u_n + slices - 1) / slices);
  *per_block = pb;
  return dim3((unsigned)tiles, (unsigned)((u_n + pb - 1) / pb));
}

}  // namespace

// table int32[U, C], in place: the model answer over the general one
extern "C" int model_overlay_launch(
    const int64_t* mb, const int32_t* counts, const uint8_t* covered, int c_n,
    int g_n, int r_dims, const int64_t* req, int u_n,
    const uint8_t* has_models, const uint8_t* has_summary, const int64_t* cap,
    int pods_dim, int32_t* table, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  const Shape s = shape_of(g_n, r_dims, u_n);
  if (s.smem > SMEM_MOST) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_of(s, r_dims);
  if (s.smem > 48 * 1024) {  // before the occupancy query, which reads it
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err) return err;
  }
  Args a{mb, counts, covered, req, has_models, has_summary, cap, table,
         c_n, g_n, r_dims, u_n, pods_dim, s.tc_log2, s.stride, s.gstride, s.pc, 0};
  const dim3 grid = grid_of(s, kernel, c_n, u_n, &a.per_block);
  void* params[] = {&a};
  return (int)cudaLaunchKernel(kernel, grid, dim3(THREADS), params, s.smem, stream);
}
