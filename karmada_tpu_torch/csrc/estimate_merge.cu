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
// 3.35 TB/s. The three entry points share one row-streaming body
// (row_tiles.cuh): a block owns a tile of columns, four adjacent columns a
// thread, and a run of rows (grid.x takes the runs, so any row count is one
// launch; rows a block are chosen for one wave of the blocks the card holds
// at once, four waves in the lean merge form, whose short tail that buys
// back); the run's row
// scalars (the clipped profile index and the replicas) are staged in
// shared memory with one coalesced load, so the row loop has no dependent
// global load; each row is one 16-B store a thread (row_tiles.cuh realigns
// a span that C % 4 != 0 leaves off a 16-B boundary).
//
// Division: no division instruction per cell. Each (profile, requested
// dim) gets a Granlund-Montgomery multiplier and shift (divmagic.cuh), and
// a thread stages its columns' capacities once, clamped to >= 0 and
// doubled, in registers (G = 4 dims at a time; up to 4 dims the warp reads
// its span's capacities in coalesced words, cp.async into shared memory and
// handed out from there, row_tiles.cuh, in flight while the multipliers
// are made). A
// table entry or a cell then costs a high product, a shift and a min per
// requested dim.
//
//   - estimate_merge_launch, up to U_SHARED profiles: a block computes the
//     U x tile profile table of its columns once, into shared memory, with
//     the no-summary mask folded in (a masked cell reads as no answer), and
//     streams its rows out of it: a 16-B shared load, the merge and a 16-B
//     store a row. A block is two row groups of 128 column threads, which
//     split the table's profiles and then the rows, and the grid holds at
//     most two blocks an SM: the table is the block's prologue, so fewer,
//     larger blocks compute fewer copies of it.
//   - above U_SHARED profiles (the un-interned schedule_step, where U ==
//     B) and in the table form, each row's multipliers are computed once
//     per block, and each cell takes R high products against them.
//   - the table form (profile_table_launch): row u is profile u, the
//     output the estimate itself, -1 where the cluster has no summary. At
//     its few rows a block shrinks to a warp or two, so that U = 8 x 5000
//     still fills the card: a few cells a thread.
//   - the merge form (estimate_merge_table_launch): per row the gathered
//     table row and every extra estimate of a group, 16-B loads each, the
//     running minimum in registers. A group is up to MAX_EXTRAS extra
//     pointers, passed by value in the kernel's parameters (no device array
//     of pointers, no copy a call), so E <= 32 is one launch and one pass
//     over the rows, RU rows a step. Up to one extra (the models, caps and
//     one-estimator paths take 0 or 1), every load of the step in flight
//     together; more, the running minimum and two extras a round.
//
// Integer division: JAX '//' floors; the multiplier gives the floor of a
// non-negative dividend, and the cap is clamped to >= 0 and the request is
// >= 1 before it (estimate.py:31-36). The min runs in 64 bits and is
// clamped to 2^31-1 before the cast to int32 (estimate.py:38), so an absurd
// ratio reads as the sentinel and never wraps.
//
// Table form (profile_table_launch): karmada_tpu/scheduler/core.py:2256
// _profile_table's general branch, the fleet path's per-profile table.
// Its bound is the U x C int32 write.
//
// Merge form (estimate_merge_table_launch): karmada_tpu/scheduler/core.py:
// 2376-2385, the gathered profile table min-merged with any number E of
// extra estimates (static-assignment caps, out-of-tree estimators), in
// groups of MAX_EXTRAS: each group is one launch, and a group after the
// first reads the running minimum the group before it wrote (to a scratch
// buffer and the output in turn, so that the last group writes the
// output). A running minimum keeps MAX_INT32 where no answer came yet; the
// zero-replica short-circuit and the sentinel clamp run in the last group
// only, after the last estimate, as merge_estimates applies them once
// (estimate.py:108-122).

#include <cstdint>
#include <cuda_runtime.h>

#include "divmagic.cuh"
#include "row_tiles.cuh"

namespace {

constexpr int COL_THREADS = 128;     // column threads a block (the table form: 32 to 128)
constexpr int SHARED_ROW_GROUPS = 2; // row groups a block of the shared-table form
constexpr int MAX_THREADS = COL_THREADS * SHARED_ROW_GROUPS;
constexpr int VEC = SPAN_VEC;        // columns a thread
constexpr int RU = 4;                // rows a step of the lean merge form
constexpr int LEAN_WAVES = 4;        // its grid: waves of resident blocks (a short tail)
constexpr int U_SHARED = 64;         // profiles held in the shared-memory table
constexpr int G = 4;                 // dims whose capacities stay in registers
constexpr int MAX_RB = 256;          // rows a block at most
constexpr int SHARED_BLOCKS_PER_SM = 2;  // the shared-table form's grid: fewer copies of the table
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int TABLE_BYTES = 32 * 1024;  // the shared table's aim
constexpr long long MAX_I32 = 2147483647LL;
constexpr int MAX_EXTRAS = 32;       // extra estimates a merge-form launch takes

enum Form { MERGE_SHARED = 0, MERGE_DIRECT = 1, TABLE = 2, MERGE_TABLE = 3 };

struct Extras {
  const int32_t* p[MAX_EXTRAS];
};

// one launch's arguments, passed by value
struct Args {
  const int64_t* cap;
  int c_n, r_dims;
  const int64_t* profiles;
  int u_n;
  const int32_t* idx;  // prof_idx or prof_inv
  const uint8_t* has_summary;
  const int32_t* replicas;
  int b_n;  // rows (the table form: U)
  const int32_t* table;  // the merge form's profile table, int32[U, C]
  const int32_t* acc;    // the earlier groups' running minimum, or null
  Extras ex;
  int e_n, last;
  int32_t* out;
};

// a launch's shape: ct column threads (a tile of 4 ct columns) times rg
// row groups a block; the smem layout tab int4[u_n][ct] | mult u64[pairs] |
// rowv int2[rb] | shift int[pairs] | span u64[ct / 32][SPAN_WORDS]
struct Shape {
  int ct, rg, rb, tiles, pairs;
  size_t smem;
};

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// the thread's capacities of dims [g0, g0 + G), clamped to >= 0 and doubled,
// one word a load (past G dims)
__device__ __forceinline__ void stage_caps(const int64_t* __restrict__ cap, int c_n,
                                           int r_dims, int c0, int g0,
                                           unsigned long long x2[VEC][G]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const long long a = c0 + j < c_n && g0 + r < r_dims
          ? __ldg(cap + (size_t)(c0 + j) * r_dims + g0 + r) : 0;
      x2[j][r] = (unsigned long long)(a > 0 ? a : 0) << 1;
    }
}

// the same from the warp's span words (r_dims <= G), read back from buf
__device__ __forceinline__ void staged_caps(const unsigned long long* buf, int r_dims, int lane,
                                            unsigned long long x2[VEC][G]) {
  long long raw[VEC][G];
  span_words_read<G>(buf, r_dims, lane, raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j)
#pragma unroll
    for (int r = 0; r < G; ++r) x2[j][r] = (unsigned long long)(raw[j][r] > 0 ? raw[j][r] : 0) << 1;
}

// the multipliers of `pairs` (profile, dim) pairs: pair p divides by
// profiles[prof(p) * r_dims + dim(p)]; 0 where the dim is not requested
template <typename Prof, typename Dim>
__device__ __forceinline__ void set_multipliers(const int64_t* __restrict__ profiles,
                                                int r_dims, int pairs, Prof prof, Dim dim,
                                                unsigned long long* mult, int* shift) {
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int r = dim(p);
    const long long d = r < r_dims ? profiles[(size_t)prof(p) * r_dims + r] : 0;
    unsigned long long m = 0;
    int l = 0;
    if (d > 0) magic((unsigned long long)d, m, l);
    mult[p] = m;
    shift[p] = l;
  }
}

// LEAN: in the estimate forms, r_dims <= G (the capacities from the warp's
// span, in registers); in the merge form, at most one extra, loaded with its
// row in a step of RU rows
template <int FORM, bool LEAN>
__global__ void __launch_bounds__(FORM == MERGE_SHARED ? MAX_THREADS : COL_THREADS,
                                  FORM == MERGE_TABLE && !LEAN ? 4 : 1)
estimate_merge_kernel(const Args a, int rb, int pairs, int ct) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int tc = threadIdx.x % ct, grp = threadIdx.x / ct, rg = blockDim.x / ct;
  const int u_n = a.u_n, c_n = a.c_n, r_dims = a.r_dims;
  const long long row0 = (long long)blockIdx.x * rb;
  const int rows = (int)min((long long)rb, (long long)a.b_n - row0);
  const int x0 = blockIdx.y * ct * VEC;
  const int c0 = x0 + tc * VEC;
  const int wbase = x0 + (tc & ~31) * VEC;  // the warp's span
  const int wn = min(SPAN_CELLS, c_n - wbase);
  const int tab_u = FORM == MERGE_SHARED ? u_n : 0;
  int4* tab = reinterpret_cast<int4*>(smem);  // [u][column thread]
  unsigned long long* mult = reinterpret_cast<unsigned long long*>(tab + (size_t)tab_u * ct);
  int2* rowv = reinterpret_cast<int2*>(mult + pairs);  // (profile, replicas) a row
  int* shift = reinterpret_cast<int*>(rowv + rb);
  unsigned long long* span = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<uintptr_t>(shift + pairs + 1) & ~(uintptr_t)7) + (size_t)(tc >> 5) * SPAN_WORDS;

  if (FORM != TABLE) {
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      int p = a.idx[row0 + i];
      if (p < 0) p += u_n;  // a negative index counts from the end
      p = p < 0 ? 0 : (p >= u_n ? u_n - 1 : p);  // then a jnp gather clamps
      rowv[i] = make_int2(p, a.replicas[row0 + i]);
    }
  }
  bool summary[VEC];
  if (FORM != MERGE_TABLE) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) summary[j] = c0 + j < c_n && a.has_summary[c0 + j] != 0;
  }
  unsigned long long x2[VEC][G];

  if constexpr (FORM == MERGE_SHARED) {
    // the U x tile table, a dim group at a time; the row groups split the
    // profiles, a thread its own columns
    const int groups = r_dims > G ? (r_dims + G - 1) / G : 1;
    for (int g = 0; g < groups; ++g) {
      const int g0 = g * G;
      if (g) __syncthreads();  // the group before is done with the multipliers
      if (LEAN && grp == 0)  // in flight over the multipliers
        span_words_fetch(a.cap + (size_t)wbase * r_dims, max(wn, 0) * r_dims, r_dims, span,
                         lane);
      __pipeline_commit();
      set_multipliers(a.profiles, r_dims, u_n * G, [](int p) { return p / G; },
                      [g0](int p) { return g0 + p % G; }, mult, shift);
      __pipeline_wait_prior(0);
      __syncthreads();
      if (LEAN) staged_caps(span, r_dims, lane, x2);
      else stage_caps(a.cap, c_n, r_dims, c0, g0, x2);
      for (int u = grp; u < u_n; u += rg) {
        unsigned long long best[VEC];
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) best[j] = MAX_I32;
        } else {
          const int4 t = tab[(size_t)u * ct + tc];
          best[0] = (unsigned)t.x, best[1] = (unsigned)t.y, best[2] = (unsigned)t.z,
          best[3] = (unsigned)t.w;
        }
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const unsigned long long m = mult[u * G + r];
          if (m == 0) continue;  // not requested: uniform over the warp
          const int l = shift[u * G + r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) best[j] = umin64(best[j], floor_doubled(m, l, x2[j][r]));
        }
        int32_t v[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)  // a masked cell: no answer, MAX_INT32 in the merge
          v[j] = g == groups - 1 && !summary[j] ? (int32_t)MAX_I32 : (int32_t)best[j];
        tab[(size_t)u * ct + tc] = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();  // the row scalars
    for (int i = grp; i < rows; i += rg) {
      const int2 rv = rowv[i];
      const int4 t = tab[(size_t)rv.x * ct + tc];
      const int32_t est[VEC] = {t.x, t.y, t.z, t.w};
      int32_t v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)  // zero replicas, or no answer: the replicas
        v[j] = rv.y == 0 || est[j] == (int32_t)MAX_I32 ? rv.y : est[j];
      store_span4(a.out + (size_t)(row0 + i) * c_n + wbase, wn, v, lane);
    }
  } else if constexpr (FORM == MERGE_DIRECT || FORM == TABLE) {
    if (LEAN)  // in flight over the multipliers
      span_words_fetch(a.cap + (size_t)wbase * r_dims, max(wn, 0) * r_dims, r_dims, span,
                       lane);
    __pipeline_commit();
    if (FORM == MERGE_DIRECT) __syncthreads();  // the row scalars name the profiles
    set_multipliers(a.profiles, r_dims, rows * r_dims,
                    [&](int p) { return FORM == TABLE ? (int)row0 + p / r_dims
                                                      : rowv[p / r_dims].x; },
                    [r_dims](int p) { return p % r_dims; }, mult, shift);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (LEAN) staged_caps(span, r_dims, lane, x2);
    for (int i = 0; i < rows; ++i) {
      const unsigned long long* mrow = mult + (size_t)i * r_dims;
      const int* lrow = shift + (size_t)i * r_dims;
      unsigned long long best[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) best[j] = MAX_I32;
      if constexpr (LEAN) {
#pragma unroll
        for (int r = 0; r < G; ++r) {
          if (r >= r_dims) break;
          const unsigned long long m = mrow[r];
          if (m == 0) continue;
          const int l = lrow[r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) best[j] = umin64(best[j], floor_doubled(m, l, x2[j][r]));
        }
      } else {  // past G dims, the capacities through L1, a group at a time
        for (int g0 = 0; g0 < r_dims; g0 += G) {
          stage_caps(a.cap, c_n, r_dims, c0, g0, x2);
#pragma unroll
          for (int r = 0; r < G; ++r) {
            if (g0 + r >= r_dims) break;
            const unsigned long long m = mrow[g0 + r];
            if (m == 0) continue;
            const int l = lrow[g0 + r];
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              best[j] = umin64(best[j], floor_doubled(m, l, x2[j][r]));
          }
        }
      }
      int32_t v[VEC];
      if constexpr (FORM == TABLE) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = summary[j] ? (int32_t)best[j] : -1;
      } else {
        const int reps = rowv[i].y;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int32_t est = summary[j] ? (int32_t)best[j] : (int32_t)MAX_I32;
          v[j] = reps == 0 || est == (int32_t)MAX_I32 ? reps : est;
        }
      }
      store_span4(a.out + (size_t)(row0 + i) * c_n + wbase, wn, v, lane);
    }
  } else if constexpr (LEAN) {  // MERGE_TABLE, at most one extra: RU rows a step
    __syncthreads();  // the row scalars
    for (int i0 = 0; i0 < rows; i0 += RU) {
      int32_t v[RU][VEC], x[RU][VEC];  // every load of the step in flight together
#pragma unroll
      for (int q = 0; q < RU; ++q) {
        if (i0 + q < rows) {
          const long long b = row0 + i0 + q;
          if (a.acc) load4(a.acc + (size_t)b * c_n, c0, c_n, v[q]);
          else load4(a.table + (size_t)rowv[i0 + q].x * c_n, c0, c_n, v[q]);
          if (a.e_n) load4(a.ex.p[0] + (size_t)b * c_n, c0, c_n, x[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < RU; ++q) {
        if (i0 + q < rows) {
          const int reps = rowv[i0 + q].y;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            int32_t t = v[q][j];
            if (!a.acc) t = t == -1 ? (int32_t)MAX_I32 : t;
            if (a.e_n && x[q][j] != -1 && x[q][j] < t) t = x[q][j];  // -1: no answer
            if (a.last) t = reps == 0 || t == (int32_t)MAX_I32 ? reps : t;
            v[q][j] = t;
          }
          store_span4(a.out + (size_t)(row0 + i0 + q) * c_n + wbase, wn, v[q], lane);
        }
      }
    }
  } else {  // MERGE_TABLE, more extras: RU rows a step, two extras a round
    __shared__ const int32_t* ex[MAX_EXTRAS];  // the group's extras, for run-time indices
    if (threadIdx.x < a.e_n) ex[threadIdx.x] = a.ex.p[threadIdx.x];
    __syncthreads();  // the row scalars and the extras
    for (int i0 = 0; i0 < rows; i0 += RU) {
      int32_t v[RU][VEC];  // in flight with the first round's extras
#pragma unroll
      for (int q = 0; q < RU; ++q) {
        if (i0 + q < rows) {
          if (a.acc) load4(a.acc + (size_t)(row0 + i0 + q) * c_n, c0, c_n, v[q]);
          else load4(a.table + (size_t)rowv[i0 + q].x * c_n, c0, c_n, v[q]);
        }
      }
#pragma unroll 1
      for (int e0 = 0; e0 < a.e_n; e0 += 2) {
        int32_t x[2][RU][VEC];
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int q = 0; q < RU; ++q)
            if (e0 + k < a.e_n && i0 + q < rows)
              load4(ex[e0 + k] + (size_t)(row0 + i0 + q) * c_n, c0, c_n, x[k][q]);
        if (e0 == 0) {  // the table's -1: no answer (a running minimum holds none)
#pragma unroll
          for (int q = 0; q < RU; ++q)
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[q][j] = v[q][j] == -1 ? (int32_t)MAX_I32 : v[q][j];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (e0 + k < a.e_n) {
#pragma unroll
            for (int q = 0; q < RU; ++q)
#pragma unroll
              for (int j = 0; j < VEC; ++j)  // -1: no answer
                v[q][j] = x[k][q][j] != -1 && x[k][q][j] < v[q][j] ? x[k][q][j] : v[q][j];
          }
      }
#pragma unroll
      for (int q = 0; q < RU; ++q) {
        if (i0 + q < rows) {
          if (a.last) {  // once, after the last estimate
            const int reps = rowv[i0 + q].y;
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              v[q][j] = reps == 0 || v[q][j] == (int32_t)MAX_I32 ? reps : v[q][j];
          }
          store_span4(a.out + (size_t)(row0 + i0 + q) * c_n + wbase, wn, v[q], lane);
        }
      }
    }
  }
}

// threads a block and shared memory for `form` over `a`, and the most rows a
// block may take; launch_form chooses the rows (rb) and fills in the rest
Shape shape_of(int form, const Args& a, int& most) {
  Shape s;
  s.ct = COL_THREADS;
  s.rg = form == MERGE_SHARED ? SHARED_ROW_GROUPS : 1;
  if (form == TABLE) {  // few rows: narrower blocks, so that the grid fills the card
    while (s.ct > 32 &&
           (long long)a.b_n * ((a.c_n + s.ct * VEC - 1) / (s.ct * VEC)) < 2LL * sm_count())
      s.ct /= 2;
  }
  if (form == MERGE_SHARED) {  // a table of many profiles: narrower tiles
    while (s.ct > 32 && (size_t)a.u_n * s.ct * sizeof(int4) > TABLE_BYTES) s.ct /= 2;
  }
  s.tiles = (a.c_n + s.ct * VEC - 1) / (s.ct * VEC);
  const size_t pair = sizeof(unsigned long long) + sizeof(int);
  const bool per_row = form == MERGE_DIRECT || form == TABLE;  // a row's own multipliers
  const bool spans = form != MERGE_TABLE && a.r_dims <= G;
  const size_t fixed = (form == MERGE_SHARED ? (size_t)a.u_n * s.ct * sizeof(int4)
                                               + (size_t)a.u_n * G * pair : 0)
                       + (spans ? (size_t)(s.ct / 32) * SPAN_WORDS * 8 + 8 : 0);
  const size_t row_bytes = sizeof(int2) + (per_row ? pair * a.r_dims : 0);
  const size_t room = fixed < (size_t)SMEM_DEFAULT ? SMEM_DEFAULT - fixed : 0;
  most = (int)(room / row_bytes);
  most = most < 1 ? 1 : (most > MAX_RB ? MAX_RB : most);
  s.rb = most;
  s.pairs = form == MERGE_SHARED ? a.u_n * G : (per_row ? s.rb * a.r_dims : 0);
  s.smem = fixed + (size_t)s.rb * row_bytes;
  return s;
}

// shared memory at the most rows a block
size_t shape_smem(int form, const Args& a) {
  int most;
  return shape_of(form, a, most).smem;
}

// the launch's shape: one wave of resident blocks (the shared-table form at
// most SHARED_BLOCKS_PER_SM an SM: each block computes its table once)
template <int FORM, bool LEAN>
Shape sized(const Args& a) {
  int most;
  Shape s = shape_of(FORM, a, most);  // at `most` rows a block
  int per_sm = resident_blocks((const void*)estimate_merge_kernel<FORM, LEAN>, s.ct * s.rg,
                               s.smem);
  if (FORM == MERGE_SHARED && per_sm > SHARED_BLOCKS_PER_SM) per_sm = SHARED_BLOCKS_PER_SM;
  if (FORM == MERGE_TABLE && LEAN) per_sm *= LEAN_WAVES;
  const int rb = rows_per_block(a.b_n, s.tiles, (long long)per_sm * sm_count(), most);
  const bool per_row = FORM == MERGE_DIRECT || FORM == TABLE;
  s.smem -= (size_t)(s.rb - rb) *
            (sizeof(int2) + (per_row ? (sizeof(unsigned long long) + sizeof(int)) * a.r_dims : 0));
  if (per_row) s.pairs = rb * a.r_dims;
  s.rb = rb;
  return s;
}

template <int FORM, bool LEAN>
int launch_form(const Args& a, cudaStream_t stream) {
  if (shape_smem(FORM, a) > (size_t)SMEM_DEFAULT) {  // past ~3000 dims
    const int err = (int)cudaFuncSetAttribute(
        estimate_merge_kernel<FORM, LEAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shape_smem(FORM, a));
    if (err) return err;
  }
  const Shape s = sized<FORM, LEAN>(a);
  estimate_merge_kernel<FORM, LEAN>
      <<<dim3((unsigned)((a.b_n + s.rb - 1) / s.rb), s.tiles), s.ct * s.rg, s.smem, stream>>>(
          a, s.rb, s.pairs, s.ct);
  return (int)cudaGetLastError();
}

int launch(int form, const Args& a, cudaStream_t stream) {
  const bool one = a.r_dims <= G;
  switch (form) {
    case MERGE_SHARED:
      return one ? launch_form<MERGE_SHARED, true>(a, stream)
                 : launch_form<MERGE_SHARED, false>(a, stream);
    case MERGE_DIRECT:
      return one ? launch_form<MERGE_DIRECT, true>(a, stream)
                 : launch_form<MERGE_DIRECT, false>(a, stream);
    case TABLE:
      return one ? launch_form<TABLE, true>(a, stream) : launch_form<TABLE, false>(a, stream);
    default:  // the lean merge form up to one extra
      return a.e_n <= 1 ? launch_form<MERGE_TABLE, true>(a, stream)
                        : launch_form<MERGE_TABLE, false>(a, stream);
  }
}

}  // namespace

extern "C" int estimate_merge_launch(
    const int64_t* cap, int c_n, int r_dims, const int64_t* profiles, int u_n,
    const int32_t* prof_idx, const uint8_t* has_summary,
    const int32_t* replicas, int b_n, int32_t* out, cudaStream_t stream) {
  if (b_n == 0 || c_n == 0) return 0;
  Args a = {};
  a.cap = cap, a.c_n = c_n, a.r_dims = r_dims, a.profiles = profiles, a.u_n = u_n;
  a.idx = prof_idx, a.has_summary = has_summary, a.replicas = replicas, a.b_n = b_n;
  a.out = out;
  return launch(u_n <= U_SHARED ? MERGE_SHARED : MERGE_DIRECT, a, stream);
}

// out int32[U, C] = has_summary ? general_estimate(profiles[u], c) : -1
extern "C" int profile_table_launch(
    const int64_t* cap, int c_n, int r_dims, const int64_t* profiles, int u_n,
    const uint8_t* has_summary, int32_t* out, cudaStream_t stream) {
  if (u_n == 0 || c_n == 0) return 0;
  Args a = {};
  a.cap = cap, a.c_n = c_n, a.r_dims = r_dims, a.profiles = profiles, a.u_n = u_n;
  a.has_summary = has_summary, a.b_n = u_n, a.out = out;
  return launch(TABLE, a, stream);
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
  Args a = {};
  a.c_n = c_n, a.u_n = u_n, a.idx = prof_inv, a.replicas = replicas, a.b_n = b_n;
  a.table = table;
  for (int g = 0; g < groups; ++g) {
    const int first = g * MAX_EXTRAS;
    a.e_n = e_n - first < MAX_EXTRAS ? e_n - first : MAX_EXTRAS;
    for (int k = 0; k < MAX_EXTRAS; ++k) a.ex.p[k] = k < a.e_n ? extras[first + k] : nullptr;
    a.last = g == groups - 1;
    // the last group writes out, the one before it scratch, and so on
    a.out = (groups - 1 - g) % 2 == 0 ? out : scratch;
    const int err = launch(MERGE_TABLE, a, stream);
    if (err) return err;
    a.acc = a.out;
  }
  return 0;
}
