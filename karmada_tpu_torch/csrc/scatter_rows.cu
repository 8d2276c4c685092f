// K6 scatter_rows: the dirty-row upsert of the fleet's resident state, and
// the resident commit of the entry-resident pass.
//
// Replaces karmada_tpu/scheduler/fleet.py:1120 _scatter_rows — for each of
// the table's state arrays (fleet.py:1113 _STATE_FIELDS: cp_idx, gvk_idx,
// prof_idx, replicas, strategy, fresh, prev_sites, prev_counts),
// state[rows] = vals — in ONE launch and in place; and the resident commit
// of fleet.py:355-371 (_fleet_solve: dynamic_update_slice over every row,
// or .at[where(valid, r, cap)].set(mode="drop")) as fleet_kernels.
// fleet_solve runs it: one field, entries[n, k_res] into prev_entries[cap,
// k_res] at commit[n], -1 for a row that did not change. As a second entry
// point, fleet.py:828 _gather_meta: the 2-byte wire of res_meta[rows] (rows
// -1 give 0), the changed-meta fallback when phase A's meta buffer
// overflows.
//
// What bounds it on an H100: bytes. The commit at config 5's cold pass
// moves 102,400 rows of 544 B in and out (111 MB, a 0.0335 ms bound at
// 3.35 TB/s): measured 0.0453 ms (1.35x; index_copy_ of the same rows
// 0.0549). On a steady pass every commit index is -1 and the work is one
// coalesced read of the 0.8 MB index: 0.0031 ms against a 0.0024 ms launch
// floor at its grid (the first-slice form, a block a row, 0.0640). The
// dirty upsert (512 rows of 281 B: 0.0035 ms, floor 0.0022) and the gather
// (65,536 rows: 0.0031, floor 0.0023) sit near their launch floors
// (PERF.md §6 rows 21 and 21g, k6_k7_variants.py).
//
// The design: one wave of resident blocks (row_tiles.cuh's occupancy
// query), never a block per row; 64 registers a thread, so that the
// commit's 400 blocks are resident at once. A warp's work item is a group
// of 32 rows, one field and one slice: the warp reads the group's 32
// indices in one coalesced load, drops the rows outside [0, cap) by ballot
// (a group with none left costs that load alone), ranks the rest into
// shared memory and copies its slice of them, taken as one stream of
// units, unit q of the stream being unit q % n_u of the (q / n_u)-th kept
// row: every lane busy whatever the row width (a 544-B row is 34 units of
// 16 B; 4-B and 1-B fields are one unit a row, a row a lane). A launch of
// few rows cuts each group's stream into slices, as many as the wave has
// warps for, so that its copies spread over the card instead of queueing
// in a few warps. A unit is the widest of 16, 8, 4, 2 and 1 B that divides
// the field's width and both base pointers (a view can start anywhere), so
// every row base of the field is aligned to it; each lane issues UNROLL
// loads before its stores (8 and 16 ran slower: more registers, fewer
// resident blocks). The fields' bases, widths and units come as one
// struct by value, so a pass needs one launch however many fields
// changed. Row ids stay int64 and row offsets are 64-bit products.
//
// The gather keeps the first-slice body (a thread a row, two byte stores):
// one 2-byte store a row and four rows a thread (one 16-B load of their
// indices, one 8-B store) measured no faster (0.0030 ms each, the body
// 0.0029-0.0030): it is two dependent loads behind a launch.
//
// Repeated rows: the host pads the dirty rows to a power of two by
// repeating the first row with its own values, and the commit names each
// row at most once with one value. Where one row is named twice, every
// write to it carries the same bytes, so which lane or warp writes last
// does not change the result.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_tiles.cuh"

namespace {

constexpr int MAX_FIELDS = 8;
constexpr int WARPS = 8;  // a block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;      // loads in flight a lane before its stores
constexpr int MIN_BLOCKS = 4;  // blocks a SM (64 registers): the commit's 400 in one wave

struct Fields {
  uint8_t* dst[MAX_FIELDS];
  const uint8_t* src[MAX_FIELDS];
  int width[MAX_FIELDS];  // bytes a row
  int unit[MAX_FIELDS];   // bytes a copy: 16, 8, 4, 2 or 1
  int n;
};

template <int U>
struct Unit;
template <>
struct Unit<16> {
  using T = uint4;
};
template <>
struct Unit<8> {
  using T = uint2;
};
template <>
struct Unit<4> {
  using T = uint32_t;
};
template <>
struct Unit<2> {
  using T = uint16_t;
};
template <>
struct Unit<1> {
  using T = uint8_t;
};

// the warp copies slice sl of `slices` of its nv kept rows of one field,
// taken as a stream of units: stream unit q is unit q % n_u of kept row
// q / n_u (dst row s_row[j], src row s_src[j]), a slice a run of whole
// 32-unit steps; a lane's UNROLL units are loaded, then stored, their (u,
// j) kept packed in one register each
template <int U>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src, int width,
                                          int nv, const long long* s_row, const int* s_src,
                                          int lane, int sl, int slices) {
  using T = typename Unit<U>::T;
  const int n_u = width / U;
  const int total = nv * n_u;
  const int step = ((total + slices - 1) / slices + 31) & ~31;
  const int q0 = sl * step, q1 = min(total, q0 + step);
  if (q0 >= q1) return;
  // lane's place in the stream and its step of 32 units
  int j = (q0 + lane) / n_u, u = q0 + lane - j * n_u;
  const int dq = 32 / n_u, dr = 32 - dq * n_u;
  for (int base = q0; base < q1; base += 32 * UNROLL) {
    T v[UNROLL];
    int uj[UNROLL];
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      uj[t] = u << 5 | j;
      if (base + lane + 32 * t < q1)
        v[t] = *reinterpret_cast<const T*>(src + (long long)s_src[j] * width + u * U);
      j += dq, u += dr;
      if (u >= n_u) u -= n_u, ++j;
    }
#pragma unroll
    for (int t = 0; t < UNROLL; ++t)
      if (base + lane + 32 * t < q1)
        *reinterpret_cast<T*>(dst + s_row[uj[t] & 31] * width + (uj[t] >> 5) * U) = v[t];
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    scatter_rows_kernel(Fields f, const int64_t* __restrict__ rows, int k, long long cap,
                        int slices) {
  __shared__ long long s_row[WARPS][32];
  __shared__ int s_src[WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long groups = ((long long)k + 31) / 32;
  const int per_group = f.n * slices;
  const long long items = groups * per_group;
  for (long long it = (long long)blockIdx.x * WARPS + w; it < items;
       it += (long long)gridDim.x * WARPS) {
    const long long g = it / per_group;
    const int fs = (int)(it - g * per_group);
    const int fi = fs / slices, sl = fs - fi * slices;
    const long long i = g * 32 + lane;
    const long long r = i < k ? __ldg(rows + i) : -1;
    const bool ok = r >= 0 && r < cap;
    const unsigned mask = __ballot_sync(0xffffffffu, ok);
    const int width = f.width[fi];
    if (mask == 0 || width <= 0) continue;  // uniform over the warp
    __syncwarp();  // the previous item's reads of s_row / s_src are done
    if (ok) {
      const int rank = __popc(mask & ((1u << lane) - 1u));
      s_row[w][rank] = r;
      s_src[w][rank] = (int)i;
    }
    __syncwarp();
    const int nv = __popc(mask);
    uint8_t* dst = f.dst[fi];
    const uint8_t* src = f.src[fi];
    const long long* sr = s_row[w];
    const int* ss = s_src[w];
    switch (f.unit[fi]) {
      case 16: copy_rows<16>(dst, src, width, nv, sr, ss, lane, sl, slices); break;
      case 8: copy_rows<8>(dst, src, width, nv, sr, ss, lane, sl, slices); break;
      case 4: copy_rows<4>(dst, src, width, nv, sr, ss, lane, sl, slices); break;
      case 2: copy_rows<2>(dst, src, width, nv, sr, ss, lane, sl, slices); break;
      default: copy_rows<1>(dst, src, width, nv, sr, ss, lane, sl, slices); break;
    }
  }
}

// a thread a row: the meta word's two low bytes (rows -1 give 0)
__global__ void gather_meta_kernel(const int32_t* __restrict__ res_meta,
                                   const int32_t* __restrict__ rows, int m_n,
                                   uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m_n) return;
  const int r = rows[i];
  const int32_t m = r >= 0 ? res_meta[r] : 0;
  out[2 * i] = (uint8_t)(m & 0xFF);
  out[2 * i + 1] = (uint8_t)((m >> 8) & 0xFF);
}

constexpr int GATHER_THREADS = 256;

// the widest unit of 16, 8, 4, 2, 1 B that divides the width and both bases
int unit_of(const void* dst, const void* src, int width) {
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)(unsigned)width;
  for (int u = 16; u > 1; u >>= 1)
    if ((a & (uintptr_t)(u - 1)) == 0) return u;
  return 1;
}

struct Grid {
  int slices, blocks;
};

// the scatter's grid: a warp an item (32 rows x one field x one slice), at
// most one wave of resident blocks. A group's rows are cut into as many
// slices (at most 32) as that wave has warps for, and no more than the
// widest row has units, so that a slice of it is at least a 32-unit step:
// a launch of few rows (a dirty upsert, a small table's commit) spreads its
// copies over the card instead of queueing them in a few warps
Grid scatter_grid(int k, int n_fields, int widest_units) {
  const long long items = (((long long)k + 31) / 32) * n_fields;
  const long long wave =
      (long long)resident_blocks((const void*)scatter_rows_kernel, THREADS, 0) * sm_count();
  long long slices = wave * WARPS / items;
  slices = slices > widest_units ? widest_units : slices;
  slices = slices > 32 ? 32 : (slices < 1 ? 1 : slices);
  long long blocks = (items * slices + WARPS - 1) / WARPS;
  blocks = blocks < wave ? blocks : wave;
  return Grid{(int)slices, (int)(blocks < 1 ? 1 : blocks)};
}

}  // namespace

extern "C" int scatter_rows_launch(void* const* dst, void* const* src,
                                   const int* width, int n_fields,
                                   const int64_t* rows, int k, int cap,
                                   cudaStream_t stream) {
  if (n_fields < 1 || n_fields > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  Fields f;
  f.n = n_fields;
  int widest = 1;  // units a row
  for (int i = 0; i < MAX_FIELDS; ++i) {
    const bool on = i < n_fields;
    f.dst[i] = on ? (uint8_t*)dst[i] : nullptr;
    f.src[i] = on ? (const uint8_t*)src[i] : nullptr;
    f.width[i] = on ? width[i] : 0;
    f.unit[i] = on ? unit_of(dst[i], src[i], width[i]) : 1;
    if (on && width[i] / f.unit[i] > widest) widest = width[i] / f.unit[i];
  }
  const Grid g = scatter_grid(k, n_fields, widest);
  scatter_rows_kernel<<<g.blocks, THREADS, 0, stream>>>(f, rows, k, cap, g.slices);
  return (int)cudaGetLastError();
}

extern "C" int gather_meta_launch(const int32_t* res_meta, int cap,
                                  const int32_t* rows, int m_n, uint8_t* out,
                                  cudaStream_t stream) {
  (void)cap;
  if (m_n == 0) return 0;
  gather_meta_kernel<<<(m_n + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS, 0, stream>>>(
      res_meta, rows, m_n, out);
  return (int)cudaGetLastError();
}
