// K12 quota_admit: FIFO quota admission of one wave, per namespace.
//
// Replaces karmada_tpu/ops/quota.py:64 quota_admit (the FederatedResourceQuota
// admission pass of karmada_tpu/scheduler/core.py:627 _quota_admission).
//
//   in:  ns_ids int32[B] (namespace row, < 0 = not quota'd),
//        demand int64[B, R] (>= 0, each <= DEMAND_CLAMP = 2^44),
//        remaining int64[N, R] (UNLIMITED = 2^62 where a dim has no limit)
//   out: admitted uint8[B], wave_used int64[N, R]
//
// A row is admitted iff, on every dim, the inclusive sum of the demand of the
// rows of its namespace up to and including it (arrival order) is at most
// the namespace's remaining quota. A denied row's demand still holds its
// place in line. wave_used[k] is the admitted demand of namespace k.
//
// The JAX program sorts by the key ns * B + row, takes one cumsum over the
// sorted wave and a cummax of the segment bases. That key makes the sorted
// order a stable partition by namespace, so no sort is needed: each
// namespace's segment is its own rows in row order, and one block owns it.
// Block k < N walks all B rows in tiles of THREADS; each tile takes a
// block-wide inclusive scan of its member rows' demand per dim, adds the
// carry from earlier tiles, compares with remaining[k], and carries the
// tile's sum on. More than MAX_R = 16 dims are taken MAX_R at a time, the
// block's shared memory holding one tile of dims: admission is separable by
// dim, so a row's verdict is the AND of its tiles' verdicts, and the
// admitted demand of every tile but the last is summed in a second walk
// over the rows. Block N owns every row whose id lies outside [0, N): JAX
// sends negative ids to one pad segment compared with UNLIMITED, and ids
// at or above N to segments whose remaining row is the UNLIMITED pad (a
// clamped gather); its scatter-add drops both. Under the demand contract
// (B <= 2^17 rows of at most 2^44) no segment sum reaches 2^62, so every
// such row is admitted in both, and they add nothing to wave_used. Block k
// writes wave_used[k] from a block reduction of its admitted demand: no
// atomics, no zeroed output.
//
// What bounds it on an H100: latency, not bytes. The wave is at most
// 131072 rows (ns 512 KB + demand 4 MB at R = 4, read once, < 2 us at
// HBM rate); each of the N + 1 blocks walks all B rows (the ns ids come from
// L2 after the first block), and a tile costs 2R block-wide scans or
// reductions, each a few shuffles and barriers (past 16 dims, the sums of
// the earlier dim tiles move to the second walk). Tiles with no member row are
// skipped with one barrier vote. The N + 1 blocks run on N + 1 SMs at
// once; the critical path is one block's 128 tiles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = 16;
constexpr long long UNLIMITED = 1LL << 62;

// inclusive block-wide sum scan of x; returns this thread's inclusive prefix
// and writes the block total to *total. Every thread must call it.
__device__ __forceinline__ long long block_scan(long long x, long long* warp_sums,
                                                long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long v = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;  // inclusive prefix over warps
  }
  __syncthreads();
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + v;
}

__global__ void quota_admit_kernel(const int32_t* __restrict__ ns_ids,
                                   const int64_t* __restrict__ demand,
                                   const int64_t* __restrict__ remaining,
                                   int b_n, int n_ns, int r_dims,
                                   uint8_t* __restrict__ admitted,
                                   int64_t* __restrict__ wave_used) {
  __shared__ long long warp_sums[WARPS];
  __shared__ long long rem[MAX_R];
  __shared__ long long carry[MAX_R];
  __shared__ long long used[MAX_R];
  const int k = blockIdx.x;  // namespace row; k == n_ns owns the rest
  const bool pad = k == n_ns;
  // admission, MAX_R dims at a time: a row's verdict on the dims of one
  // tile is ANDed into its admitted byte (each row is written by the one
  // thread that owns it, so the byte carries the verdict across tiles); in
  // the last tile the verdict is final and that tile's admitted demand is
  // summed on the way
  for (int r0 = 0; r0 < r_dims; r0 += MAX_R) {
    const int nr = r_dims - r0 < MAX_R ? r_dims - r0 : MAX_R;
    const bool last_tile = r0 + MAX_R >= r_dims;
    if (threadIdx.x < nr) {
      rem[threadIdx.x] =
          pad ? UNLIMITED : remaining[(size_t)k * r_dims + r0 + threadIdx.x];
      carry[threadIdx.x] = 0;
      used[threadIdx.x] = 0;
    }
    __syncthreads();
    for (int base = 0; base < b_n; base += THREADS) {
      const int row = base + threadIdx.x;
      bool member = false;
      if (row < b_n) {
        const int ns = ns_ids[row];
        member = pad ? (ns < 0 || ns >= n_ns) : ns == k;
      }
      if (!__syncthreads_or(member)) continue;  // no row of this segment here
      const int64_t* d_row = demand + (size_t)row * r_dims + r0;
      bool ok = r0 == 0 || (member && admitted[row] != 0);
      for (int r = 0; r < nr; ++r) {
        const long long x = member ? d_row[r] : 0;
        // every thread reads the carry before the scan's first barrier;
        // thread 0 moves it on after the scan's last one
        const long long before = carry[r];
        long long total;
        const long long incl = before + block_scan(x, warp_sums, &total);
        ok = ok && incl <= rem[r];
        if (threadIdx.x == 0) carry[r] = before + total;
      }
      if (member) admitted[row] = ok ? 1 : 0;
      if (pad || !last_tile) continue;  // the pad segment adds nothing to wave_used
      for (int r = 0; r < nr; ++r) {
        const long long x = member && ok ? d_row[r] : 0;
        long long total;
        block_scan(x, warp_sums, &total);
        if (threadIdx.x == 0) used[r] += total;
      }
    }
    __syncthreads();
    if (!pad && last_tile && threadIdx.x < nr) {
      wave_used[(size_t)k * r_dims + r0 + threadIdx.x] = used[threadIdx.x];
    }
    __syncthreads();  // rem, carry and used are reused by the next tile
  }
  // past MAX_R dims: the admitted demand of the tiles before the last
  if (pad) return;
  for (int r0 = 0; r0 + MAX_R < r_dims; r0 += MAX_R) {
    if (threadIdx.x < MAX_R) used[threadIdx.x] = 0;
    __syncthreads();
    for (int base = 0; base < b_n; base += THREADS) {
      const int row = base + threadIdx.x;
      const bool take = row < b_n && ns_ids[row] == k && admitted[row] != 0;
      if (!__syncthreads_or(take)) continue;
      const int64_t* d_row = demand + (size_t)row * r_dims + r0;
      for (int r = 0; r < MAX_R; ++r) {
        long long total;
        block_scan(take ? d_row[r] : 0, warp_sums, &total);
        if (threadIdx.x == 0) used[r] += total;
      }
    }
    __syncthreads();
    if (threadIdx.x < MAX_R) {
      wave_used[(size_t)k * r_dims + r0 + threadIdx.x] = used[threadIdx.x];
    }
    __syncthreads();
  }
}

}  // namespace

// admitted uint8[B], wave_used int64[N, R] = quota_admit(ns_ids, demand,
// remaining), for any R
extern "C" int quota_admit_launch(const int32_t* ns_ids, const int64_t* demand,
                                  const int64_t* remaining, int b_n, int n_ns,
                                  int r_dims, uint8_t* admitted,
                                  int64_t* wave_used, cudaStream_t stream) {
  quota_admit_kernel<<<n_ns + 1, THREADS, 0, stream>>>(
      ns_ids, demand, remaining, b_n, n_ns, r_dims, admitted, wave_used);
  return (int)cudaGetLastError();
}
