// K14 explain_pass: placement provenance of one chunk — the per-cell stage
// exclusion bitmask and the per-row top-k candidate summary.
//
// Replaces karmada_tpu/ops/explain.py:68 explain_pass (the armed-only
// capture of karmada_tpu/scheduler/core.py:1325 _explain_chunk).
//
//   in:  aff_ok, taint_ok, api_ok, spread_ok uint8[B, C] (bool),
//        avail, caps int32[B, C], admitted, dynamic uint8[B] (bool),
//        replicas int32[B], assignment, prev int32[B, C],
//        preempted uint8[B, C] (bool), k <= 8, k <= C
//   out: mask uint8[B, C], topk int32[B, k, 5]
//        (cluster index, avail, prev, assignment, mask byte)
//
// mask[b, c] ORs one bit per stage that excludes cluster c (bit order of
// utils/reasons.py STAGE_REASONS). The availability and cap bits count only
// where the row consults the estimator (dynamic and replicas > 0). The
// top-k ranks the row's clusters by the int64 key
// assignment * 2^32 + avail + 1, descending, ties to the lower index (what
// lax.top_k answers), computed as the same wrapping int64 expression
// whatever the range of its operands.
//
// What bounds it on an H100: bytes. A cell reads 5 bools and 3 int32 and
// writes one byte (18 bytes; prev is read at the k winners only): a 4096 x
// 5000 chunk moves ~369 MB, ~0.110 ms at HBM rate. The design keeps every
// other cost under that:
//
// - A warp per row, 8 rows a block: the merge of the row's top-k is warp
//   shuffles, with no block barrier.
// - 16 consecutive cells a lane a step: one 16-B load per bool plane, four
//   per int32 plane, the 16 mask bytes in one 16-B store, and the stage
//   bits formed 4 cells a word (__vcmpeq4 against 0). A row whose byte
//   start is not 16-B aligned takes its first (16 - start mod 16) cells and
//   its last (C - head) mod 16 cells one a lane; the planes' own base
//   addresses must be 16-B aligned for the vector body (the wrapper's
//   tensors are; any other launch takes every cell one a lane).
// - The row's top-k is one sorted queue across the warp: lane s < k holds
//   the s-th entry, and every lane holds the k-th, the threshold. A lane's
//   key is offered only if it beats the threshold; a ballot collects the
//   few that do, and each enters by a ballot for its place and one shuffle
//   up (about 20 instructions for the warp). A queue kept per lane would
//   run its insertion for nearly every cell: one of the 32 lanes nearly
//   always has a key that beats its own list, and the warp waits for it.
//   While the queue is short (the first step), each lane's best of its 16
//   enters first, so the threshold is high before the rest are offered.
//   Lane s then gathers the s-th winner's five columns; no merge remains.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXK = 8;
constexpr int COLS = 5;
constexpr int VEC = 16;  // cells a lane a step

constexpr int BIT_AFFINITY = 0;
constexpr int BIT_TAINT = 1;
constexpr int BIT_API = 2;
constexpr int BIT_AVAILABILITY = 3;
constexpr int BIT_QUOTA_CAP = 4;
constexpr int BIT_QUOTA_ADMIT = 5;
constexpr int BIT_SPREAD = 6;
constexpr int BIT_PREEMPTED = 7;
constexpr uint32_t ONES = 0x01010101u;  // one bit at the bottom of each byte

// (key a, index ia) ranks before (key b, index ib); an index < 0 is an
// empty slot and ranks after everything
__device__ __forceinline__ bool better(long long a, int ia, long long b, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  return a > b || (a == b && ia < ib);
}

struct Inputs {
  const uint8_t* aff_ok;
  const uint8_t* taint_ok;
  const uint8_t* api_ok;
  const uint8_t* spread_ok;
  const int32_t* avail;
  const int32_t* caps;
  const uint8_t* admitted;
  const uint8_t* dynamic;
  const int32_t* replicas;
  const int32_t* assignment;
  const int32_t* prev;
  const uint8_t* preempted;
};

// the key assignment * 2^32 + avail + 1 as JAX computes it in int64, with
// its wrap-around (formed in uint64: signed overflow is undefined in C++)
__device__ __forceinline__ long long key_of(int32_t assignment, int32_t avail) {
  return (long long)(((unsigned long long)(uint32_t)assignment << 32) +
                     (unsigned long long)(long long)avail + 1ULL);
}

__device__ __forceinline__ uint8_t cell_mask(const Inputs& in, size_t cell, bool consults,
                                             bool admitted) {
  unsigned m = 0;
  m |= (in.aff_ok[cell] ? 0u : 1u) << BIT_AFFINITY;
  m |= (in.taint_ok[cell] ? 0u : 1u) << BIT_TAINT;
  m |= (in.api_ok[cell] ? 0u : 1u) << BIT_API;
  m |= (consults && in.avail[cell] <= 0 ? 1u : 0u) << BIT_AVAILABILITY;
  m |= (consults && in.caps[cell] <= 0 ? 1u : 0u) << BIT_QUOTA_CAP;
  m |= (admitted ? 0u : 1u) << BIT_QUOTA_ADMIT;
  m |= (in.spread_ok[cell] ? 0u : 1u) << BIT_SPREAD;
  m |= (in.preempted[cell] ? 1u : 0u) << BIT_PREEMPTED;
  return (uint8_t)m;
}

// the bytes of the 4 cells of `w` whose int32 value is <= 0, one bit each
__device__ __forceinline__ uint32_t le0(int4 v) {
  return (uint32_t)(v.x <= 0) | ((uint32_t)(v.y <= 0) << 8) | ((uint32_t)(v.z <= 0) << 16) |
         ((uint32_t)(v.w <= 0) << 24);
}

__device__ __forceinline__ uint32_t word(uint4 v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ int32_t lane_of(int4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

constexpr unsigned FULL = 0xffffffffu;

// The row's top-k as a warp-wide sorted queue: lane s < k holds the s-th
// entry (qk, qi), qi < 0 an empty slot; (tk, ti), the k-th entry, is the
// threshold every lane holds. A key enters only if it beats the threshold.
struct Queue {
  long long qk = 0, tk = 0;
  int qi = -1, ti = -1;

  // insert (ck, ci), the same on every lane
  __device__ __forceinline__ void insert(long long ck, int ci, int lane, int k) {
    if (!better(ck, ci, tk, ti)) return;  // uniform
    const bool before = lane < k && better(qk, qi, ck, ci);  // a prefix of the lanes
    const int p = __popc(__ballot_sync(FULL, before));      // < k: it beats the k-th
    const long long uk = __shfl_up_sync(FULL, qk, 1);
    const int ui = __shfl_up_sync(FULL, qi, 1);
    if (lane == p) {
      qk = ck;
      qi = ci;
    } else if (lane > p) {
      qk = uk;
      qi = ui;
    }
    tk = __shfl_sync(FULL, qk, k - 1);
    ti = __shfl_sync(FULL, qi, k - 1);
  }

  // every lane offers one (key, idx) (`valid` lanes only): the few that beat
  // the threshold enter one at a time
  __device__ __forceinline__ void offer(long long key, int idx, bool valid, int lane, int k) {
    unsigned m = __ballot_sync(FULL, valid && better(key, idx, tk, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(FULL, key, src), __shfl_sync(FULL, idx, src), lane, k);
    }
  }
};

__global__ void __launch_bounds__(THREADS)
explain_pass_kernel(Inputs in, int b_n, int c_n, int k, int vec, uint8_t* __restrict__ mask,
                    int32_t* __restrict__ topk) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= b_n) return;  // a whole warp: no block barrier follows
  const size_t base = (size_t)row * c_n;
  const bool consults = in.dynamic[row] && in.replicas[row] > 0;
  const bool admitted = in.admitted[row] != 0;
  Queue q;

  // cells [lo, hi) one a lane, 32 a step (every lane runs every step)
  auto scalar = [&](int lo, int hi) {
    for (int c0 = lo; c0 < hi; c0 += 32) {
      const int c = c0 + lane;
      const bool valid = c < hi;
      long long key = 0;
      if (valid) {
        const size_t cell = base + c;
        mask[cell] = cell_mask(in, cell, consults, admitted);
        key = key_of(in.assignment[cell], in.avail[cell]);
      }
      q.offer(key, c, valid, lane, k);
    }
  };

  // head [0, h) and tail [h + 16 g, C) one a lane; the body 16 a lane
  int h = vec ? (int)((VEC - (base & (VEC - 1))) & (VEC - 1)) : c_n;
  h = h < c_n ? h : c_n;
  const int groups = (c_n - h) / VEC;
  const int body_end = h + groups * VEC;
  scalar(0, h);

  const uint32_t cons = consults ? ~0u : 0u;
  const uint32_t admit_bits = admitted ? 0u : ONES << BIT_QUOTA_ADMIT;
  for (int g0 = 0; g0 < groups; g0 += 32) {
    const int g = g0 + lane;
    const bool valid = g < groups;
    const int c0 = h + g * VEC;
    int4 av[4] = {}, as[4] = {};
    if (valid) {
      const size_t cell0 = base + c0;  // a multiple of 16
      const uint4 aff = *reinterpret_cast<const uint4*>(in.aff_ok + cell0);
      const uint4 taint = *reinterpret_cast<const uint4*>(in.taint_ok + cell0);
      const uint4 api = *reinterpret_cast<const uint4*>(in.api_ok + cell0);
      const uint4 spread = *reinterpret_cast<const uint4*>(in.spread_ok + cell0);
      const uint4 pre = *reinterpret_cast<const uint4*>(in.preempted + cell0);
      int4 cp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        av[j] = *reinterpret_cast<const int4*>(in.avail + cell0 + 4 * j);
        cp[j] = *reinterpret_cast<const int4*>(in.caps + cell0 + 4 * j);
        as[j] = *reinterpret_cast<const int4*>(in.assignment + cell0 + 4 * j);
      }
      uint32_t mw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mw[j] = (__vcmpeq4(word(aff, j), 0u) & (ONES << BIT_AFFINITY)) |
                (__vcmpeq4(word(taint, j), 0u) & (ONES << BIT_TAINT)) |
                (__vcmpeq4(word(api, j), 0u) & (ONES << BIT_API)) |
                ((le0(av[j]) << BIT_AVAILABILITY) & cons) |
                ((le0(cp[j]) << BIT_QUOTA_CAP) & cons) | admit_bits |
                (__vcmpeq4(word(spread, j), 0u) & (ONES << BIT_SPREAD)) |
                (~__vcmpeq4(word(pre, j), 0u) & (ONES << BIT_PREEMPTED));
      }
      *reinterpret_cast<uint4*>(mask + cell0) = make_uint4(mw[0], mw[1], mw[2], mw[3]);
    }
    // while the queue is short (the first step), each lane's best of its 16
    // enters first, so the threshold is already high when the rest are offered
    int skip = -1;
    if (q.ti < 0) {  // uniform
      long long bk = 0;
      int bi = -1;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const long long key = key_of(lane_of(as[j / 4], j % 4), lane_of(av[j / 4], j % 4));
        if (valid && better(key, c0 + j, bk, bi)) {
          bk = key;
          bi = c0 + j;
        }
      }
      for (int src = 0; src < 32; ++src) {
        const int ci = __shfl_sync(FULL, bi, src);
        const long long ck = __shfl_sync(FULL, bk, src);
        if (ci >= 0) q.insert(ck, ci, lane, k);
      }
      skip = bi;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      q.offer(key_of(lane_of(as[j / 4], j % 4), lane_of(av[j / 4], j % 4)), c0 + j,
              valid && c0 + j != skip, lane, k);
  }
  scalar(body_end, c_n);

  // lane s < k holds the s-th winner; it gathers the five columns
  if (lane < k) {
    const int c = q.qi;
    const size_t cell = base + c;
    int32_t* out = topk + ((size_t)row * k + lane) * COLS;
    out[0] = c;
    out[1] = in.avail[cell];
    out[2] = in.prev[cell];
    out[3] = in.assignment[cell];
    out[4] = cell_mask(in, cell, consults, admitted);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// mask uint8[B, C], topk int32[B, k, 5] = explain_pass(...); 1 <= k <= 8,
// k <= C (the wrapper checks)
extern "C" int explain_pass_launch(const uint8_t* aff_ok, const uint8_t* taint_ok,
                                   const uint8_t* api_ok, const uint8_t* spread_ok,
                                   const int32_t* avail, const int32_t* caps,
                                   const uint8_t* admitted, const uint8_t* dynamic,
                                   const int32_t* replicas, const int32_t* assignment,
                                   const int32_t* prev, const uint8_t* preempted, int b_n,
                                   int c_n, int k, uint8_t* mask, int32_t* topk,
                                   cudaStream_t stream) {
  if (k < 1 || k > MAXK || k > c_n) return (int)cudaErrorInvalidValue;
  if (b_n == 0) return 0;
  Inputs in{aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted, dynamic, replicas,
            assignment, prev, preempted};
  const int vec = aligned16(aff_ok) && aligned16(taint_ok) && aligned16(api_ok) &&
                  aligned16(spread_ok) && aligned16(preempted) && aligned16(avail) &&
                  aligned16(caps) && aligned16(assignment) && aligned16(mask);
  explain_pass_kernel<<<(b_n + WARPS - 1) / WARPS, THREADS, 0, stream>>>(in, b_n, c_n, k, vec,
                                                                         mask, topk);
  return (int)cudaGetLastError();
}
