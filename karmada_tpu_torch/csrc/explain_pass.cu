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
// lax.top_k answers), computed as the same int64 expression whatever the
// range of avail.
//
// One block per row, THREADS threads. Each thread walks the row's clusters
// c = tid, tid + THREADS, ... (neighbouring threads on neighbouring cells:
// coalesced reads of every input and writes of the mask), writes each
// cell's mask byte and keeps its own top-8 of (key, index) in registers,
// sorted, by an unrolled insertion. The block then merges: k rounds of a
// block-wide arg-max over every thread's head (warp shuffles, then one
// warp over the per-warp winners); the thread that owned the winner pops
// it. Indices are unique, so each round has one winner. Threads s < k
// then gather the five columns of the s-th winner.
//
// What bounds it on an H100: bytes. A cell reads 4 bools, 4 int32 and one
// bool and writes one byte (22 bytes); a 4096 x 5000 chunk moves ~450 MB,
// ~0.13 ms at HBM rate. The per-cell work is a handful of compares and the
// 8-deep insertion, which issues well under the memory time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXK = 8;
constexpr int COLS = 5;

constexpr int BIT_AFFINITY = 0;
constexpr int BIT_TAINT = 1;
constexpr int BIT_API = 2;
constexpr int BIT_AVAILABILITY = 3;
constexpr int BIT_QUOTA_CAP = 4;
constexpr int BIT_QUOTA_ADMIT = 5;
constexpr int BIT_SPREAD = 6;
constexpr int BIT_PREEMPTED = 7;

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

__global__ void explain_pass_kernel(Inputs in, int c_n, int k, uint8_t* __restrict__ mask,
                                    int32_t* __restrict__ topk) {
  __shared__ long long warp_key[WARPS];
  __shared__ int warp_idx[WARPS];
  __shared__ int win[MAXK];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * c_n;
  const bool consults = in.dynamic[row] && in.replicas[row] > 0;
  const bool admitted = in.admitted[row] != 0;

  long long kk[MAXK];
  int ii[MAXK];
#pragma unroll
  for (int s = 0; s < MAXK; ++s) {
    kk[s] = 0;
    ii[s] = -1;
  }
  for (int c = threadIdx.x; c < c_n; c += THREADS) {
    const size_t cell = base + c;
    mask[cell] = cell_mask(in, cell, consults, admitted);
    long long key = (long long)in.assignment[cell] * (1LL << 32) + ((long long)in.avail[cell] + 1);
    int idx = c;
    // unrolled insertion into the sorted local list: the candidate sinks
    // past every entry it does not beat and displaces the rest downwards
#pragma unroll
    for (int s = 0; s < MAXK; ++s) {
      if (better(key, idx, kk[s], ii[s])) {
        const long long tk = kk[s];
        const int ti = ii[s];
        kk[s] = key;
        ii[s] = idx;
        key = tk;
        idx = ti;
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int round = 0; round < k; ++round) {
    long long bk = kk[0];
    int bi = ii[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long ok_ = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ok_, oi, bk, bi)) {
        bk = ok_;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_key[warp] = bk;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bk = lane < WARPS ? warp_key[lane] : 0;
      bi = lane < WARPS ? warp_idx[lane] : -1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const long long ok_ = __shfl_xor_sync(0xffffffffu, bk, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ok_, oi, bk, bi)) {
          bk = ok_;
          bi = oi;
        }
      }
      if (lane == 0) win[round] = bi;
    }
    __syncthreads();
    if (ii[0] >= 0 && ii[0] == win[round]) {  // the owner pops its head
#pragma unroll
      for (int s = 0; s + 1 < MAXK; ++s) {
        kk[s] = kk[s + 1];
        ii[s] = ii[s + 1];
      }
      kk[MAXK - 1] = 0;
      ii[MAXK - 1] = -1;
    }
  }

  if (threadIdx.x < k) {
    const int c = win[threadIdx.x];
    const size_t cell = base + c;
    int32_t* out = topk + ((size_t)row * k + threadIdx.x) * COLS;
    out[0] = c;
    out[1] = in.avail[cell];
    out[2] = in.prev[cell];
    out[3] = in.assignment[cell];
    out[4] = cell_mask(in, cell, consults, admitted);
  }
}

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
  Inputs in{aff_ok, taint_ok, api_ok, spread_ok, avail, caps, admitted, dynamic, replicas,
            assignment, prev, preempted};
  explain_pass_kernel<<<b_n, THREADS, 0, stream>>>(in, c_n, k, mask, topk);
  return (int)cudaGetLastError();
}
