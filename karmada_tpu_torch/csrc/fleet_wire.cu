// K5 fleet_wire: ordered capped stream compaction and the wire serialisers.
//
// Replaces the global tails of the two fleet phases:
//   karmada_tpu/scheduler/fleet.py:652-707   _fleet_pass' wire: the changed
//     rows' metas (with min(dcount, 63) << 10 in the spare bits) and table
//     rows compacted into m_cap slots, the changed-row bitmask, and, when
//     d_cap > 0, the cell deltas of changed rows with dcount <= 62
//     compacted into d_cap slots. Layout:
//       4 B total | n/8 B bitmask (bit j of byte k = row 8k + j) |
//       m_cap x 2 B metas | [4 B dtotal | d_cap x 3 B deltas]
//   karmada_tpu/scheduler/fleet.py:747-769   _fleet_entries' compaction of
//     the positive entry words into e_cap slots and its wire: 4 B total |
//     3 B an entry, or the 21-bit stream plus 3 pad bytes
//     (_entry_wire/_pack21, fleet.py:134-166); int32 [total, stream] when
//     the site does not fit 16 bits.
// Each compaction is the JAX cumsum-and-scatter: total counts every
// flagged item, out[k] for k < cap is the k-th flagged value in input
// order, and the slots past the total keep their fill (0, or -1 for the
// row buffer).
//
// What bounds it on an H100: bytes. A phase-A pass reads n_pad x (64 x 4 +
// 12) B (the delta slots, the changed flag, the meta word and the delta
// count) — 27 MB at n_pad = 102,400, about 0.01 ms at 3.35 TB/s — and
// writes a wire of under a megabyte on a steady pass. The design is the
// plain two-pass scan, enough at these sizes: a count pass (a block per
// 2048 items, 8 consecutive items a thread), one block that scans the
// block counts into offsets and the total, and a write pass that rescans
// its block to rank each item. The serialiser then writes every output
// byte from the compacted int32 streams, one thread a byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 8;                  // items a thread
constexpr int ITEMS = THREADS * PER;    // items a block (fleet_kernels._ITEMS)

__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < WARPS; ++k) {
      const int t = s_warp[k];
      s_warp[k] = acc;
      acc += t;
    }
    s_warp[WARPS] = acc;
  }
  __syncthreads();
  const int out = s_warp[wid] + x - v;
  *total = s_warp[WARPS];
  __syncthreads();
  return out;
}

// changed rows -> (wire meta, table row)
struct RowSrc {
  const uint8_t* changed;
  const int32_t* meta;
  const int32_t* dcount;
  const int32_t* rows;
  __device__ bool flag(long long i) const { return changed[i] != 0; }
  __device__ int32_t v0(long long i) const {
    const int32_t d = dcount[i];
    return meta[i] | ((d < 63 ? d : 63) << 10);
  }
  __device__ int32_t v1(long long i) const {
    const int32_t r = rows[i];
    return r > 0 ? r : 0;
  }
};

// delta words of changed rows whose dcount fits the meta field
struct DeltaSrc {
  const uint8_t* changed;
  const int32_t* dcount;
  const int32_t* deltas;
  int d_slots;
  __device__ bool flag(long long i) const {
    const long long row = i / d_slots;
    return changed[row] != 0 && dcount[row] <= 62 && deltas[i] != 0;
  }
  __device__ int32_t v0(long long i) const { return deltas[i]; }
  __device__ int32_t v1(long long) const { return 0; }
};

// positive entry words
struct EntrySrc {
  const int32_t* e;
  __device__ bool flag(long long i) const { return e[i] > 0; }
  __device__ int32_t v0(long long i) const { return e[i]; }
  __device__ int32_t v1(long long) const { return 0; }
};

template <class S>
__global__ void count_kernel(S s, long long n, int32_t* blk) {
  __shared__ int s_warp[WARPS + 1];
  const long long i0 = (long long)blockIdx.x * ITEMS + threadIdx.x * PER;
  int cnt = 0;
  for (int k = 0; k < PER; ++k) {
    const long long i = i0 + k;
    cnt += (i < n && s.flag(i)) ? 1 : 0;
  }
  int total;
  block_scan(cnt, s_warp, &total);
  if (threadIdx.x == 0) blk[blockIdx.x] = total;
}

// one block: exclusive offsets of the block counts, and the total
__global__ void scan_kernel(const int32_t* blk, int32_t* off, int nb,
                            int32_t* total_out) {
  __shared__ int s_warp[WARPS + 1];
  int carry = 0;
  for (int base = 0; base < nb; base += THREADS) {
    const int b = base + threadIdx.x;
    const int v = b < nb ? blk[b] : 0;
    int tile;
    const int ex = block_scan(v, s_warp, &tile);
    if (b < nb) off[b] = carry + ex;
    carry += tile;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

template <class S>
__global__ void write_kernel(S s, long long n, const int32_t* off, int cap,
                             int32_t* out0, int32_t* out1) {
  __shared__ int s_warp[WARPS + 1];
  const long long i0 = (long long)blockIdx.x * ITEMS + threadIdx.x * PER;
  bool f[PER];
  int cnt = 0;
  for (int k = 0; k < PER; ++k) {
    const long long i = i0 + k;
    f[k] = i < n && s.flag(i);
    cnt += f[k] ? 1 : 0;
  }
  int total;
  long long pos = (long long)off[blockIdx.x] + block_scan(cnt, s_warp, &total);
  for (int k = 0; k < PER; ++k) {
    if (!f[k]) continue;
    if (pos < cap) {
      out0[pos] = s.v0(i0 + k);
      if (out1) out1[pos] = s.v1(i0 + k);
    }
    ++pos;
  }
}

template <class S>
cudaError_t compact(S s, long long n, int cap, int32_t* out0, int32_t* out1,
                    int32_t* scratch, int nb_max, int32_t* total,
                    cudaStream_t stream) {
  const long long nb = (n + ITEMS - 1) / ITEMS;
  if (nb == 0) return cudaMemsetAsync(total, 0, sizeof(int32_t), stream);
  if (nb > nb_max) return cudaErrorInvalidValue;
  int32_t* blk = scratch;
  int32_t* off = scratch + nb_max;
  count_kernel<S><<<(unsigned)nb, THREADS, 0, stream>>>(s, n, blk);
  scan_kernel<<<1, THREADS, 0, stream>>>(blk, off, (int)nb, total);
  write_kernel<S><<<(unsigned)nb, THREADS, 0, stream>>>(s, n, off, cap, out0,
                                                        out1);
  return cudaGetLastError();
}

__device__ __forceinline__ uint8_t le_byte(int32_t v, int k) {
  return (uint8_t)((v >> (8 * k)) & 0xFF);
}

__global__ void ser_pass_kernel(uint8_t* flat, long long len, int n,
                                const uint8_t* changed, int m_cap,
                                const int32_t* mstream, int d_cap,
                                const int32_t* dstream,
                                const int32_t* totals) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= len) return;
  long long q = p;
  if (q < 4) { flat[p] = le_byte(totals[0], (int)q); return; }
  q -= 4;
  const long long n_mask = n / 8;
  if (q < n_mask) {
    uint8_t b = 0;
    for (int j = 0; j < 8; ++j) b |= (changed[8 * q + j] != 0 ? 1 : 0) << j;
    flat[p] = b;
    return;
  }
  q -= n_mask;
  if (q < 2LL * m_cap) { flat[p] = le_byte(mstream[q >> 1], (int)(q & 1)); return; }
  q -= 2LL * m_cap;
  if (q < 4) { flat[p] = le_byte(totals[1], (int)q); return; }
  q -= 4;
  flat[p] = le_byte(dstream[q / 3], (int)(q % 3));
}

__global__ void ser_entries_kernel(uint8_t* flat, long long len,
                                   const int32_t* stream, int e_cap,
                                   int pack21, const int32_t* totals) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= len) return;
  if (p < 4) { flat[p] = le_byte(totals[0], (int)p); return; }
  const long long q = p - 4;
  if (!pack21) { flat[p] = le_byte(stream[q / 3], (int)(q % 3)); return; }
  const long long nb21 = (21LL * e_cap + 7) / 8;
  if (q >= nb21) { flat[p] = 0; return; }  // the decoder's 3 pad bytes
  // _pack21: byte q draws from the fields at bits [8q, 8q + 8)
  const long long idx = 8 * q;
  const long long k1 = idx / 21;
  const int sh = (int)(idx - 21 * k1);
  const long long k2 = k1 + 1 < e_cap ? k1 + 1 : e_cap;
  const long long lo = (long long)(k1 < e_cap ? stream[k1] : 0) >> sh;
  const long long hi = (long long)(k2 < e_cap ? stream[k2] : 0) << (21 - sh);
  flat[p] = (uint8_t)((lo | hi) & 0xFF);
}

unsigned blocks_for(long long len) {
  return (unsigned)((len + THREADS - 1) / THREADS);
}

}  // namespace

// scratch: int32[2 * nb_max + 4] (block counts, offsets, two totals)
extern "C" int fleet_wire_launch(
    const uint8_t* changed, const int32_t* meta, const int32_t* dcount,
    const int32_t* rows, const int32_t* deltas, int n, int d_slots, int m_cap,
    int d_cap, int32_t* mstream, int32_t* rowbuf, int32_t* dstream,
    uint8_t* flat, int32_t* scratch, int nb_max, cudaStream_t stream) {
  int32_t* totals = scratch + 2 * nb_max;
  cudaError_t err;
  if ((err = cudaMemsetAsync(mstream, 0, (size_t)m_cap * 4, stream)) ||
      (err = cudaMemsetAsync(rowbuf, 0xFF, (size_t)m_cap * 4, stream)) ||
      (err = cudaMemsetAsync(totals, 0, 2 * sizeof(int32_t), stream)))
    return (int)err;
  err = compact(RowSrc{changed, meta, dcount, rows}, n, m_cap, mstream, rowbuf,
                scratch, nb_max, totals, stream);
  if (err) return (int)err;
  if (d_cap) {
    if ((err = cudaMemsetAsync(dstream, 0, (size_t)d_cap * 4, stream)))
      return (int)err;
    err = compact(DeltaSrc{changed, dcount, deltas, d_slots},
                  (long long)n * d_slots, d_cap, dstream, nullptr, scratch,
                  nb_max, totals + 1, stream);
    if (err) return (int)err;
  }
  const long long len = 4 + n / 8 + 2LL * m_cap + (d_cap ? 4 + 3LL * d_cap : 0);
  ser_pass_kernel<<<blocks_for(len), THREADS, 0, stream>>>(
      flat, len, n, changed, m_cap, mstream, d_cap, dstream, totals);
  return (int)cudaGetLastError();
}

// byte_wire: out is uint8 (4 + 3 e_cap, or 4 + ceil(21 e_cap / 8) + 3
// with pack21); otherwise out is int32[1 + e_cap] = [total, stream]
extern "C" int entry_wire_launch(const int32_t* entries, long long n,
                                 int e_cap, int byte_wire, int pack21,
                                 int32_t* stream, void* out, int32_t* scratch,
                                 int nb_max, cudaStream_t cu_stream) {
  int32_t* totals = scratch + 2 * nb_max;
  int32_t* dst = byte_wire ? stream : (int32_t*)out + 1;
  cudaError_t err;
  if ((err = cudaMemsetAsync(dst, 0, (size_t)e_cap * 4, cu_stream)))
    return (int)err;
  err = compact(EntrySrc{entries}, n, e_cap, dst, nullptr, scratch, nb_max,
                totals, cu_stream);
  if (err) return (int)err;
  if (!byte_wire)
    return (int)cudaMemcpyAsync(out, totals, sizeof(int32_t),
                                cudaMemcpyDeviceToDevice, cu_stream);
  const long long len =
      4 + (pack21 ? (21LL * e_cap + 7) / 8 + 3 : 3LL * e_cap);
  ser_entries_kernel<<<blocks_for(len), THREADS, 0, cu_stream>>>(
      (uint8_t*)out, len, stream, e_cap, pack21, totals);
  return (int)cudaGetLastError();
}
