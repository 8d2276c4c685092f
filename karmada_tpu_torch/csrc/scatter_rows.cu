// K6 scatter_rows: the dirty-row upsert of the fleet's resident state.
//
// Replaces karmada_tpu/scheduler/fleet.py:1120 _scatter_rows — for each of
// the table's state arrays (fleet.py:1113 _STATE_FIELDS: cp_idx, gvk_idx,
// prof_idx, replicas, strategy, fresh, prev_sites, prev_counts),
// state[rows] = vals — in ONE launch and in place, and, as a second entry
// point, fleet.py:828 _gather_meta: the 2-byte wire of res_meta[rows]
// (rows -1 give 0), the changed-meta fallback when phase A's meta buffer
// overflows.
//
// What bounds it on an H100: bytes — each dirty row moves its 281 bytes of
// state (4 x 5 + 1 + 2 x 128) once in and once out, a few hundred KB for a
// few hundred dirty rows, far below a microsecond of bandwidth; at that
// size the launch itself is the cost. The design: one block per dirty row
// copies the row of every field as bytes (the fields' row widths come in
// as one struct by value), so a pass needs one launch however many fields
// changed. The host pads the dirty rows to a power of two by repeating the
// first row; the repeated writes carry identical bytes, so their order
// does not matter. Rows outside [0, cap) are dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_FIELDS = 8;
constexpr int THREADS = 128;

struct Fields {
  uint8_t* dst[MAX_FIELDS];
  const uint8_t* src[MAX_FIELDS];
  int width[MAX_FIELDS];  // bytes per row
  int n;
};

__global__ void scatter_rows_kernel(Fields f, const int64_t* __restrict__ rows,
                                    long long cap) {
  const int i = blockIdx.x;
  const long long r = rows[i];
  if (r < 0 || r >= cap) return;
  for (int k = 0; k < f.n; ++k) {
    const int w = f.width[k];
    uint8_t* d = f.dst[k] + r * w;
    const uint8_t* s = f.src[k] + (long long)i * w;
    for (int b = threadIdx.x; b < w; b += THREADS) d[b] = s[b];
  }
}

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

}  // namespace

extern "C" int scatter_rows_launch(void* const* dst, void* const* src,
                                   const int* width, int n_fields,
                                   const int64_t* rows, int k, int cap,
                                   cudaStream_t stream) {
  if (n_fields < 1 || n_fields > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  Fields f;
  f.n = n_fields;
  for (int i = 0; i < MAX_FIELDS; ++i) {
    f.dst[i] = i < n_fields ? (uint8_t*)dst[i] : nullptr;
    f.src[i] = i < n_fields ? (const uint8_t*)src[i] : nullptr;
    f.width[i] = i < n_fields ? width[i] : 0;
  }
  scatter_rows_kernel<<<k, THREADS, 0, stream>>>(f, rows, cap);
  return (int)cudaGetLastError();
}

extern "C" int gather_meta_launch(const int32_t* res_meta, int cap,
                                  const int32_t* rows, int m_n, uint8_t* out,
                                  cudaStream_t stream) {
  (void)cap;
  if (m_n == 0) return 0;
  gather_meta_kernel<<<(m_n + 255) / 256, 256, 0, stream>>>(res_meta, rows,
                                                            m_n, out);
  return (int)cudaGetLastError();
}
