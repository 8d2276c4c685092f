// K5 fleet_wire: single-pass ordered capped compactions with the wire
// serialisers fused.
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
//     the site does not fit 16 bits. With m metas (fleet.py:380-420,
//     _fleet_solve's wire) the metas go between the total and the
//     entries: 2 little-endian bytes each, or int32 words.
// Each compaction is the JAX cumsum-and-scatter: total counts every
// flagged item, out[k] for k < cap is the k-th flagged value in input
// order, and the slots past the total keep their fill (0, or -1 for the
// row buffer).
//
// What bounds it on an H100: bytes, and, at these sizes, the latency of
// each tile's chain of steps. A config-5 pass reads 100 KB of changed
// flags, 12 B of each changed row and 256 B of each changed row with
// dcount <= 62 (none on a steady pass, 14 MB on a churn pass); an entry
// wire reads 33-56 MB of entry words. The parent chained three kernels
// per compaction and a serialiser (11 device operations for phase A);
// this is one memset of the look-back state and one launch:
//   * A block a tile, claimed from an atomic tile counter, so tiles are
//     claimed in order and nothing depends on the order in which the
//     card schedules blocks. A tile is read once (8192 entry words, eight
//     16-B loads a thread, all in flight at once; one row a thread) and
//     its flags ranked with warp ballots, __popc and block scans.
//   * Decoupled look-back (Merrill & Garland, 2016): the tile publishes
//     its aggregate, then its inclusive prefix, in one 64-bit status word
//     (2 flag bits, the payload in the other 62); warp 0 walks its
//     predecessors' words 32 at a time.
//   * Each item is written straight into its wire bytes; the tile's rows
//     write their own bitmask bytes (a tile of 256 rows owns 32 whole
//     bytes). Items ranked at or past the cap are counted, not written.
//   * The phase-A delta stream goes by rows, not words: only rows that
//     are changed with dcount <= 62 read their d_slots words (a warp a
//     row, four rows in flight), whose nonzero words wait in shared
//     memory, 3 bytes each (48 KB a tile at most: four blocks an SM),
//     until the tile's prefix is known. The rank keeps row order, then
//     word order; a steady pass reads no delta word.
//   * pack21 is a separable stage of the write (pack21_bytes): a tile's
//     items [p0, p1) own the bytes from the one holding bit 21 p0 up to,
//     not including, the one holding bit 21 p1; the first of them also
//     draws on item p0 - 1, the last flagged value before the tile, which
//     the status word carries beside the count (the nearest predecessor
//     with a nonzero count supplies it). So every byte is written once,
//     by one tile, as _pack21 computes it (values below 2^21, its
//     domain; the aligned middle in 4-B stores).
//   * A block's claim past the last tile makes it a fill worker: one of
//     its threads waits for the last tile's inclusive prefix, and the
//     block writes its share of what
//     lies past the totals: the zeros after the streams, the -1 of the
//     row buffer, the 21-bit stream's last byte and the decoder's 3 pad
//     bytes. The last tile writes the totals. In-place metas are written
//     by the tiles, a share each.
// A spin on a status word that never arrives traps after ~2^24 polls
// (seconds), so a fault surfaces as a launch error, not a hang.
//
// -DFLEET_CUT=1 (k2_variants.py --fleet) ends every tile once it has
// published its inclusive prefix and skips the fill: the loads, ranking
// and look-back without the writes.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef FLEET_CUT
#define FLEET_CUT 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_TILE = THREADS;  // rows a phase-A tile (fleet_kernels.WIRE_ROW_TILE)
constexpr int VEC = 4;             // int32 words a 16-B load
constexpr int LOADS = 8;           // 16-B loads a thread
constexpr int CHUNK = THREADS * VEC;
constexpr int ENTRY_TILE = CHUNK * LOADS;  // 8192 (fleet_kernels.WIRE_ENTRY_TILE)
constexpr int PACKS = LOADS / 4;           // 64-bit scan words: 4 chunk counts each
static_assert(LOADS % 4 == 0, "chunk counts pack 4 to a scan word");
constexpr int MAX_D_SLOTS = 64;

typedef unsigned long long u64;
constexpr u64 FLAG_AGG = 1ull << 62;
constexpr u64 FLAG_INC = 2ull << 62;
constexpr u64 FLAG_MASK = 3ull << 62;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ u64 ld_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// polls a status word until it holds an aggregate or, with `inclusive`,
// an inclusive prefix (a deadlock guard traps)
__device__ __forceinline__ u64 wait_status(const u64* p, bool inclusive = false) {
  const u64 need = inclusive ? FLAG_INC : FLAG_AGG;
  u64 s = ld_status(p);
  for (unsigned spins = 0; (s & FLAG_MASK) < need; ++spins) {
    if (spins > (1u << 24)) __trap();
    __nanosleep(64);
    s = ld_status(p);
  }
  return s;
}

// A fill worker's wait for the last tile's inclusive prefix: one thread
// polls, the block reads it from shared memory.
__device__ __forceinline__ u64 wait_total(const u64* p, u64* s_bcast) {
  if (threadIdx.x == 0) *s_bcast = wait_status(p, true) & ~FLAG_MASK;
  __syncthreads();
  return *s_bcast;
}

// phase-A payload: changed rows << 38 | contributing delta words
struct RowOp {
  static constexpr int SHIFT = 38;
  static __device__ __forceinline__ u64 combine(u64 earlier, u64 later) {
    return earlier + later;
  }
};

// entry payload: count << 31 | the last flagged value (0 with no count)
struct EntryOp {
  static constexpr u64 LAST = (1ull << 31) - 1;
  static __device__ __forceinline__ u64 combine(u64 earlier, u64 later) {
    const u64 cl = later >> 31;
    return ((earlier >> 31) + cl) << 31 | (cl ? (later & LAST) : (earlier & LAST));
  }
};

// Warp 0: the combined payload of tiles [0, t), from the status words of
// its predecessors, 32 at a time, nearest first.
template <class Op>
__device__ u64 look_back(const u64* status, long long t) {
  const int lane = threadIdx.x & 31;
  u64 acc = 0;
  for (long long base = t - 1; base >= 0; base -= 32) {
    const long long idx = base - lane;
    const u64 s = idx >= 0 ? wait_status(status + idx) : FLAG_INC;
    const unsigned inc = __ballot_sync(FULL, (s & FLAG_MASK) == FLAG_INC);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    // lane k holds tile base - k: a higher lane is an earlier tile
    u64 v = lane <= stop ? (s & ~FLAG_MASK) : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const u64 o = __shfl_down_sync(FULL, v, d);
      if (lane + d < 32) v = Op::combine(o, v);
    }
    acc = Op::combine(__shfl_sync(FULL, v, 0), acc);
    if (inc) break;
  }
  return acc;
}

// Publish the tile's aggregate, look back, publish its inclusive prefix;
// every thread gets the exclusive prefix. Call with every thread.
template <class Op>
__device__ u64 tile_prefix(u64* status, long long t, u64 agg, u64* s_bcast) {
  if (threadIdx.x == 0) st_status(status + t, (t == 0 ? FLAG_INC : FLAG_AGG) | agg);
  if (t > 0 && threadIdx.x < 32) {
    const u64 ex = look_back<Op>(status, t);
    if (threadIdx.x == 0) {
      st_status(status + t, FLAG_INC | Op::combine(ex, agg));
      *s_bcast = ex;
    }
  } else if (threadIdx.x == 0) {
    *s_bcast = 0;
  }
  __syncthreads();
  return *s_bcast;
}

__device__ __forceinline__ long long claim_tile(u64* counter, long long* s_tile) {
  if (threadIdx.x == 0) *s_tile = (long long)atomicAdd(counter, 1ull);
  __syncthreads();
  return *s_tile;
}

// Block-wide exclusive sum of v (every thread), and the block total.
__device__ __forceinline__ u64 block_scan(u64 v, u64* s_warp, u64* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  u64 x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const u64 y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[wid] = x;
  __syncthreads();
  u64 before = 0, all = 0;
  for (int k = 0; k < WARPS; ++k) {
    const u64 w = s_warp[k];
    before += k < wid ? w : 0;
    all += w;
  }
  *total = all;
  __syncthreads();  // s_warp may be reused
  return before + x - v;
}

__device__ __forceinline__ void le32_bytes(uint8_t* p, int32_t v) {
  for (int k = 0; k < 4; ++k) p[k] = (uint8_t)((v >> (8 * k)) & 0xFF);
}

// bytes [lo, hi) of p take `val`, split over `workers` threads: byte
// stores up to a 16-B boundary, then 16-B stores, then the rest
__device__ void fill_bytes(uint8_t* p, long long lo, long long hi, uint8_t val,
                           long long worker, long long workers) {
  if (hi <= lo) return;
  const long long mis = (long long)(reinterpret_cast<uintptr_t>(p + lo) & 15);
  const long long head = mis ? (16 - mis < hi - lo ? 16 - mis : hi - lo) : 0;
  for (long long i = worker; i < head; i += workers) p[lo + i] = val;
  const long long mid = lo + head;
  const long long n16 = (hi - mid) / 16;
  const unsigned w = 0x01010101u * val;
  const uint4 w4 = make_uint4(w, w, w, w);
  uint4* q = reinterpret_cast<uint4*>(p + mid);
  for (long long i = worker; i < n16; i += workers) q[i] = w4;
  for (long long i = mid + 16 * n16 + worker; i < hi; i += workers) p[i] = val;
}

// --------------------------------------------------------------------------
// phase A: rows -> total | bitmask | metas | dtotal | deltas, and rowbuf
// --------------------------------------------------------------------------

struct PassArgs {
  const uint8_t* changed;
  const int32_t* meta;
  const int32_t* dcount;
  const int32_t* rows;
  const int32_t* deltas;
  int n, d_slots, m_cap, d_cap;
  uint8_t* flat;
  int32_t* rowbuf;
  long long n_tiles;
  u64* counter;
  u64* status;  // a word a tile
};

__device__ void pass_fill(const PassArgs& a, long long f, long long n_fill, u64* s_bcast) {
  const u64 s = wait_total(a.status + a.n_tiles - 1, s_bcast);
  const long long total = (long long)(s >> RowOp::SHIFT);
  const long long dtotal = (long long)(s & ((1ull << RowOp::SHIFT) - 1));
  const long long wm = total < a.m_cap ? total : a.m_cap;
  const long long wd = dtotal < a.d_cap ? dtotal : a.d_cap;
  const long long meta_off = 4 + a.n / 8;
  const long long d_off = meta_off + 2LL * a.m_cap + 4;
  const long long worker = f * THREADS + threadIdx.x, workers = n_fill * THREADS;
  fill_bytes(a.flat, meta_off + 2 * wm, meta_off + 2LL * a.m_cap, 0, worker, workers);
  fill_bytes(reinterpret_cast<uint8_t*>(a.rowbuf), 4 * wm, 4LL * a.m_cap, 0xFF,
             worker, workers);
  if (a.d_cap) fill_bytes(a.flat, d_off + 3 * wd, d_off + 3LL * a.d_cap, 0, worker, workers);
}

// a phase-A tile's shared state (the staged delta words are dynamic)
struct PassShared {
  u64 warp[WARPS], bcast;
  long long claim;
  int wch[WARPS], wct[WARPS];
  int list[ROW_TILE], cnt[ROW_TILE], doff[ROW_TILE];
};

// one row of a tile, as its thread holds it
struct RowIn {
  int32_t meta, dcount, row;
  uint8_t ch;
};

__device__ __forceinline__ RowIn load_row(const PassArgs& a, long long t) {
  const long long i = t * ROW_TILE + threadIdx.x;
  RowIn r{0, 0, 0, 0};
  if (t < a.n_tiles && i < a.n) {
    r.ch = a.changed[i];
    r.meta = a.meta[i];
    r.dcount = a.dcount[i];
    r.row = a.rows[i];
  }
  return r;
}

// s_d: [ROW_TILE][d_slots] x 3 B, each contributing row's nonzero delta
// words compacted (their low 24 bits: what the wire keeps)
__device__ __forceinline__ void pass_tile(const PassArgs& a, long long t, const RowIn& r,
                                          PassShared& sm, uint8_t* s_d) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const bool ch = r.ch != 0;
  const bool contrib = ch && a.d_cap > 0 && r.dcount <= 62;
  const int32_t wm = r.meta | ((r.dcount < 63 ? r.dcount : 63) << 10);
  const unsigned b_ch = __ballot_sync(FULL, ch), b_ct = __ballot_sync(FULL, contrib);
  // the warp's 32 rows own 4 bitmask bytes
  const long long row0 = t * ROW_TILE + 32 * wid;
  if (lane < 4 && !FLEET_CUT && row0 + 8 * lane < a.n)
    a.flat[4 + row0 / 8 + lane] = (uint8_t)(b_ch >> (8 * lane));
  if (lane == 0) {
    sm.wch[wid] = __popc(b_ch);
    sm.wct[wid] = __popc(b_ct);
  }
  __syncthreads();
  int ch_before = 0, ct_before = 0, n_ch = 0, n_ct = 0;
  for (int k = 0; k < WARPS; ++k) {
    ch_before += k < wid ? sm.wch[k] : 0;
    ct_before += k < wid ? sm.wct[k] : 0;
    n_ch += sm.wch[k];
    n_ct += sm.wct[k];
  }
  const unsigned lt = (1u << lane) - 1;
  const int ch_rank = ch_before + __popc(b_ch & lt);
  if (contrib) sm.list[ct_before + __popc(b_ct & lt)] = threadIdx.x;
  __syncthreads();

  // the contributing rows' delta words: a warp a row, four rows in flight
  const int ds = a.d_slots;
  for (int li0 = wid; li0 < n_ct; li0 += 4 * WARPS) {
    int32_t x[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int li = li0 + u * WARPS;
      x[u][0] = x[u][1] = 0;
      if (li < n_ct) {
        const int32_t* src = a.deltas + (t * ROW_TILE + sm.list[li]) * (long long)ds;
        if (lane < ds) x[u][0] = src[lane];
        if (lane + 32 < ds) x[u][1] = src[lane + 32];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int li = li0 + u * WARPS;
      if (li >= n_ct) break;  // warp-uniform
      const unsigned b0 = __ballot_sync(FULL, x[u][0] != 0);
      const unsigned b1 = __ballot_sync(FULL, x[u][1] != 0);
      uint8_t* dst = s_d + 3 * li * ds;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!x[u][h]) continue;
        uint8_t* o = dst + 3 * (h ? __popc(b0) + __popc(b1 & lt) : __popc(b0 & lt));
        o[0] = (uint8_t)(x[u][h] & 0xFF);
        o[1] = (uint8_t)((x[u][h] >> 8) & 0xFF);
        o[2] = (uint8_t)((x[u][h] >> 16) & 0xFF);
      }
      if (lane == 0) sm.cnt[li] = __popc(b0) + __popc(b1);
    }
  }
  __syncthreads();
  u64 n_delta;
  const u64 doff = block_scan(threadIdx.x < n_ct ? (u64)sm.cnt[threadIdx.x] : 0, sm.warp,
                              &n_delta);
  if (threadIdx.x < n_ct) sm.doff[threadIdx.x] = (int)doff;

  const u64 agg = ((u64)n_ch << RowOp::SHIFT) | n_delta;
  const u64 ex = tile_prefix<RowOp>(a.status, t, agg, &sm.bcast);  // syncs sm.doff too
  if (FLEET_CUT) return;
  const long long ex_rows = (long long)(ex >> RowOp::SHIFT);
  const long long ex_d = (long long)(ex & ((1ull << RowOp::SHIFT) - 1));
  const long long meta_off = 4 + a.n / 8;
  const long long dtot_off = meta_off + 2LL * a.m_cap;
  if (ch) {
    const long long pos = ex_rows + ch_rank;
    if (pos < a.m_cap) {
      a.flat[meta_off + 2 * pos] = (uint8_t)(wm & 0xFF);
      a.flat[meta_off + 2 * pos + 1] = (uint8_t)((wm >> 8) & 0xFF);
      a.rowbuf[pos] = r.row > 0 ? r.row : 0;
    }
  }
  for (int li = wid; li < n_ct; li += WARPS) {
    const int c = sm.cnt[li];
    const long long p0 = ex_d + sm.doff[li];
    const uint8_t* src = s_d + 3 * li * ds;
    for (int k = lane; k < c && p0 + k < a.d_cap; k += 32) {
      uint8_t* o = a.flat + dtot_off + 4 + 3 * (p0 + k);
      o[0] = src[3 * k];
      o[1] = src[3 * k + 1];
      o[2] = src[3 * k + 2];
    }
  }
  if (t == a.n_tiles - 1 && threadIdx.x == 0) {
    le32_bytes(a.flat, (int32_t)(ex_rows + n_ch));
    if (a.d_cap) le32_bytes(a.flat + dtot_off, (int32_t)(ex_d + (long long)n_delta));
  }
}

// A block a tile; a claim past the last tile makes the block a fill
// worker.
__global__ void __launch_bounds__(THREADS) pass_wire_kernel(PassArgs a) {
  extern __shared__ uint8_t s_d[];
  __shared__ PassShared sm;
  const long long t = claim_tile(a.counter, &sm.claim);
  if (t >= a.n_tiles) {
    if (!FLEET_CUT) pass_fill(a, t - a.n_tiles, gridDim.x - a.n_tiles, &sm.bcast);
    return;
  }
  pass_tile(a, t, load_row(a, t), sm, s_d);
}

// --------------------------------------------------------------------------
// entries -> total | [metas] | stream (int32, 3 B an entry, or 21 bits)
// --------------------------------------------------------------------------

enum Form { INT32 = 0, BYTES3 = 1, PACK21 = 2 };

struct EntryArgs {
  const int32_t* e;
  long long n;
  int e_cap, form;
  const int32_t* meta;  // m metas between the total and the stream, or none
  int m;
  uint8_t* out;
  long long body;  // byte offset of the stream
  long long n_tiles;
  u64* counter;
  u64* status;  // a word a tile
};

// The 21-bit stage: bytes [21 p0 / 8, 21 p1 / 8) of the body, the tile's
// items [p0, p1) staged in s_val and `prev` the item p0 - 1 (the first
// byte may hold the end of item p0 - 1); with `capped`, also the byte
// that holds the end of item p1 - 1 = e_cap - 1. Values are below 2^21
// (_pack21's domain: sites below 2^13), so 32 bits of the stream are
// three fields shifted into one 64-bit word; the aligned middle goes out
// in 4-B stores.
__device__ void pack21_bytes(uint8_t* body, long long p0, long long p1, bool capped,
                             const int32_t* s_val, uint32_t prev) {
  const auto field = [&](long long k) -> u64 {
    return k < p0 ? prev : (k < p1 ? (uint32_t)s_val[k - p0] : 0u);
  };
  const auto bits32 = [&](long long q) -> uint32_t {  // stream bits [8q, 8q + 32)
    const int rel = (int)(8 * q - 21 * (p0 - 1));     // small: a 32-bit division
    const int k = rel / 21;
    const int off = rel - 21 * k;
    const long long f = p0 - 1 + k;  // the field holding bit 8q
    return (uint32_t)(field(f) >> off | field(f + 1) << (21 - off) |
                      field(f + 2) << (42 - off));
  };
  const long long qa = (21 * p0) >> 3, qb = (21 * p1) >> 3;
  const long long mis = (long long)(reinterpret_cast<uintptr_t>(body + qa) & 3);
  const long long w0 = qa + (mis ? 4 - mis : 0) < qb ? qa + (mis ? 4 - mis : 0) : qb;
  const long long nw = (qb - w0) >> 2, w1 = w0 + 4 * nw;
  for (long long q = qa + threadIdx.x; q < w0; q += THREADS) body[q] = (uint8_t)bits32(q);
  for (long long i = threadIdx.x; i < nw; i += THREADS)
    *reinterpret_cast<uint32_t*>(body + w0 + 4 * i) = bits32(w0 + 4 * i);
  for (long long q = w1 + threadIdx.x; q < qb; q += THREADS) body[q] = (uint8_t)bits32(q);
  if (capped && ((21 * p1) & 7) && threadIdx.x == 0) body[qb] = (uint8_t)bits32(qb);
}

__device__ void entry_fill(const EntryArgs& a, long long f, long long n_fill, u64* s_bcast) {
  const u64 s = wait_total(a.status + a.n_tiles - 1, s_bcast);
  const long long total = (long long)(s >> 31);
  const uint32_t last = (uint32_t)(s & EntryOp::LAST);
  const long long w = total < a.e_cap ? total : a.e_cap;
  const long long worker = f * THREADS + threadIdx.x, workers = n_fill * THREADS;
  if (a.form == INT32) {
    fill_bytes(a.out, a.body + 4 * w, a.body + 4LL * a.e_cap, 0, worker, workers);
  } else if (a.form == BYTES3) {
    fill_bytes(a.out, a.body + 3 * w, a.body + 3LL * a.e_cap, 0, worker, workers);
  } else {
    const long long nb = (21LL * a.e_cap + 7) >> 3;
    long long lo = nb;  // capped: the capping tile wrote every byte below nb
    if (total < a.e_cap) {
      lo = (21 * w) >> 3;
      if ((21 * w) & 7) {  // w > 0: the byte holding the end of item w - 1
        if (worker == 0) {
          const int off = (int)(8 * lo - 21 * (w - 1));
          a.out[a.body + lo] = (uint8_t)((last >> off) & 0xFF);
        }
        ++lo;
      }
    }
    fill_bytes(a.out, a.body + lo, a.body + nb + 3, 0, worker, workers);
  }
}

struct EntryShared {
  int32_t val[ENTRY_TILE];
  u64 warp[WARPS], bcast;
  long long claim;
  int32_t last;
};

// the tile's words: LOADS chunks of CHUNK words, VEC consecutive words a
// thread (16-B loads when the input is 16-B aligned); zeros past n
__device__ __forceinline__ void load_tile(const EntryArgs& a, long long t,
                                          int32_t (&v)[LOADS][VEC]) {
  const bool vec = (reinterpret_cast<uintptr_t>(a.e) & 15) == 0;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const long long idx = t * ENTRY_TILE + (long long)j * CHUNK + VEC * threadIdx.x;
    if (t < a.n_tiles && vec && idx + VEC <= a.n) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(a.e + idx));
      v[j][0] = x.x, v[j][1] = x.y, v[j][2] = x.z, v[j][3] = x.w;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        v[j][k] = t < a.n_tiles && idx + k < a.n ? a.e[idx + k] : 0;
    }
  }
}

__device__ __forceinline__ void entry_tile(const EntryArgs& a, long long t,
                                           const int32_t (&v)[LOADS][VEC], EntryShared& sm) {
  // this tile's share of the in-place metas
  if (a.m && !FLEET_CUT) {
    const long long per = (a.m + a.n_tiles - 1) / a.n_tiles;
    const long long r1 = (t + 1) * per < a.m ? (t + 1) * per : a.m;
    for (long long r = t * per + threadIdx.x; r < r1; r += THREADS) {
      const int32_t x = a.meta[r];
      if (a.form == INT32) {
        reinterpret_cast<int32_t*>(a.out)[1 + r] = x;
      } else {
        a.out[4 + 2 * r] = (uint8_t)(x & 0xFF);
        a.out[5 + 2 * r] = (uint8_t)((x >> 8) & 0xFF);
      }
    }
  }
  // the chunks' counts ride 64-bit scans, 16 bits a chunk (a chunk holds
  // at most CHUNK = 1024 flags)
  u64 packed[PACKS] = {};
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) c += v[j][k] > 0;
    packed[j / 4] |= (u64)c << (16 * (j % 4));
  }
  u64 ex_in[PACKS], tot[PACKS];
#pragma unroll
  for (int w = 0; w < PACKS; ++w) ex_in[w] = block_scan(packed[w], sm.warp, &tot[w]);
  int rank[LOADS];
  int chunk_off = 0;
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    rank[j] = chunk_off + (int)((ex_in[j / 4] >> (16 * (j % 4))) & 0xFFFF);
    chunk_off += (int)((tot[j / 4] >> (16 * (j % 4))) & 0xFFFF);
  }
  const int cnt = chunk_off;
  // stage the flagged values in rank order; the last one rides the status
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    int r = rank[j];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (v[j][k] > 0) {
        sm.val[r] = v[j][k];
        if (r == cnt - 1) sm.last = v[j][k];
        ++r;
      }
    }
  }
  __syncthreads();
  const u64 agg = ((u64)cnt << 31) | (cnt ? (u64)(uint32_t)sm.last : 0);
  const u64 ex = tile_prefix<EntryOp>(a.status, t, agg, &sm.bcast);
  if (FLEET_CUT) return;
  const long long p0 = (long long)(ex >> 31);
  const long long p1 = p0 + cnt < a.e_cap ? p0 + cnt : a.e_cap;
  if (a.form == PACK21) {
    if (p0 < a.e_cap)
      pack21_bytes(a.out + a.body, p0, p1, p0 + cnt >= a.e_cap, sm.val,
                   (uint32_t)(ex & EntryOp::LAST));
  } else {
    for (long long p = p0 + threadIdx.x; p < p1; p += THREADS) {
      const int32_t x = sm.val[p - p0];
      if (a.form == INT32) {
        reinterpret_cast<int32_t*>(a.out + a.body)[p] = x;
      } else {
        uint8_t* o = a.out + a.body + 3 * p;
        o[0] = (uint8_t)(x & 0xFF);
        o[1] = (uint8_t)((x >> 8) & 0xFF);
        o[2] = (uint8_t)((x >> 16) & 0xFF);
      }
    }
  }
  if (t == a.n_tiles - 1 && threadIdx.x == 0) {
    const int32_t total = (int32_t)(p0 + cnt);
    if (a.form == INT32) reinterpret_cast<int32_t*>(a.out)[0] = total;
    else le32_bytes(a.out, total);
  }
}

// A block a tile, as pass_wire_kernel.
__global__ void __launch_bounds__(THREADS) entry_wire_kernel(EntryArgs a) {
  __shared__ EntryShared sm;
  const long long t = claim_tile(a.counter, &sm.claim);
  if (t >= a.n_tiles) {
    if (!FLEET_CUT) entry_fill(a, t - a.n_tiles, gridDim.x - a.n_tiles, &sm.bcast);
    return;
  }
  int32_t v[LOADS][VEC];
  load_tile(a, t, v);
  entry_tile(a, t, v, sm);
}

}  // namespace

// scratch: u64[1 + ceil(n / ROW_TILE)] (the tile counter, a status word a
// tile), zeroed here; fill_blocks blocks beyond a block a tile write what
// lies past the totals.
// n < 2^24 rows, d_slots <= 64.
extern "C" int fleet_wire_launch(const uint8_t* changed, const int32_t* meta,
                                 const int32_t* dcount, const int32_t* rows,
                                 const int32_t* deltas, int n, int d_slots, int m_cap,
                                 int d_cap, uint8_t* flat, int32_t* rowbuf, void* scratch,
                                 int fill_blocks, cudaStream_t stream) {
  if (d_slots > MAX_D_SLOTS || n < 0 || fill_blocks < 1) return (int)cudaErrorInvalidValue;
  const long long n_tiles = n > 0 ? (n + ROW_TILE - 1) / ROW_TILE : 1;
  u64* words = static_cast<u64*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, (size_t)(1 + n_tiles) * sizeof(u64), stream);
  if (err) return (int)err;
  // the staged delta words: 48 KB at most, past the default limit with
  // the static shared memory beside them
  const size_t smem = d_cap ? (size_t)ROW_TILE * d_slots * 3 : 0;
  if (smem && (err = cudaFuncSetAttribute(pass_wire_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem)))
    return (int)err;
  PassArgs a{changed, meta, dcount, rows, deltas, n, d_slots, m_cap, d_cap,
             flat, rowbuf, n_tiles, words, words + 1};
  pass_wire_kernel<<<(unsigned)(n_tiles + fill_blocks), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// form 0: out is int32[1 + m + e_cap] = [total, metas, stream]; form 1 / 2:
// out is uint8: 4 B total | m x 2 B metas | 3 B an entry (1), or the
// 21-bit stream plus 3 pad bytes (2). scratch: u64[1 + ceil(n / 8192)],
// zeroed here; fill_blocks as fleet_wire_launch's. n < 2^31.
extern "C" int entry_wire_launch(const int32_t* entries, long long n, int e_cap, int form,
                                 const int32_t* meta, int m, void* out, void* scratch,
                                 int fill_blocks, cudaStream_t stream) {
  if (n < 0 || n >= (1LL << 31) || form < 0 || form > 2 || fill_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = n > 0 ? (n + ENTRY_TILE - 1) / ENTRY_TILE : 1;
  u64* words = static_cast<u64*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, (size_t)(1 + n_tiles) * sizeof(u64), stream);
  if (err) return (int)err;
  const long long body = form == INT32 ? 4LL * (1 + m) : 4 + 2LL * m;
  EntryArgs a{entries, n, e_cap, form, meta, m, static_cast<uint8_t*>(out), body,
              n_tiles, words, words + 1};
  entry_wire_kernel<<<(unsigned)(n_tiles + fill_blocks), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
