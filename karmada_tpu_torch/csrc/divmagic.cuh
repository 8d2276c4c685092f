// Shared device code of K8 (node_sum.cu), K13 (quota_caps.cu) and K1
// (estimate_merge.cu): exact 64-bit floor division by a divisor that stays
// fixed over many dividends, with no division instruction per dividend.
//
// Granlund and Montgomery 1994, Thm 4.2 with N = 63: for a divisor d in
// [1, 2^63 - 1], l = ceil(log2 d) and m = ceil(2^(63+l) / d), which lies in
// [2^63, 2^64) (a 128 / 64-bit division, Hacker's Delight divlu). Then
// floor(a / d) = floor(m a / 2^(63+l)) for every 0 <= a < 2^63, and with the
// dividend staged doubled (2a < 2^64) that is umulhi(m, 2a) >> l, exact over
// the whole ranges (a in [0, 2^63 - 1], d in [1, 2^63 - 1]; d = 1 is l = 0,
// m = 2^63). A division then costs one high product and a shift.
//
// Signed dividends (floor_staged): JAX's '//' floors. For a < 0, ~a = -a - 1
// lies in [0, 2^63 - 1] (INT64_MIN included) and floor(a / d) = -1 -
// floor(~a / d) = ~floor(~a / d). So a dividend is staged as x = a ^ s
// doubled, with s = a >> 63 (all ones for a negative a), and the quotient is
// (umulhi(m, 2x) >> l) ^ s. A caller may stage x = 0 with any s to answer s
// itself, whatever the divisor.

#pragma once

#include <cstdint>

// floor((hi * 2^64 + lo) / d) for hi < d (libdivide's
// libdivide_128_div_64_to_64, after Hacker's Delight divlu): base-2^32
// long division with the normalised divisor, each digit estimated from the
// divisor's top digit and corrected at most twice.
static __device__ unsigned long long div128by64(unsigned long long hi, unsigned long long lo,
                                                unsigned long long d) {
  const unsigned long long b = 1ULL << 32;
  const int shift = __clzll((long long)d);
  d <<= shift;
  hi <<= shift;
  hi |= shift ? (lo >> (64 - shift)) : 0ULL;
  lo <<= shift;
  const unsigned long long num1 = lo >> 32, num0 = lo & 0xFFFFFFFFULL;
  const unsigned long long den1 = d >> 32, den0 = d & 0xFFFFFFFFULL;
  unsigned long long qhat = hi / den1;
  unsigned long long rhat = hi - qhat * den1;
  unsigned long long c1 = qhat * den0;
  unsigned long long c2 = rhat * b + num1;
  if (c1 > c2) qhat -= (c1 - c2 > d) ? 2 : 1;
  const unsigned long long q1 = qhat & 0xFFFFFFFFULL;
  const unsigned long long rem = hi * b + num1 - q1 * d;
  qhat = rem / den1;
  rhat = rem - qhat * den1;
  c1 = qhat * den0;
  c2 = rhat * b + num0;
  if (c1 > c2) qhat -= (c1 - c2 > d) ? 2 : 1;
  return (q1 << 32) | (qhat & 0xFFFFFFFFULL);
}

// the multiplier and shift of divisor d in [1, 2^63 - 1]: floor(a / d) ==
// umulhi(m, 2a) >> l for 0 <= a < 2^63
static __device__ void magic(unsigned long long d, unsigned long long& m, int& l) {
  if (d == 1) {
    m = 1ULL << 63;
    l = 0;
    return;
  }
  l = 64 - __clzll((long long)(d - 1));  // ceil(log2 d), 1..63
  // ceil(2^(63+l) / d) = floor((2^(63+l) - 1) / d) + 1; 2^(63+l) - 1 has
  // the high word 2^(l-1) - 1 < d and the low word 2^64 - 1
  m = div128by64((1ULL << (l - 1)) - 1, ~0ULL, d) + 1;
}

// floor(a / d) for a staged non-negative dividend x2 = 2a (a < 2^63)
__device__ __forceinline__ unsigned long long floor_doubled(unsigned long long m, int l,
                                                           unsigned long long x2) {
  return __umul64hi(m, x2) >> l;
}

// a signed dividend staged for floor_staged: x2 = 2 (a ^ s), s = a >> 63
__device__ __forceinline__ void stage_signed(long long a, unsigned long long& x2,
                                             unsigned long long& s) {
  s = (unsigned long long)(a >> 63);
  x2 = ((unsigned long long)a ^ s) << 1;
}

// floor(a / d), signed, for a dividend staged by stage_signed
__device__ __forceinline__ long long floor_staged(unsigned long long m, int l,
                                                  unsigned long long x2, unsigned long long s) {
  return (long long)((__umul64hi(m, x2) >> l) ^ s);
}
