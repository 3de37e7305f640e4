// The RaBitQ row scorer of rabitq_search_step (#3, rabitq_search_step.cu)
// and rabitq_gather_distance (#5, rabitq_distance.cu): both kernels stage a
// query's code rows and score them with these functions, so on the same
// row and query they round alike, bit for bit.
//
// A row is `units` units: 32-bit words when its width is a multiple of 4
// bytes (WORDS), bytes otherwise; unit u holds CPU codes, little-endian
// (code j at bits [j*BITS, (j+1)*BITS), in a byte and so in a
// little-endian word), code j times q[u * CPU + j]. The lanes of a group
// of G (the least power of two >= units, at most 32) take units g, g + 32,
// ..., one FMA after another, and reduce by xor shuffles G/2 .. 1. That is
// the order of a whole warp a row (lane l takes units l, l + 32, ..., then
// xor shuffles 16 .. 1), the order #5 scored in before this scorer: there
// the lanes past `units` hold exact zeros (+0: an FMA from +0 never gives
// -0), so the offsets above G/2 add nothing. A code becomes a
// float exactly without a conversion instruction (a byte permute under
// 2^23's exponent, less 2^23), and a lane runs eight rows' FMA chains at
// once to hide their latency. A row of at most 32 units takes the lane's
// query codes from registers (qr: unit g's codes); wider rows read the
// query transposed from shared memory (code j of unit u at qt[j * units +
// u]).

#pragma once

#include "common.cuh"

namespace jasper {

__host__ __device__ inline int pow2_at_least(int n) {
  int g = 1;
  while (g < n) g <<= 1;
  return g;
}

// Rows a lane scores at once in score_rows: independent FMA chains (fewer
// at 2 and 1 bits, whose 16 or 32 codes a unit take more registers).
template <int BITS>
inline constexpr int kScoreChains = BITS >= 4 ? 8 : 2 * BITS;

// code j of a 32-bit unit as a float, exactly: its bits under 2^23's
// exponent, less 2^23. At 4 bits the unit's low and high nibbles are split
// once (lo, hi: a code a byte), and a byte permute puts code j under the
// exponent.
template <int BITS>
__device__ __forceinline__ float code_of(uint32_t x, uint32_t lo, uint32_t hi, int j) {
  if constexpr (BITS == 4)
    return __uint_as_float(__byte_perm(j & 1 ? hi : lo, 0x4b000000u, 0x7440 | (j >> 1))) -
           8388608.f;
  else
    return __uint_as_float(((x >> (j * BITS)) & ((1u << BITS) - 1u)) | 0x4b000000u) -
           8388608.f;
}

// Per-lane partial dot of a staged row over this lane's units g, g + 32,
// ...: unit u holds CPU codes (a 32-bit word, or a byte), code j times
// q[u * CPU + j], one FMA after another. qt is the
// query transposed (qt[j * units + u]); qr holds unit g's codes when a row
// has at most 32 units, so then the lane reads only the row's word.
template <int BITS, bool WORDS>
__device__ __forceinline__ float row_dot(const unsigned char* row, int units, int g,
                                         const float* qt,
                                         const float (&qr)[WORDS ? 32 / BITS : 8 / BITS]) {
  constexpr int kCpu = WORDS ? 32 / BITS : 8 / BITS;  // codes a unit
  float acc = 0.f;
  if (units <= 32) {
    if (g < units) {
      const uint32_t x = WORDS ? reinterpret_cast<const uint32_t*>(row)[g] : row[g];
      const uint32_t lo = x & 0x0f0f0f0fu;
      const uint32_t hi = (x >> 4) & 0x0f0f0f0fu;
#pragma unroll
      for (int j = 0; j < kCpu; ++j) acc += code_of<BITS>(x, lo, hi, j) * qr[j];
    }
    return acc;
  }
  for (int u = g; u < units; u += 32) {
    const uint32_t x = WORDS ? reinterpret_cast<const uint32_t*>(row)[u] : row[u];
    const uint32_t lo = x & 0x0f0f0f0fu;
    const uint32_t hi = (x >> 4) & 0x0f0f0f0fu;
#pragma unroll
    for (int j = 0; j < kCpu; ++j) acc += code_of<BITS>(x, lo, hi, j) * qt[j * units + u];
  }
  return acc;
}

// Dots of the staged rows [0, m) (row r at stage + r * stride) into sdot:
// a group of G lanes a row, the group's lanes reduced by xor shuffles G/2
// .. 1; a lane takes kScoreChains rows a pass. A row's dot does not depend
// on which pass, group or chain scores it.
template <int BITS, bool WORDS>
__device__ __forceinline__ void score_rows(const unsigned char* stage, int stride, float* sdot,
                                           int m, const float (&qr)[WORDS ? 32 / BITS : 8 / BITS],
                                           const float* qt, int units, int lane) {
  constexpr int kChains = kScoreChains<BITS>;
  const int G = units < 32 ? pow2_at_least(units) : 32;
  const int glog = 31 - __clz(G);
  const int per = 32 >> glog;  // rows a pass, a group each
  const int g = lane & (G - 1);
  for (int r0 = 0; r0 < m; r0 += kChains * per) {  // uniform over the warp
    const int r = r0 + (lane >> glog);
    float acc[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      acc[c] = r + c * per < m
                   ? row_dot<BITS, WORDS>(stage + (r + c * per) * stride, units, g, qt, qr)
                   : 0.f;
    for (int off = G >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int c = 0; c < kChains; ++c) acc[c] += __shfl_xor_sync(kFullMask, acc[c], off);
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      if (g == 0 && r + c * per < m) sdot[r + c * per] = acc[c];
  }
}

}  // namespace jasper
