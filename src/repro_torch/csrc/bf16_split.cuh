// Exact bf16 splits of float32 operands for the all-pairs tensor-core
// kernels (rabitq_distance.cu, pairwise_l2.cu), and the staging of the
// float row tiles that they split.
//
// A float32 value has 24 significant bits and a bf16 value 8, so three bf16
// parts hold it exactly: h0 = rn(v), h1 = rn(v - h0), h2 = rn(v - h0 - h1),
// each remainder rounded to nearest even, and v = h0 + h1 + h2 with nothing
// left over (each remainder is exact in float32: Sterbenz). A product of two
// parts has at most 16 significant bits, so it is exact in float32, and
// mma.sync (bf16 in, f32 accumulate) adds exact products. A value that is
// already a bf16 value (an integer of magnitude <= 256, a bf16 input
// widened) has h1 = h2 = 0.

#pragma once

#include "flash_common.cuh"

namespace jasper {

// The float value of the low or high bf16 of a pair.
__device__ __forceinline__ float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// The first part of four floats, two bf16 a word, and `rest` ORed with the
// bits of their remainders v - h0: rest stays 0 iff all four are bf16
// values (v - h0 is +0 exactly when v == h0).
__device__ __forceinline__ uint2 bf16_head4(float4 v, unsigned& rest) {
  const unsigned h0 = flash::pack_bf16(v.x, v.y);
  const unsigned h1 = flash::pack_bf16(v.z, v.w);
  rest |= __float_as_uint(v.x - bf16_lo(h0)) | __float_as_uint(v.y - bf16_hi(h0)) |
          __float_as_uint(v.z - bf16_lo(h1)) | __float_as_uint(v.w - bf16_hi(h1));
  return make_uint2(h0, h1);
}

// The three parts of four floats, two bf16 a word: v = h[0] + h[1] + h[2].
__device__ __forceinline__ void bf16_split4(float4 v, uint2 (&h)[3]) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  unsigned p[3][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const unsigned h0 = flash::pack_bf16(x[2 * i], x[2 * i + 1]);
    const float r0 = x[2 * i] - bf16_lo(h0);
    const float r1 = x[2 * i + 1] - bf16_hi(h0);
    const unsigned h1 = flash::pack_bf16(r0, r1);
    p[0][i] = h0;
    p[1][i] = h1;
    p[2][i] = flash::pack_bf16(r0 - bf16_lo(h1), r1 - bf16_hi(h1));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = make_uint2(p[k][0], p[k][1]);
}

// Copies of k-chunk [k0, k0 + kKC) of rows [r0, r0 + kRows) of a (rows, d)
// float matrix into a shared buffer [row][kKC], by kThreads threads: float4
// f = t + kThreads j at (f / (kKC / 4), 4 (f % (kKC / 4))). 16-byte copies
// when `vec` (d a multiple of 4 and a 16-byte aligned base), else 4-byte
// ones; zero past `rows` and d.
template <int kRows, int kKC, int kThreads>
__device__ __forceinline__ void stage_floats(float* fs, const float* __restrict__ src, int rows,
                                             int d, int r0, int k0, bool vec) {
  constexpr unsigned kPerRow = kKC / 4;
#pragma unroll
  for (int j = 0; j < kRows * kPerRow / kThreads; ++j) {
    const unsigned f = threadIdx.x + kThreads * j;
    const int r = f / kPerRow;
    const int c = 4 * (f % kPerRow);
    const bool row = r0 + r < rows;
    const float* p = src + static_cast<size_t>(row ? r0 + r : 0) * d + k0 + c;
    if (vec) {
      const bool valid = row && k0 + c < d;
      cp_async16(fs + r * kKC + c, valid ? p : src, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = row && k0 + c + e < d;
        cp_async4(fs + r * kKC + c + e, valid ? p + e : src, valid);
      }
    }
  }
}

}  // namespace jasper
