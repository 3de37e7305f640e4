// Shared device helpers for the Jasper search kernels (sm_90a).
//
// packed_dot: one warp's inner product between a bit-packed RaBitQ code
// row and a float query in shared memory. Codes are little-endian within
// each byte (code j of a byte occupies bits [j*BITS, (j+1)*BITS)), so in
// a little-endian 32-bit word code j sits at bits [j*BITS, (j+1)*BITS)
// too: one shift+mask per code, no byte shuffling. Rows whose width is a
// multiple of 4 bytes (64 B at D=128, 4 bits) are read as coalesced
// 32-bit words, one word per lane; other widths fall back to bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jasper {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Partial (per-lane) dot of a packed code row with q (Dq = P * 8/BITS
// floats, zero beyond the true dims). Reduce with warp_sum.
template <int BITS>
__device__ __forceinline__ float packed_dot(const uint8_t* __restrict__ row,
                                            int p, const float* __restrict__ q,
                                            int lane) {
  constexpr int kCpb = 8 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  float acc = 0.f;
  if ((p & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 3) == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    for (int i = lane; i < (p >> 2); i += 32) {
      const uint32_t word = __ldg(w + i);
      const float* qq = q + i * 4 * kCpb;
#pragma unroll
      for (int j = 0; j < 4 * kCpb; ++j)
        acc += static_cast<float>((word >> (j * BITS)) & kMask) * qq[j];
    }
  } else {
    for (int i = lane; i < p; i += 32) {
      const uint32_t byte = __ldg(row + i);
      const float* qq = q + i * kCpb;
#pragma unroll
      for (int j = 0; j < kCpb; ++j)
        acc += static_cast<float>((byte >> (j * BITS)) & kMask) * qq[j];
    }
  }
  return acc;
}

// Partial (per-lane) dot of a float row with q (d floats). float4 loads
// when the row is 16-byte aligned and d a multiple of 4.
__device__ __forceinline__ float float_dot(const float* __restrict__ row, int d,
                                           const float* __restrict__ q, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int i = lane; i < (d >> 2); i += 32) {
      const float4 v = __ldg(r4 + i);
      const float* qq = q + 4 * i;
      acc += v.x * qq[0];
      acc += v.y * qq[1];
      acc += v.z * qq[2];
      acc += v.w * qq[3];
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += __ldg(row + i) * q[i];
  }
  return acc;
}

// RaBitQ estimator epilogue, in the reference's association order:
// (add + qa) + rescale * (dot - qsum), clamped at 0. The _rn intrinsics
// keep the compiler from contracting it into an FMA, so the kernels round
// like the plain PyTorch version.
__device__ __forceinline__ float rabitq_epilogue(float add, float qa, float rescale,
                                                 float dot, float qsum) {
  const float est = __fadd_rn(__fadd_rn(add, qa), __fmul_rn(rescale, __fsub_rn(dot, qsum)));
  return fmaxf(est, 0.f);
}

// Exact squared-L2 epilogue: (|q|^2 - 2 q.c) + |c|^2, clamped at 0.
__device__ __forceinline__ float l2_epilogue(float qsq, float dot, float csq) {
  return fmaxf(__fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, dot)), csq), 0.f);
}

}  // namespace jasper
