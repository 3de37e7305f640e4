// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels: the tile shape, element
// conversions, pair loads and the staging of a 64-row tile of one head into
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kRows = 64;      // query rows per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: where the Pallas kernels cast an f32 block to
// the operand type before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Copy rows [row0, row0 + 64) of one head (base, row stride) into a shared
// tile of stride kDh + 2; rows past n are zero. The odd row length in words
// (bf16) or pairs (f32) keeps 16 lanes reading one column of 16 rows on 16
// banks.
template <typename T, int kDh>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ base,
                                      long long row_stride, int row0, int n) {
  constexpr int kPairs = kDh / 2;
  const T zero = from_f32<T>(0.f);
  for (int i = threadIdx.x; i < kRows * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = (i - r * kPairs) * 2;
    Pair<T> val{zero, zero};
    if (row0 + r < n)
      val = *reinterpret_cast<const Pair<T>*>(base + (row0 + r) * row_stride + c);
    *reinterpret_cast<Pair<T>*>(dst + r * (kDh + 2) + c) = val;
  }
}

}  // namespace flash
