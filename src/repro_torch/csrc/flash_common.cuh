// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels: the tile shape, element
// conversions, pair loads and the staging of a 64-row tile of one head into
// shared memory (the float32 SIMT kernels); and, for the bf16 kernels, the
// tensor-core product mma.sync m16n8k16 (bf16 in, f32 accumulate), its
// ldmatrix fragment loads, cp.async copies with a zero fill, and the
// padded shared tiles they read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace flash {

constexpr int kRows = 64;      // query rows per tile
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 16 x 16

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x rounded to T and back: where the Pallas kernels cast an f32 block to
// the operand type before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Copy rows [row0, row0 + 64) of one head (base, row stride) into a shared
// tile of stride kDh + 2; rows past n are zero. The odd row length in
// pairs keeps 16 lanes reading one column of 16 rows on 16 banks.
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

// ------------------------------------------------- bf16 tensor-core path
//
// Fragments of mma.sync.m16n8k16.row.col (lane = 4 * g + t):
//   A (16 x 16, 4 regs of 2 bf16): a0 (row g, cols 2t, 2t+1), a1 (row g+8,
//     same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8..9);
//   B (16 x 8, 2 regs): b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C (16 x 8, 4 f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the accumulators of two neighbouring n-tiles (8 columns each) are,
// rounded to bf16 in pairs, the A fragment of one 16-column k-chunk: a
// probability tile goes from one product to the next in registers.
//
// Shared tiles hold rows of kDh + 8 bf16: kDh / 8 + 1 chunks of 16 bytes,
// an odd number at every head dim (5, 9, 11, 17 for 32, 64, 80, 128), so
// the 8 row addresses of one ldmatrix phase fall on 8 distinct 16-byte
// bank groups.

template <int kDh>
struct Tile {
  static constexpr int kStride = kDh + 8;  // elements of a shared row
  static constexpr int kChunks = kDh / 8;  // 16-byte chunks of a row
  static constexpr int kK = kDh / 16;      // k-chunks of a head row
  static constexpr int kN = kDh / 8;       // n-tiles of a head row
  static constexpr int kElems = 64 * kStride;
};

using jasper::cp_async16;
using jasper::cp_async4;
using jasper::cp_async_commit;
using jasper::cp_async_wait;
using jasper::smem_addr;

// Rows [row0, row0 + kTileRows) of one head (base, row stride in elements)
// into a padded shared tile with cp.async, by `threads` threads; rows at or
// past n are zero-filled. (The forward passes its thread count as a
// constant. The backward passes blockDim.x: a stride unknown to the
// compiler keeps it from hoisting every copy's offsets out of the tile
// loop, which raised the dq kernel's registers and slowed it on the
// H100.)
template <int kDh, int kTileRows = 64>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int n, int threads) {
  using L = Tile<kDh>;
  for (int i = threadIdx.x; i < kTileRows * L::kChunks; i += threads) {
    const int r = i / L::kChunks;
    const int c = (i - r * L::kChunks) * 8;
    const bool valid = row0 + r < n;
    cp_async16(dst + r * L::kStride + c,
               valid ? base + static_cast<long long>(row0 + r) * row_stride + c : base, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b (16 x 8 f32 += 16 x 16 bf16 * 16 x 8 bf16).
using jasper::mma_bf16;

// The A fragment of k-chunk kc of the 16 rows at `rows` (a row-major
// shared tile, row stride kStride): 16 x 16 from column 16 kc.
template <int kStride>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const __nv_bfloat16* rows, int kc) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, rows + (lane & 15) * kStride + kc * 16 + (lane >> 4) * 8);
}

// B fragments of n-tiles n2 and n2 + 1 (8 columns each) at k-chunk kc,
// from a tile stored n-major ([n][k], "col"): b[0], b[1] for n-tile n2,
// b[2], b[3] for n2 + 1. For K in Q.K^T (n = key, k = head dim).
template <int kStride>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const __nv_bfloat16* tile, int n2,
                                       int kc) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4(b, tile + (n2 * 16 + (m >> 1) * 8 + (lane & 7)) * kStride + kc * 16 + (m & 1) * 8);
}

// The same fragments from a tile stored k-major ([k][n], row-major K x N)
// through ldmatrix.trans. For V in P.V (k = key, n = head dim).
template <int kStride>
__device__ __forceinline__ void load_b_trans(unsigned (&b)[4], const __nv_bfloat16* tile,
                                             int n2, int kc) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  ldsm_x4_trans(b, tile + (kc * 16 + (m & 1) * 8 + (lane & 7)) * kStride + n2 * 16 + (m >> 1) * 8);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// acc (this warp's 16 rows x kDh, C layout), row g divided by div0 and
// row g + 8 by div1, rounded to bf16, written to rows
// [row0, row0 + 16) of a global (row stride gstride) tile with 16-byte
// stores through the warp's 16 rows of a shared tile; rows at or past n
// are not written.
template <int kDh>
__device__ __forceinline__ void store_rows(const float (&acc)[kDh / 8][4], float div0,
                                           float div1, __nv_bfloat16* srows,
                                           __nv_bfloat16* gbase, long long gstride, int row0,
                                           int n) {
  using L = Tile<kDh>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < L::kN; ++nt) {
    *reinterpret_cast<unsigned*>(srows + g * L::kStride + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][0] / div0, acc[nt][1] / div0);
    *reinterpret_cast<unsigned*>(srows + (g + 8) * L::kStride + nt * 8 + 2 * t) =
        pack_bf16(acc[nt][2] / div1, acc[nt][3] / div1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * L::kChunks; i += 32) {
    const int r = i / L::kChunks;
    const int c = (i - r * L::kChunks) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(gbase + static_cast<long long>(row0 + r) * gstride + c) =
          *reinterpret_cast<const uint4*>(srows + r * L::kStride + c);
  }
}

}  // namespace flash
