// Shared tile loop of the all-pairs kernels (pairwise_l2.cu, rabitq_distance.cu).
//
// A block computes one kBM x kBN tile of acc = A . B^T over the D axis:
// A is kBM query rows (float, row-major, D contiguous), B is kBN table rows
// produced by a loader functor (float rows, or unpacked RaBitQ codes). Each
// stage of kBK dims is staged through registers into shared memory,
// transposed to [kBK][rows], double-buffered: the next stage's global loads
// are in flight while the current one is multiplied, and one barrier per
// stage separates them.
//
// 256 threads as 16 x 16; thread (ty, tx) owns the 8 x 8 outputs at tile
// rows {4ty..4ty+3, 64+4ty..64+4ty+3} and cols {4tx.., 64+4tx..}, read as
// float4 from shared memory (4 LDS.128 per 64 FFMA). Loads: thread t stages
// 4 consecutive dims (t & 1) * 4 .. +3 of A row t/2 and of B row t/2.
// Plain float32 FFMA throughout: no tensor cores and no TF32, so products
// of integer-valued operands below 2^24 are exact in any order.

#pragma once

#include "common.cuh"

namespace jasper {
namespace tile {

constexpr int kBM = 128;       // query rows per block
constexpr int kBN = 128;       // table rows per block
constexpr int kBK = 8;         // dims per stage
constexpr int kThreads = 256;
constexpr int kLd = kBM + 4;   // padded shared row (kBM == kBN), 16-byte multiple

struct Stage {
  float a[kBK][kLd];
  float b[kBK][kLd];
};

// Dims k..k+3 of row r of a (rows, d) float matrix; zero past either edge.
// VEC: d % 4 == 0 and a 16-byte aligned base, so one float4 per call.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int rows, int d, int r,
                                        int k) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows || k >= d) return v;
  const float* p = src + static_cast<size_t>(r) * d + k;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (k + 1 < d) v.y = __ldg(p + 1);
  if (k + 2 < d) v.z = __ldg(p + 2);
  if (k + 3 < d) v.w = __ldg(p + 3);
  return v;
}

// Float rows of the table as the B operand.
template <bool VEC>
struct RowLoader {
  const float* __restrict__ x;
  int rows, d, r0;
  __device__ __forceinline__ float4 operator()(int r, int k) const {
    return load4<VEC>(x, rows, d, r0 + r, k);
  }
};

__device__ __forceinline__ void put4(float (*s)[kLd], int kg, int r, float4 v) {
  s[kg][r] = v.x;
  s[kg + 1][r] = v.y;
  s[kg + 2][r] = v.z;
  s[kg + 3][r] = v.w;
}

__device__ __forceinline__ float sq4(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

// Tile row (or col) of output i of a thread at ty (or tx).
__device__ __forceinline__ int lane_row(int t, int i) { return (i < 4 ? 4 * t : 64 + 4 * t) + (i & 3); }

__device__ __forceinline__ void multiply_stage(const Stage& s, int ty, int tx,
                                               float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][4 * ty]);
    const float4 a1 = *reinterpret_cast<const float4*>(&s.a[k][64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s.b[k][64 + 4 * tx]);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc = A[m0 : m0+kBM] . B^T over all d dims (acc must start at zero).
// NORMS: also accumulate this thread's partial |a|^2 and |b|^2 of the rows
// it stages (row t/2, dims of its half); the pair (t, t^1) holds a row's two
// halves. Ends with a barrier, so `st` may be reused by the caller.
template <bool VEC_A, bool NORMS, class LoadB>
__device__ __forceinline__ void tile_product(const float* __restrict__ q, int nq, int d, int m0,
                                             const LoadB& load_b, Stage (&st)[2],
                                             float (&acc)[8][8], float& a_norm, float& b_norm) {
  const int t = threadIdx.x;
  const int r = t >> 1;
  const int kg = (t & 1) * 4;
  const int ty = t >> 4;
  const int tx = t & 15;
  float4 av = load4<VEC_A>(q, nq, d, m0 + r, kg);
  float4 bv = load_b(r, kg);
  put4(st[0].a, kg, r, av);
  put4(st[0].b, kg, r, bv);
  if (NORMS) {
    a_norm += sq4(av);
    b_norm += sq4(bv);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    const bool more = k0 + kBK < d;
    if (more) {
      av = load4<VEC_A>(q, nq, d, m0 + r, k0 + kBK + kg);
      bv = load_b(r, k0 + kBK + kg);
    }
    multiply_stage(st[buf], ty, tx, acc);
    if (more) {
      put4(st[buf ^ 1].a, kg, r, av);
      put4(st[buf ^ 1].b, kg, r, bv);
      if (NORMS) {
        a_norm += sq4(av);
        b_norm += sq4(bv);
      }
    }
    __syncthreads();
    buf ^= 1;
  }
}

// Write the thread's 8 x 8 outputs, epi(row, col, acc) each, masked to the
// (nq, nc) edge. VEC_OUT: nc % 4 == 0 and a 16-byte aligned out, so each
// run of 4 columns is one streaming float4 store (the output is written
// once and never read back by the kernel).
template <bool VEC_OUT, class Epilogue>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int nq, int nc, int m0, int n0,
                                           const float (&acc)[8][8], const Epilogue& epi) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + lane_row(ty, i);
    if (m >= nq) continue;
    float* row = out + static_cast<size_t>(m) * nc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + lane_row(tx, 4 * h);
      if (VEC_OUT) {
        if (n < nc) {
          const float4 v = make_float4(epi(m, n, acc[i][4 * h]), epi(m, n + 1, acc[i][4 * h + 1]),
                                       epi(m, n + 2, acc[i][4 * h + 2]),
                                       epi(m, n + 3, acc[i][4 * h + 3]));
          __stcs(reinterpret_cast<float4*>(row + n), v);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < nc) row[n + j] = epi(m, n + j, acc[i][4 * h + j]);
      }
    }
  }
}

}  // namespace tile
}  // namespace jasper
