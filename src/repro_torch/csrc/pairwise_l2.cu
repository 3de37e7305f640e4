// pairwise_l2 — squared L2 distances of every (query, row) pair.
//
// Replaces: pairwise_l2_pallas (repro/kernels/distance/distance_kernel.py:58),
// an (nQ, nC, nD)-tiled MXU product with a D-axis accumulator in VMEM and the
// |q|^2 - 2 q.x + |x|^2 epilogue; its wrapper padded every axis to a tile
// multiple and computed both norm vectors in XLA before the call.
//
// Bound on the H100: float32 operations at realistic shapes. At (Q, C, D) =
// (10,000, 131,072, 128) the product is 2QCD = 3.36e11 flop, 5.0 ms at 67
// TFLOP/s; the bytes are the (Q, C) output, 5.24 GB = 1.57 ms at 3.35 TB/s
// (the inputs are 72 MB). So the design is a register-blocked SIMT product.
//
// Design: one block per 128 x 128 output tile (grid x over query tiles, so
// consecutive blocks share a table tile in L2), the shared tile loop of
// tiled_product.cuh over D in stages of 8 (double-buffered, 8 x 8 outputs
// per thread), both squared norms accumulated from the staged registers
// (no separate pass, no norm operands), and the epilogue
// max((|q|^2 - 2 q.x) + |x|^2, 0) fused into streaming stores. Ragged Q, C
// and D are masked in-kernel: no padding. Float32 FFMA only, off TF32.

#include "tiled_product.cuh"

namespace {

using namespace jasper::tile;

struct L2Epilogue {
  const float* qsq;  // shared, tile-local
  const float* xsq;
  int m0, n0;
  __device__ __forceinline__ float operator()(int m, int n, float dot) const {
    return jasper::l2_epilogue(qsq[m - m0], dot, xsq[n - n0]);
  }
};

template <bool VEC, bool VEC_OUT>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int nq, int nc, int d) {
  __shared__ __align__(16) Stage st[2];
  __shared__ float qsq[kBM];
  __shared__ float xsq[kBN];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float qn = 0.f, xn = 0.f;
  tile_product<VEC, true>(q, nq, d, m0, RowLoader<VEC>{x, nc, d, n0}, st, acc, qn, xn);
  // rows t/2 hold their two halves in threads t and t^1
  qn += __shfl_xor_sync(jasper::kFullMask, qn, 1);
  xn += __shfl_xor_sync(jasper::kFullMask, xn, 1);
  if ((threadIdx.x & 1) == 0) {
    qsq[threadIdx.x >> 1] = qn;
    xsq[threadIdx.x >> 1] = xn;
  }
  __syncthreads();
  store_tile<VEC_OUT>(out, nq, nc, m0, n0, acc, L2Epilogue{qsq, xsq, m0, n0});
}

template <bool VEC, bool VEC_OUT>
int launch(const float* q, const float* x, float* out, int nq, int nc, int d,
           cudaStream_t stream) {
  const dim3 grid((nq + kBM - 1) / kBM, (nc + kBN - 1) / kBN);
  pairwise_l2_kernel<VEC, VEC_OUT><<<grid, kThreads, 0, stream>>>(q, x, out, nq, nc, d);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int pairwise_l2_launch(const float* q, const float* x, float* out, int nq, int nc,
                                  int d, void* stream) {
  if ((nc + kBN - 1) / kBN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (d & 3) == 0 && aligned16(q) && aligned16(x);
  const bool vec_out = (nc & 3) == 0 && aligned16(out);
  if (vec)
    return vec_out ? launch<true, true>(q, x, out, nq, nc, d, s)
                   : launch<true, false>(q, x, out, nq, nc, d, s);
  return vec_out ? launch<false, true>(q, x, out, nq, nc, d, s)
                 : launch<false, false>(q, x, out, nq, nc, d, s);
}
