// gather_l2 — exact squared-L2 distances of gathered candidate rows.
//
// Replaces: gather_l2_chunked_pallas (repro/kernels/distance/
// distance_kernel.py:130) together with its wrapper's XLA gather
// (repro/kernels/distance/ops.py:74), which built a (Q, K, D) candidate
// buffer in HBM before the kernel streamed it back.
//
// Bound on the H100: bytes. Per query it must read K ids and K candidate
// rows of D floats plus their squared norms, and write K floats:
// K * (4D + 4 + 4 + 4) bytes, about 33 KB at K=64, D=128 — against 2*K*D
// flops, far below the card's flop/byte balance. The TPU design's extra
// round trip through the (Q, K, D) buffer tripled the bytes.
//
// Design: one block per query, the query in shared memory; one warp per
// candidate row, reading the row itself with coalesced float4 loads (one
// 512 B row = one float4 per lane at D=128) and reducing by shuffle. No
// intermediate buffer exists. out = max(|q|^2 - 2 q.c + |c|^2, 0), and
// +inf for id < 0; ids past the table clamp to its last row, as an XLA
// gather does.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_l2_kernel(const float* __restrict__ q, const int32_t* __restrict__ ids,
                 const float* __restrict__ table, const float* __restrict__ sqnorm,
                 float* __restrict__ out, int k, int d, int n) {
  extern __shared__ float sq[];  // d floats
  const int qi = blockIdx.x;
  for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[static_cast<size_t>(qi) * d + i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // |q|^2, computed by every warp from shared memory (no extra barrier)
  float qsq = 0.f;
  for (int i = lane; i < d; i += 32) qsq += sq[i] * sq[i];
  qsq = jasper::warp_sum(qsq);

  for (int c = warp; c < k; c += n_warps) {
    const int id = ids[static_cast<size_t>(qi) * k + c];
    float dist = INFINITY;
    if (id >= 0) {  // uniform across the warp
      const int safe = min(id, n - 1);
      float dot = jasper::float_dot(table + static_cast<size_t>(safe) * d, d, sq, lane);
      dot = jasper::warp_sum(dot);
      dist = jasper::l2_epilogue(qsq, dot, __ldg(sqnorm + safe));
    }
    if (lane == 0) out[static_cast<size_t>(qi) * k + c] = dist;
  }
}

}  // namespace

extern "C" int gather_l2_launch(const float* q, const int32_t* ids, const float* table,
                                const float* sqnorm, float* out, int num_q, int k, int d,
                                int n, void* stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gather_l2_kernel<<<num_q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, ids, table, sqnorm, out, k, d, n);
  return static_cast<int>(cudaGetLastError());
}
