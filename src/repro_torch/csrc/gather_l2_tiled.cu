// gather_l2_tiled — exact squared-L2 distances of gathered candidate rows,
// fetched one row at a time ("tiled" loads).
//
// Replaces: gather_l2_tiled_pallas (repro/kernels/distance/
// distance_kernel.py:90), whose grid step (q, k) DMAs ONE candidate row
// through a scalar-prefetched index map and reduces it on the VPU: one
// outstanding row per step, the latency-exposed baseline that the paper's
// "chunked" strategy (gather_l2.cu) is measured against.
//
// The function is gather_l2.cu's: out[q, k] = max(|q|^2 - 2 q.c + |c|^2, 0)
// with c = table[min(ids[q, k], N - 1)], and +inf for ids < 0. Its bound on
// the H100 is gather_l2's too (bytes: K * (4D + 4) B of rows and norms per
// query plus ids and outputs, about 33 KB at K = 64, D = 128).
//
// Design, the opposite of gather_l2.cu's (one warp per row, one float4 per
// lane, eight rows in flight per block): one block of 128 threads per
// query, the query in shared memory, and the block walks its K candidates
// in order. For each it fetches the row in 4-byte element loads (thread t
// reads elements t, t + 128, ...: one load each at D = 128), reduces by
// shuffle and through shared memory, and passes one barrier before the
// next row's loads issue: one row in flight per block. ids < 0 skip the
// row (uniform across the block).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_l2_tiled_kernel(const float* __restrict__ q, const int32_t* __restrict__ ids,
                       const float* __restrict__ table, const float* __restrict__ sqnorm,
                       float* __restrict__ out, int k, int d, int n) {
  extern __shared__ float sq[];  // d floats
  __shared__ float part[2][kWarps];
  const int qi = blockIdx.x;
  for (int i = threadIdx.x; i < d; i += kThreads) sq[i] = q[static_cast<size_t>(qi) * d + i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // |q|^2 as gather_l2.cu takes it: lane-strided, then a shuffle reduction
  float qsq = 0.f;
  for (int i = lane; i < d; i += 32) qsq += sq[i] * sq[i];
  qsq = jasper::warp_sum(qsq);

  int slot = 0;  // partials double-buffered: one barrier per fetched row
  for (int c = 0; c < k; ++c) {
    const size_t e = static_cast<size_t>(qi) * k + c;
    const int id = ids[e];
    if (id < 0) {  // uniform across the block: no barrier skipped by some
      if (threadIdx.x == 0) out[e] = INFINITY;
      continue;
    }
    const int safe = min(id, n - 1);
    const float* row = table + static_cast<size_t>(safe) * d;
    float acc = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) acc += __ldg(row + i) * sq[i];
    acc = jasper::warp_sum(acc);
    if (lane == 0) part[slot][warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dot += part[slot][w];
      out[e] = jasper::l2_epilogue(qsq, dot, __ldg(sqnorm + safe));
    }
    slot ^= 1;
  }
}

}  // namespace

extern "C" int gather_l2_tiled_launch(const float* q, const int32_t* ids, const float* table,
                                      const float* sqnorm, float* out, int num_q, int k, int d,
                                      int n, void* stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gather_l2_tiled_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gather_l2_tiled_kernel<<<num_q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, ids, table, sqnorm, out, k, d, n);
  return static_cast<int>(cudaGetLastError());
}
