// topk — the k smallest of each row, ascending, with their ids.
//
// Replaces: topk_pallas (repro/kernels/topk/topk_kernel.py:49), the merge
// of the unfused beam-search loop at merge="kernel" (frontier ++
// candidates, C = L + R = 128 columns, k = L = 64 on the main path).
// Semantics are the oracle topk_ref's (repro/kernels/topk/ref.py:11):
// ties go to the lower position and every position is taken once, so an
// all-+inf tail keeps its own ids. The TPU kernel's k passes of
// argmin + mask repeat an already-taken entry into such a tail instead.
//
// Bound on the H100: bytes. It must read Q*C*8 B (dists and ids) and
// write Q*k*8 B; the C*C comparisons per row are far below the compare
// rate.
//
// Design: one block per row, the row's distances in shared memory. Each
// thread takes elements i and computes the stable rank
// #(d_j < d_i) + #(d_j == d_i, j < i); an element whose rank is below k
// writes itself, dist and id, to slot rank. Ranks are a permutation of
// 0..C-1, so every output slot is written exactly once, with no sort and
// no second pass — the merge the megakernel already uses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxColumns = 12288;  // a row fits the default 48 KB

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ dists, const int32_t* __restrict__ ids, int c, int k,
            float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ float sd[];  // c floats
  const size_t row = blockIdx.x;
  const float* d = dists + row * c;
  for (int i = threadIdx.x; i < c; i += kThreads) sd[i] = d[i];
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += kThreads) {
    const float di = sd[i];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += sd[j] <= di;
    for (int j = i + 1; j < c; ++j) rank += sd[j] < di;
    if (rank < k) {
      out_d[row * k + rank] = di;
      out_i[row * k + rank] = ids[row * c + i];
    }
  }
}

}  // namespace

extern "C" int topk_launch(const float* dists, const int32_t* ids, int num_rows, int c, int k,
                           float* out_d, int32_t* out_i, void* stream) {
  if (c > kMaxColumns || k > c || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(c) * sizeof(float);
  topk_kernel<<<num_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(dists, ids, c, k,
                                                                                out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}
