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
// Design: ascending (distance, position) order, so ties go to the lower
// position and every position is taken once. Distances are compared as
// order-preserving 32-bit keys (-0 taken as +0, so the order is that of
// float compares; NaN after +inf, as torch.sort puts it).
//
// Rows of C <= 256 (kWarpMaxColumns; every merge of the search lanes): one
// warp a row, four rows a block. The row's distances are read once, M =
// C/32 rounded up to a power of two a lane (16-byte loads when C is a
// multiple of 4), and held in registers as (key, position) pairs, past C
// a key above every distance. A bitonic sort of the 32 M pairs runs in the
// warp's registers: strides below M within a lane, the others across lanes
// by shuffles, 28 stages at C = 128, about C log^2 C / 2 compares a row
// against the C x C of ranking each value against the row. Lane l then holds
// output slots M l .. M l + M - 1 in order, and the first k slots' lanes
// read their distance and id back by position: ids are read only for the
// k winners. No shared memory and no barrier.
//
// Wider rows, up to kMaxColumns: one block a row, the row in shared memory,
// each thread ranking elements t, t + 128, ... by the stable rank
// #(d_j < d_i) + #(d_j == d_i, j < i), which is a permutation of 0..C-1: an
// element whose rank is below k writes itself to slot rank, every slot
// once. The wrapper states the dispatch (topk.ops.WARP_MAX_COLUMNS).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kMaxColumns = 12288;     // a row fits the default 48 KB
constexpr int kWarpMaxColumns = 256;   // M = 8 values a lane
constexpr int kRowsPerBlock = 4;       // warps (rows) a block on the warp path
constexpr unsigned kPad = 0xffffffffu; // above the key of +inf (0xff800000)

// Order-preserving key of a float: key(a) < key(b) iff a < b, for all
// non-NaN a, b with -0 == +0.
__device__ __forceinline__ unsigned key_of(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

// (key, pos) of a precedes (key, pos) of b: ascending keys, then positions
__device__ __forceinline__ bool precedes(unsigned ka, int pa, unsigned kb, int pb) {
  return ka < kb || (ka == kb && pa < pb);
}

// Bitonic sort of the row's 32 M (key, position) pairs across the warp,
// position M lane + e in element e of the lane's registers; the k first
// after the sort are the k smallest, in order.
template <int M>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
topk_warp_kernel(const float* __restrict__ dists, const int32_t* __restrict__ ids, int num_rows,
                 int c, int k, int vec, float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= static_cast<size_t>(num_rows)) return;
  const float* d = dists + row * c;
  const int i0 = M * lane;
  unsigned key[M];
  int pos[M];
  if (M >= 4 && vec) {
#pragma unroll
    for (int e = 0; e < M; e += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + e < c) f = __ldg(reinterpret_cast<const float4*>(d + i0 + e));
      key[e] = key_of(f.x);
      key[e + 1] = key_of(f.y);
      key[e + 2] = key_of(f.z);
      key[e + 3] = key_of(f.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < M; ++e) key[e] = i0 + e < c ? key_of(__ldg(d + i0 + e)) : 0u;
  }
#pragma unroll
  for (int e = 0; e < M; ++e) {
    pos[e] = i0 + e;
    if (i0 + e >= c) key[e] = kPad;
  }
#pragma unroll
  for (int size = 2; size <= 32 * M; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
      if (s < M) {
#pragma unroll
        for (int e = 0; e < M; ++e) {
          if (e & s) continue;
          const int f = e | s;
          const bool up = ((i0 + e) & size) == 0;
          if (precedes(key[f], pos[f], key[e], pos[e]) == up) {
            const unsigned tk = key[e];
            const int tp = pos[e];
            key[e] = key[f];
            pos[e] = pos[f];
            key[f] = tk;
            pos[f] = tp;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < M; ++e) {
          const unsigned ok = __shfl_xor_sync(kFullMask, key[e], s / M);
          const int op = __shfl_xor_sync(kFullMask, pos[e], s / M);
          const bool up = ((i0 + e) & size) == 0;
          const bool lower = ((i0 + e) & s) == 0;
          if (precedes(ok, op, key[e], pos[e]) == (lower == up)) {
            key[e] = ok;
            pos[e] = op;
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const int r = i0 + e;
    if (r < k) {
      out_d[row * k + r] = __ldg(d + pos[e]);
      out_i[row * k + r] = __ldg(ids + row * c + pos[e]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_block_kernel(const float* __restrict__ dists, const int32_t* __restrict__ ids, int c, int k,
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

template <int M>
int launch_warp(const float* dists, const int32_t* ids, int num_rows, int c, int k,
                float* out_d, int32_t* out_i, cudaStream_t s) {
  const int vec = (c & 3) == 0 && (reinterpret_cast<uintptr_t>(dists) & 15) == 0;
  const int blocks = (num_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  topk_warp_kernel<M><<<blocks, 32 * kRowsPerBlock, 0, s>>>(dists, ids, num_rows, c, k, vec,
                                                          out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int topk_launch(const float* dists, const int32_t* ids, int num_rows, int c, int k,
                           float* out_d, int32_t* out_i, void* stream) {
  if (c > kMaxColumns || k > c || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 32) return launch_warp<1>(dists, ids, num_rows, c, k, out_d, out_i, s);
  if (c <= 64) return launch_warp<2>(dists, ids, num_rows, c, k, out_d, out_i, s);
  if (c <= 128) return launch_warp<4>(dists, ids, num_rows, c, k, out_d, out_i, s);
  if (c <= kWarpMaxColumns) return launch_warp<8>(dists, ids, num_rows, c, k, out_d, out_i, s);
  const size_t smem = static_cast<size_t>(c) * sizeof(float);
  topk_block_kernel<<<num_rows, kThreads, smem, s>>>(dists, ids, c, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}
