// rabitq_distance / rabitq_gather_distance — RaBitQ estimated squared L2,
// with no masking epilogue:
//
//   est = max((add_c + qa) + rescale_c * (<unpack(code_c), q_rot> - qsum), 0)
//
// rabitq_distance replaces rabitq_distance_pallas (repro/kernels/rabitq_dot/
// rabitq_kernel.py:172): every (query, row) pair of a (Q, D) rotated query
// block and a (C, P) packed code table, the estimator over a full scan.
// Bound on the H100: float32 operations. At (Q, C) = (10,000, 131,072),
// D = 128, 4 bits: 2QCD = 3.36e11 flop = 5.0 ms at 67 TFLOP/s; the codes are
// only 8.4 MB, the output 5.24 GB = 1.57 ms. Design: the register-blocked
// tile loop of tiled_product.cuh, whose B loader unpacks each stage of the
// code tile (128 rows x 8 dims) with shift/mask straight into shared memory:
// once per tile, not once per query. Templated on BITS in {1, 2, 4, 8}.
// Only the first D unpacked codes count (D <= P * 8/BITS); ragged Q, C and D
// are masked in-kernel.
//
// rabitq_gather_distance replaces rabitq_gather_distance_pallas
// (rabitq_kernel.py:97): per query, K candidate code rows already gathered
// into a contiguous (Q, K, P) buffer with their (Q, K) metadata, as the JAX
// kernel takes them. Bound: bytes, P + 8 B read and 4 B written per
// candidate against 2D flops. Design: #3's (rabitq_search_step.cu) body
// without its gather and mask — one block per query, the query in shared
// memory zero-padded to P * 8/BITS dims, one warp per candidate through
// common.cuh's packed_dot (coalesced 32-bit words) and the same epilogue,
// so on the same rows both kernels round alike.

#include "tiled_product.cuh"

namespace {

using namespace jasper::tile;

// Unpacked codes of a (rows, p) packed table as the B operand: dims
// k..k+3 of row r, zero past d or the table's end.
template <int BITS>
struct CodeLoader {
  const uint8_t* __restrict__ packed;
  int rows, p, d, r0;
  __device__ __forceinline__ float4 operator()(int r, int k) const {
    constexpr int kCpb = 8 / BITS;
    constexpr unsigned kMask = (1u << BITS) - 1u;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const int row = r0 + r;
    if (row < rows) {
      const uint8_t* src = packed + static_cast<size_t>(row) * p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + j;
        if (kk < d)
          v[j] = static_cast<float>((__ldg(src + kk / kCpb) >> ((kk % kCpb) * BITS)) & kMask);
      }
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct EstimatorEpilogue {
  const float* __restrict__ add;       // (C,)
  const float* __restrict__ rescale;   // (C,)
  const float* __restrict__ qa;        // (Q,)
  const float* __restrict__ qsum;      // (Q,)
  __device__ __forceinline__ float operator()(int m, int n, float dot) const {
    return jasper::rabitq_epilogue(__ldg(add + n), __ldg(qa + m), __ldg(rescale + n), dot,
                                   __ldg(qsum + m));
  }
};

template <int BITS, bool VEC, bool VEC_OUT>
__global__ void __launch_bounds__(kThreads)
rabitq_distance_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ add,
                       const float* __restrict__ rescale, const float* __restrict__ q,
                       const float* __restrict__ qa, const float* __restrict__ qsum,
                       float* __restrict__ out, int nq, int nc, int p, int d) {
  __shared__ __align__(16) Stage st[2];
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float unused_a = 0.f, unused_b = 0.f;
  tile_product<VEC, false>(q, nq, d, m0, CodeLoader<BITS>{packed, nc, p, d, n0}, st, acc,
                           unused_a, unused_b);
  store_tile<VEC_OUT>(out, nq, nc, m0, n0, acc, EstimatorEpilogue{add, rescale, qa, qsum});
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
rabitq_gather_kernel(const uint8_t* __restrict__ cand, const float* __restrict__ add,
                     const float* __restrict__ rescale, const float* __restrict__ q, int d,
                     const float* __restrict__ qa, const float* __restrict__ qsum, int k, int p,
                     float* __restrict__ out) {
  extern __shared__ float sq[];  // p * 8/BITS floats, zero past d
  const int dq = p * (8 / BITS);
  const int qi = blockIdx.x;
  for (int i = threadIdx.x; i < dq; i += blockDim.x)
    sq[i] = i < d ? q[static_cast<size_t>(qi) * d + i] : 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float a = qa[qi];
  const float b = qsum[qi];
  for (int c = warp; c < k; c += n_warps) {
    const size_t e = static_cast<size_t>(qi) * k + c;
    float dot = jasper::packed_dot<BITS>(cand + e * p, p, sq, lane);
    dot = jasper::warp_sum(dot);
    if (lane == 0) out[e] = jasper::rabitq_epilogue(__ldg(add + e), a, __ldg(rescale + e), dot, b);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BITS>
int launch_all_pairs(const uint8_t* packed, const float* add, const float* rescale,
                     const float* q, const float* qa, const float* qsum, float* out, int nq,
                     int nc, int p, int d, cudaStream_t s) {
  const dim3 grid((nq + kBM - 1) / kBM, (nc + kBN - 1) / kBN);
  const bool vec = (d & 3) == 0 && aligned16(q);
  const bool vec_out = (nc & 3) == 0 && aligned16(out);
  if (vec && vec_out)
    rabitq_distance_kernel<BITS, true, true><<<grid, kThreads, 0, s>>>(
        packed, add, rescale, q, qa, qsum, out, nq, nc, p, d);
  else if (vec)
    rabitq_distance_kernel<BITS, true, false><<<grid, kThreads, 0, s>>>(
        packed, add, rescale, q, qa, qsum, out, nq, nc, p, d);
  else if (vec_out)
    rabitq_distance_kernel<BITS, false, true><<<grid, kThreads, 0, s>>>(
        packed, add, rescale, q, qa, qsum, out, nq, nc, p, d);
  else
    rabitq_distance_kernel<BITS, false, false><<<grid, kThreads, 0, s>>>(
        packed, add, rescale, q, qa, qsum, out, nq, nc, p, d);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGatherThreads = 256;

template <int BITS>
int launch_gather(const uint8_t* cand, const float* add, const float* rescale, const float* q,
                  int d, const float* qa, const float* qsum, float* out, int nq, int k, int p,
                  cudaStream_t s) {
  const size_t smem = static_cast<size_t>(p) * (8 / BITS) * sizeof(float);
  auto kern = rabitq_gather_kernel<BITS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<nq, kGatherThreads, smem, s>>>(cand, add, rescale, q, d, qa, qsum, k, p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rabitq_distance_launch(const uint8_t* packed, const float* data_add,
                                      const float* data_rescale, const float* q,
                                      const float* qa, const float* qsum, float* out, int nq,
                                      int nc, int p, int d, int bits, void* stream) {
  if ((nc + kBN - 1) / kBN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_all_pairs<1>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    case 2: return launch_all_pairs<2>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    case 4: return launch_all_pairs<4>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    case 8: return launch_all_pairs<8>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rabitq_gather_distance_launch(const uint8_t* cand, const float* cand_add,
                                             const float* cand_rescale, const float* q, int d,
                                             const float* qa, const float* qsum, float* out,
                                             int nq, int k, int p, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_gather<1>(cand, cand_add, cand_rescale, q, d, qa, qsum, out, nq, k, p, s);
    case 2: return launch_gather<2>(cand, cand_add, cand_rescale, q, d, qa, qsum, out, nq, k, p, s);
    case 4: return launch_gather<4>(cand, cand_add, cand_rescale, q, d, qa, qsum, out, nq, k, p, s);
    case 8: return launch_gather<8>(cand, cand_add, cand_rescale, q, d, qa, qsum, out, nq, k, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
