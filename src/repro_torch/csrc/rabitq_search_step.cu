// rabitq_search_step — RaBitQ estimated distances of a hop's candidates,
// with the beam-search masking fused into the epilogue.
//
// Replaces: rabitq_search_step_pallas (repro/kernels/rabitq_dot/
// rabitq_kernel.py:131) together with the packed-row gather of its
// scorer (repro/kernels/rabitq_dot/ops.py:152-169), which gathered codes,
// metadata, tombstone bits and label rows into (Q, K, ...) buffers first.
//
// Bound on the H100: bytes. Per candidate it must read its id (4 B), its
// packed code row (P = D*bits/8 B: 64 B at D=128, 4 bits), two metadata
// floats (8 B), and write one float (4 B) — 80 B against 2*D flops. Every
// read is a gather of a short row, so the achieved rate is set by how
// many rows are in flight at once.
//
// Design: one block per query with the rotated query in shared memory;
// one warp per candidate. The warp reads the packed row as coalesced
// 32-bit words (16 lanes x 4 B at 64 B), unpacks BITS-wide little-endian
// fields with shift/mask, takes the dot with q_rot from shared memory and
// reduces by shuffle. Invalid candidates (id < 0, id >= n_valid,
// tombstoned, out of filter) never load their code row and get +inf.
// out = max(add + qa + rescale * (dot - qsum), 0) otherwise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int BITS, bool USE_TOMB, bool USE_FILT>
__global__ void __launch_bounds__(kThreads)
rabitq_search_step_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ packed,
                          const float* __restrict__ data_add,
                          const float* __restrict__ data_rescale, int k, int p, int n,
                          const uint8_t* __restrict__ tomb, const uint32_t* __restrict__ labels,
                          uint32_t fb, const float* __restrict__ q, int dq,
                          const float* __restrict__ qa, const float* __restrict__ qsum,
                          int n_valid, float* __restrict__ out) {
  extern __shared__ float sq[];  // dq floats
  const int qi = blockIdx.x;
  for (int i = threadIdx.x; i < dq; i += blockDim.x) sq[i] = q[static_cast<size_t>(qi) * dq + i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float a = qa[qi];
  const float b = qsum[qi];

  for (int c = warp; c < k; c += n_warps) {
    const int id = ids[static_cast<size_t>(qi) * k + c];
    bool valid = id >= 0 && id < n_valid && id < n;
    if (USE_TOMB && valid) valid = ((tomb[id >> 3] >> (id & 7)) & 1) == 0;
    if (USE_FILT && valid) valid = (labels[id] & fb) != 0;
    float dist = INFINITY;
    if (valid) {  // uniform across the warp
      float dot = jasper::packed_dot<BITS>(packed + static_cast<size_t>(id) * p, p, sq, lane);
      dot = jasper::warp_sum(dot);
      dist = jasper::rabitq_epilogue(__ldg(data_add + id), a, __ldg(data_rescale + id), dot, b);
    }
    if (lane == 0) out[static_cast<size_t>(qi) * k + c] = dist;
  }
}

template <int BITS, bool USE_TOMB, bool USE_FILT>
int launch(const int32_t* ids, const uint8_t* packed, const float* add, const float* rescale,
           int num_q, int k, int p, int n, const uint8_t* tomb, const uint32_t* labels,
           uint32_t fb, const float* q, const float* qa, const float* qsum, int n_valid,
           float* out, cudaStream_t stream) {
  const int dq = p * (8 / BITS);
  const size_t smem = static_cast<size_t>(dq) * sizeof(float);
  auto kern = rabitq_search_step_kernel<BITS, USE_TOMB, USE_FILT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<num_q, kThreads, smem, stream>>>(ids, packed, add, rescale, k, p, n, tomb, labels, fb,
                                          q, dq, qa, qsum, n_valid, out);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int dispatch_masks(const int32_t* ids, const uint8_t* packed, const float* add,
                   const float* rescale, int num_q, int k, int p, int n, const uint8_t* tomb,
                   const uint32_t* labels, uint32_t fb, const float* q, const float* qa,
                   const float* qsum, int n_valid, float* out, cudaStream_t s) {
  if (tomb && labels)
    return launch<BITS, true, true>(ids, packed, add, rescale, num_q, k, p, n, tomb, labels, fb,
                                    q, qa, qsum, n_valid, out, s);
  if (tomb)
    return launch<BITS, true, false>(ids, packed, add, rescale, num_q, k, p, n, tomb, labels,
                                     fb, q, qa, qsum, n_valid, out, s);
  if (labels)
    return launch<BITS, false, true>(ids, packed, add, rescale, num_q, k, p, n, tomb, labels,
                                     fb, q, qa, qsum, n_valid, out, s);
  return launch<BITS, false, false>(ids, packed, add, rescale, num_q, k, p, n, tomb, labels, fb,
                                    q, qa, qsum, n_valid, out, s);
}

}  // namespace

extern "C" int rabitq_search_step_launch(const int32_t* ids, const uint8_t* packed,
                                         const float* data_add, const float* data_rescale,
                                         int num_q, int k, int p, int n, const uint8_t* tomb,
                                         const uint32_t* labels, uint32_t fb, const float* q,
                                         const float* qa, const float* qsum, int n_valid,
                                         int bits, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1:
      return dispatch_masks<1>(ids, packed, data_add, data_rescale, num_q, k, p, n, tomb,
                               labels, fb, q, qa, qsum, n_valid, out, s);
    case 2:
      return dispatch_masks<2>(ids, packed, data_add, data_rescale, num_q, k, p, n, tomb,
                               labels, fb, q, qa, qsum, n_valid, out, s);
    case 4:
      return dispatch_masks<4>(ids, packed, data_add, data_rescale, num_q, k, p, n, tomb,
                               labels, fb, q, qa, qsum, n_valid, out, s);
    case 8:
      return dispatch_masks<8>(ids, packed, data_add, data_rescale, num_q, k, p, n, tomb,
                               labels, fb, q, qa, qsum, n_valid, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
