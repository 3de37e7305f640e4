// pairwise_l2 — squared L2 distances of every (query, row) pair, float32:
//
//   out[q, c] = max((|q|^2 - 2 q.x_c) + |x_c|^2, 0)
//
// Replaces: pairwise_l2_pallas (repro/kernels/distance/distance_kernel.py:58),
// an (nQ, nC, nD)-tiled MXU product with a D-axis accumulator in VMEM and the
// |q|^2 - 2 q.x + |x|^2 epilogue; its wrapper padded every axis to a tile
// multiple and computed both norm vectors in XLA before the call.
//
// Bound on the H100: bytes. At (Q, C, D) = (10,000, 131,072, 128) the
// (Q, C) output is 5.24 GB, 1.565 ms at 3.35 TB/s (with the 72 MB of inputs
// 1.587 ms). The products run on the tensor cores at the bf16 rate, 989
// TFLOP/s, as many products of parts (below) as the operands need: one on
// integer operands, 2QCD = 3.36e11 flop in 0.34 ms; three for real queries
// against integer rows (1.02 ms); six for real x real (2.04 ms, then the
// operations bound it). As float32 FMAs outside the tensor cores, the
// bound of the SIMT kernel this one replaces, one product is 5.0 ms at 67
// TFLOP/s.
//
// Design: the products on the tensor cores, exactly. A float32 value
// splits exactly into three bf16 parts, v = h0 + h1 + h2 (bf16_split.cuh),
// so q.x is the sum of the products q_i . x_j of parts, each exact in
// float32, on mma.sync m16n8k16 (bf16 in, f32 accumulate). A block computes
// a 128-query x 128-row tile, 8 warps of 32 x 64, over k-chunks of 32
// dims. Both operands' floats arrive by 16-byte cp.async, two chunks in
// flight; each thread writes h0 of the values it staged and adds their
// squares into its rows' norms, from the floats, then the block votes (a
// warp OR, one shared atomicOr a warp) on whether either operand's chunk
// holds a value that is not a bf16 value. Only then are the voted parts
// written, h2 and then h1 through one more buffer an operand, and only then
// are their products taken: a chunk of integers of magnitude <= 256
// (bigann's rows and the exact scan's queries) or of bf16 inputs takes one
// product a k-step, h0 . h0; real queries against integer rows take three;
// real x real takes the six with i + j <= 2. The three left out, h1 . h2,
// h2 . h1 and h2 . h2, are below 2^-24 of |q_k x_k| each, under float32's
// rounding of the sum. A part that was not taken is zero in the whole
// chunk, so leaving its products out adds nothing: the sum is the same bit
// for bit. Products go finest first (i + j = 2: (2, 0), (0, 2), (1, 1);
// then (1, 0), (0, 1); then (0, 0)), each over the chunk's two k-steps.
// On integer operands every product and partial sum, and each norm, is an
// integer below 2^24 (128 * 255^2 < 2^24), exact in any order: the result
// is the plain version's bit for bit. The epilogue applies
// max((|q|^2 - 2 q.x) + |x|^2, 0) on the way from the accumulators into a
// padded slice of shared memory a warp (the parts and float chunks are
// free by then), and 16-byte streaming stores write whole rows from there,
// two 256-byte row spans a warp store: the output leaves in whole lines.
// 107,536 B of shared memory a block and at most 128 registers a thread:
// two blocks an SM, one storing while the other multiplies. Grid x runs
// over query tiles, so the blocks in flight share a row tile in L2. Ragged
// Q, C and D are masked in-kernel: nothing is padded.

#include "bf16_split.cuh"

namespace {

constexpr int kWM = 4;              // warps along the queries (32 queries each)
constexpr int kWN = 2;              // warps along the rows (64 rows each)
constexpr int kStages = 2;          // float chunks in flight
constexpr int kThreads = 32 * kWM * kWN;
constexpr int kBM = 32 * kWM;       // queries a block tile
constexpr int kBN = 64 * kWN;       // table rows a block tile
constexpr int kKC = 32;             // dims a k-chunk: two mma k-steps
constexpr int kStride = kKC + 8;    // bf16 a shared row: 5 units of 16 B
constexpr unsigned kPerRow = kKC / 4;               // float4s a staged row
constexpr int kRowStep = kThreads / kPerRow;        // rows between a thread's float4s
constexpr int kQEach = kBM / kRowStep;              // query rows a thread stages
constexpr int kXEach = kBN / kRowStep;              // table rows a thread stages

// Shared memory of a block, byte offsets: each operand's h0 and one more
// part (h2, then h1, when a chunk votes for them); kStages float chunks of
// both operands (the next ones arriving by cp.async while this one is
// multiplied); the tile's squared norms; two vote words.
constexpr int kA = kBM * kStride * 2;                // one part of the query tile
constexpr int kB = kBN * kStride * 2;                // one part of the row tile
constexpr int kChunkFloats = (kBM + kBN) * kKC;
constexpr int kFloats = 2 * (kA + kB);               // the float chunks' offset
constexpr int kNorms = kFloats + kStages * kChunkFloats * 4;
constexpr int kVote = kNorms + (kBM + kBN) * 4;
constexpr int kSmem = kVote + 16;
// the epilogue's slices, 32 rows of 64 + 4 floats a warp, reuse the parts
// and the float chunks
constexpr int kSliceLd = 64 + 4;
static_assert(kThreads / 32 * 32 * kSliceLd * 4 <= kNorms, "epilogue slices past the chunks");

using bf16 = __nv_bfloat16;

// h0 of the staged chunk of one operand (kEach rows a thread, [row][dim]),
// its squares added into the thread's norms; returns the OR of the
// remainders' bits (0 iff every value is a bf16 value).
template <int kEach>
__device__ __forceinline__ unsigned head_part(bf16* part, const float* fs, float (&norm)[kEach]) {
  unsigned rest = 0;
#pragma unroll
  for (int j = 0; j < kEach; ++j) {
    const unsigned f = threadIdx.x + kThreads * j;
    const int r = f / kPerRow;
    const int c = 4 * (f % kPerRow);
    const float4 v = *reinterpret_cast<const float4*>(fs + r * kKC + c);
    norm[j] = fmaf(v.x, v.x, norm[j]);
    norm[j] = fmaf(v.y, v.y, norm[j]);
    norm[j] = fmaf(v.z, v.z, norm[j]);
    norm[j] = fmaf(v.w, v.w, norm[j]);
    *reinterpret_cast<uint2*>(part + r * kStride + c) = jasper::bf16_head4(v, rest);
  }
  return rest;
}

// Part p (1 or 2) of the staged chunk of one operand.
template <int kEach>
__device__ __forceinline__ void tail_part(bf16* part, const float* fs, int p) {
#pragma unroll
  for (int j = 0; j < kEach; ++j) {
    const unsigned f = threadIdx.x + kThreads * j;
    const int r = f / kPerRow;
    const int c = 4 * (f % kPerRow);
    uint2 h[3];
    jasper::bf16_split4(*reinterpret_cast<const float4*>(fs + r * kKC + c), h);
    *reinterpret_cast<uint2*>(part + r * kStride + c) = p == 1 ? h[1] : h[2];
  }
}

// acc += one product of parts, a (the warp's 32 queries) . b (its 64
// rows), over the chunk's two k-steps.
__device__ __forceinline__ void multiply(float (&acc)[2][8][4], const bf16* a_part,
                                         const bf16* b_part, int wm, int wn) {
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    unsigned a[2][4], b[4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      flash::load_a<kStride>(a[mt], a_part + (32 * wm + 16 * mt) * kStride, ks);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2)
      flash::load_b<kStride>(b[n2], b_part + 64 * wn * kStride, n2, ks);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        jasper::mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                         b[nt >> 1][2 * (nt & 1) + 1]);
  }
}

__device__ __forceinline__ void stage_chunk(float* fs, const float* __restrict__ q,
                                            const float* __restrict__ x, int nq, int nc, int d,
                                            int m0, int n0, int k0, int vec_q, int vec_x) {
  jasper::stage_floats<kBM, kKC, kThreads>(fs, q, nq, d, m0, k0, vec_q);
  jasper::stage_floats<kBN, kKC, kThreads>(fs + kBM * kKC, x, nc, d, n0, k0, vec_x);
}

// The kPerRow threads of a staged row hold its partial norms: their sums
// into the tile's norms in shared memory.
template <int kEach>
__device__ __forceinline__ void store_norms(float (&norm)[kEach], float* sq) {
#pragma unroll
  for (int j = 0; j < kEach; ++j) {
#pragma unroll
    for (unsigned off = 1; off < kPerRow; off <<= 1)
      norm[j] += __shfl_xor_sync(jasper::kFullMask, norm[j], off);
    if (threadIdx.x % kPerRow == 0) sq[threadIdx.x / kPerRow + kRowStep * j] = norm[j];
  }
}

// The warp's 32 x 64 distances through its own padded slice of shared
// memory (the epilogue applied on the way in), then out as whole rows: a
// 16-byte streaming store a lane writes two 256-byte row spans.
__device__ __forceinline__ void store_tile(const float (&acc)[2][8][4], const float* qsq,
                                           const float* xsq, float* slice, float* __restrict__ out,
                                           int nq, int nc, int m0, int n0, int wm, int wn,
                                           int vec_out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = 16 * mt + g;
    const float qa = qsq[32 * wm + r0];
    const float qb = qsq[32 * wm + r0 + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c0 = 8 * nt + 2 * t4;
      const float2 xs = *reinterpret_cast<const float2*>(xsq + 64 * wn + c0);
      const float* c = acc[mt][nt];
      *reinterpret_cast<float2*>(slice + r0 * kSliceLd + c0) =
          make_float2(jasper::l2_epilogue(qa, c[0], xs.x), jasper::l2_epilogue(qa, c[1], xs.y));
      *reinterpret_cast<float2*>(slice + (r0 + 8) * kSliceLd + c0) =
          make_float2(jasper::l2_epilogue(qb, c[2], xs.x), jasper::l2_epilogue(qb, c[3], xs.y));
    }
  }
  __syncwarp();
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int r = 2 * it + (lane >> 4);
    const int c4 = 4 * (lane & 15);
    const int m = m0 + 32 * wm + r;
    const int n = n0 + 64 * wn + c4;
    if (m >= nq) continue;
    const float4 v = *reinterpret_cast<const float4*>(slice + r * kSliceLd + c4);
    float* row = out + static_cast<size_t>(m) * nc + n;
    if (vec_out) {
      if (n < nc) __stcs(reinterpret_cast<float4*>(row), v);
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < nc) row[j] = e[j];
    }
  }
}

// A block computes one output tile. Per chunk: two barriers (five when a
// chunk votes for more parts than h0), the next kStages chunks' copies in
// flight; then the norms, and each warp's epilogue through its slice.
__global__ void __launch_bounds__(kThreads, 2)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int nq, int nc, int d, int vec_q, int vec_x,
                   int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* A0 = reinterpret_cast<bf16*>(smem);
  bf16* Ax = A0 + kBM * kStride;
  bf16* B0 = Ax + kBM * kStride;
  bf16* Bx = B0 + kBN * kStride;
  float* floats = reinterpret_cast<float*>(smem + kFloats);
  float* qsq = reinterpret_cast<float*>(smem + kNorms);
  float* xsq = qsq + kBM;
  unsigned* vote = reinterpret_cast<unsigned*>(smem + kVote);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWN;  // queries 32 wm .. of the tile
  const int wn = warp % kWN;  // rows 64 wn .. of the tile
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = d > kKC ? (d + kKC - 1) / kKC : 1;

  if (threadIdx.x < 2) vote[threadIdx.x] = 0;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < chunks)
      stage_chunk(floats + s * kChunkFloats, q, x, nq, nc, d, m0, n0, s * kKC, vec_q, vec_x);
    jasper::cp_async_commit();
  }
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float qn[kQEach], xn[kXEach];
#pragma unroll
  for (int j = 0; j < kQEach; ++j) qn[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kXEach; ++j) xn[j] = 0.f;

  for (int kc = 0; kc < chunks; ++kc) {
    jasper::cp_async_wait<kStages - 1>();
    __syncthreads();  // chunk kc staged; every warp done with chunk kc - 1's parts
    float* qf = floats + (kc % kStages) * kChunkFloats;
    float* xf = qf + kBM * kKC;
    const unsigned rest_q = head_part(A0, qf, qn);
    const unsigned rest_x = head_part(B0, xf, xn);
    const unsigned w =
        __reduce_or_sync(jasper::kFullMask, (rest_q != 0 ? 1u : 0u) | (rest_x != 0 ? 2u : 0u));
    if (lane == 0 && w != 0) atomicOr(vote + (kc & 1), w);
    __syncthreads();  // h0 of both operands written, the votes in
    const unsigned v = vote[kc & 1];
    if (threadIdx.x == 0) vote[(kc + 1) & 1] = 0;  // read by all before this chunk's first barrier
    if (v != 0) {
      // the voted parts through the second buffers, finest products first:
      // (2, 0) and (0, 2), then (1, 1), (1, 0) and (0, 1)
      if (v & 1u) tail_part<kQEach>(Ax, qf, 2);
      if (v & 2u) tail_part<kXEach>(Bx, xf, 2);
      __syncthreads();
      if (v & 1u) multiply(acc, Ax, B0, wm, wn);
      if (v & 2u) multiply(acc, A0, Bx, wm, wn);
      __syncthreads();
      if (v & 1u) tail_part<kQEach>(Ax, qf, 1);
      if (v & 2u) tail_part<kXEach>(Bx, xf, 1);
      __syncthreads();
      if (v == 3u) multiply(acc, Ax, Bx, wm, wn);
      if (v & 1u) multiply(acc, Ax, B0, wm, wn);
      if (v & 2u) multiply(acc, A0, Bx, wm, wn);
    }
    // every thread has split its floats of chunk kc: chunk kc + kStages
    // takes their stage
    if (kc + kStages < chunks)
      stage_chunk(qf, q, x, nq, nc, d, m0, n0, (kc + kStages) * kKC, vec_q, vec_x);
    jasper::cp_async_commit();
    multiply(acc, A0, B0, wm, wn);
  }

  store_norms(qn, qsq);
  store_norms(xn, xsq);
  __syncthreads();  // the norms in; every warp done with the parts and floats, now its slices
  store_tile(acc, qsq, xsq, reinterpret_cast<float*>(smem) + warp * 32 * kSliceLd, out, nq, nc,
             m0, n0, wm, wn, vec_out);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      pairwise_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
}

}  // namespace

extern "C" int pairwise_l2_launch(const float* q, const float* x, float* out, int nq, int nc,
                                  int d, void* stream) {
  if ((nc + kBN - 1) / kBN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static jasper::PerDevice smem_set;
  const int attr = jasper::once_per_device(smem_set, set_smem);
  if (attr != 0) return attr;
  const dim3 grid((nq + kBM - 1) / kBM, (nc + kBN - 1) / kBN);
  const int vec_q = (d & 3) == 0 && aligned16(q);
  const int vec_x = (d & 3) == 0 && aligned16(x);
  const int vec_out = (nc & 3) == 0 && aligned16(out);
  pairwise_l2_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      q, x, out, nq, nc, d, vec_q, vec_x, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// registers a thread, resident blocks an SM, shared bytes a block and local
// (spilled) bytes a thread
extern "C" int pairwise_l2_occupancy(int* info) {
  int e = set_smem();
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, pairwise_l2_kernel));
  if (e != 0) return e;
  int blocks = 0;
  e = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pairwise_l2_kernel, kThreads, kSmem));
  info[0] = attr.numRegs;
  info[1] = blocks;
  info[2] = kSmem;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return e;
}
