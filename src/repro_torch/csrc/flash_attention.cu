// flash_attention — GQA flash-attention forward (#10) and the same forward
// writing the row log-sum-exp (#11), from one template per element type.
//
// Replaces: flash_attention_pallas (repro/kernels/flash_attention/
// flash_kernel.py:83) and flash_attention_fwd_pallas (:257), which the
// model reaches through repro/models/attention.py:140 when
// cfg.use_flash_kernel is set: every full-sequence attention of forward
// and prefill. On the serving path (starcoder2-7b) H = 36 query heads
// share Hk = 4 KV heads (a group of 9), Dh = 128; on the training path
// (minicpm-2b) 36/36, Dh = 64; stablelm-3b has 32/32, Dh = 80. Causal,
// bf16.
//
// What it computes is the Pallas kernel's (flash_kernel.py:36-80):
// s = dot(q, k) in f32, times Dh^-0.5 after the dot; masked scores
// (causal k_pos <= q_pos, window k_pos > q_pos - window, q_pos = row +
// q_offset) are -1e30 and the running max starts at -1e30; l sums the f32
// p; the PV product takes p rounded to the value type, f32 accumulation;
// o = acc / max(l, 1e-30) in the input type; lse = m + log(max(l, 1e-30)).
// A key past Skv is no key at all (-inf: p = 0 exactly), so ragged Sq and
// Skv need no padding. #11 is #10 plus the lse store: its o is #10's bit
// for bit.
//
// Tiles that are masked for every row of the block are skipped: those
// above the causal diagonal and those wholly before the window. That is
// exact: before a row's first visible key its m stays -1e30 and each
// masked score adds p = 1, and the first visible score multiplies l and
// acc by exp(-1e30 - m) = 0; after it, a masked score adds exp(-1e30 - m)
// = 0. A row that sees no key at all (possible only with q_offset or a
// window placing it past the keys) averages every masked key, as the TPU
// kernel does; a block holding such a row therefore skips nothing.
//
// Bound on the H100: operations. One call does 4*B*H*Sq*Skv*Dh/2 flops
// (causal) on B*(Sq*H + 2*Skv*Hk)*Dh elements: hundreds of flops per byte,
// so the bf16 tensor rate is the limit.
//
// bf16 (flash_fwd_bf16_kernel): FlashAttention-2's shape on mma.sync
// tensor cores. One block per (16 x warps query rows, query head, batch),
// the heaviest causal tiles launched first: 8 warps (128 rows) at Dh 128,
// 4 warps (64 rows) below — on the H100, 8 warps were the faster choice at
// Dh 128 and the slower one at Dh 64 and 80. The block's Q
// tile is copied in once and each warp keeps its A fragments in
// registers. K/V tiles of 64 keys go through a two-stage cp.async ring,
// the next tile's copies in flight while this one is computed. Per tile,
// a warp computes S = Q.K^T (K through ldmatrix) into f32 accumulators,
// scales and masks it, runs the online softmax in registers (a row lives
// on the 4 lanes of a quad: max and sum are two shuffles), rounds p to
// bf16 straight into the A fragments of P.V (no round trip through shared
// memory) and adds P.V (V through ldmatrix.trans). The masks are applied
// only on tiles that cross the diagonal, the window's edge or Skv. o is
// written through shared memory in 16-byte stores. Shared rows are Dh + 8
// elements (an odd number of 16-byte chunks: no ldmatrix bank
// conflicts); Dh = 128 needs 102 KB (Q of 128 rows, two K/V stages).
//
// float32 (flash_fwd_kernel, SIMT FMAs, no tensor cores): one
// block per (64 query rows, head, batch), 256 threads as 16 x 16, Q, one
// K/V tile and the 64 x 64 probability tile in shared memory; thread
// (ty, tx) owns rows 4ty..4ty+3, score columns tx + 16j and output columns
// tx + 16e. Rows of Dh + 2 elements (an odd number of 8-byte pairs).
// Nothing on the serving or training path runs float32 attention; the
// card checks hold it to the plain version at rtol 1e-4.
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, h, hk, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Does the query at absolute position pos see at least one key?
__device__ __forceinline__ bool sees_a_key(const Params& p, int pos) {
  const int lo = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  const int hi = p.causal ? min(p.skv - 1, pos) : p.skv - 1;
  return lo <= hi;
}

template <typename T, int kDh, bool kLse>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kStride = kDh + 2;
  constexpr int kPStride = kKeys + 1;
  constexpr int kE = kDh / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kRows * kStride;
  T* vs = ks + kKeys * kStride;
  float* ps = reinterpret_cast<float*>(vs + kKeys * kStride);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.hk);
  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;

  stage<T, kDh>(qs, qg, p.q_ss, q0, p.sq);

  // KV tiles to visit. Emptiness of a row's visible range happens only at
  // the ends (pos < 0 when causal; pos past Skv + window - 1 with a
  // window), so the first and last rows of the block decide it.
  const int nkt = (p.skv + kKeys - 1) / kKeys;
  const int pos_lo = q0 + p.q_offset;
  const int pos_hi = min(q0 + kRows, p.sq) - 1 + p.q_offset;
  int kt_begin = 0, kt_end = nkt;
  if (sees_a_key(p, pos_lo) && sees_a_key(p, pos_hi)) {
    if (p.causal) kt_end = min(nkt, pos_hi / kKeys + 1);
    if (p.window > 0) kt_begin = max(0, (pos_lo - p.window + 1) / kKeys);
  }

  float m[4], l[4], acc[4][kE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[i][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    stage<T, kDh>(ks, kg, p.k_ss, k0, p.skv);
    stage<T, kDh>(vs, vg, p.v_ss, k0, p.skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load2(qs + (ty * 4 + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load2(ks + (tx + 16 * j) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }

    // scale, mask, online softmax; p (rounded to T) into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + ty * 4 + i + p.q_offset;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (kp >= p.skv)
          x = -INFINITY;
        else if ((p.causal && kp > pos) || (p.window > 0 && kp <= pos - p.window))
          x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        ps[(ty * 4 + i) * kPStride + tx + 16 * j] = round_to<T>(pj);
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPStride + c];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float vv = to_f32(vs[c * kStride + tx + 16 * e]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* og = static_cast<T*>(p.o) + ((static_cast<long long>(bb) * p.sq + r) * p.h + hh) * kDh;
#pragma unroll
    for (int e = 0; e < kE; ++e) og[tx + 16 * e] = from_f32<T>(acc[i][e] / lf);
    if (kLse && tx == 0)
      p.lse[(static_cast<long long>(bb) * p.h + hh) * p.sq + r] = m[i] + logf(lf);
  }
}

// Warps of a forward block (16 query rows each): 8 at Dh 128, where they
// halve the K/V traffic per row; 4 below, where 8 were slower.
template <int kDh>
struct Fwd {
  static constexpr int kWarps = kDh >= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockM = 16 * kWarps;  // query rows a block
};

template <int kDh, bool kLse>
__global__ void __launch_bounds__(Fwd<kDh>::kThreads) flash_fwd_bf16_kernel(const Params p) {
  using L = Tile<kDh>;
  constexpr int kStride = L::kStride;
  constexpr int kBlockM = Fwd<kDh>::kBlockM;
  constexpr int kThreadCount = Fwd<kDh>::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + kBlockM * kStride;  // stage s: K at ring + 2 s kElems, then V

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.hk);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + bb * p.v_sb + kvh * p.v_sh;

  const int nkt = (p.skv + kKeys - 1) / kKeys;
  const int pos_lo = q0 + p.q_offset;
  const int pos_hi = min(q0 + kBlockM, p.sq) - 1 + p.q_offset;
  int kt_begin = 0, kt_end = nkt;
  if (sees_a_key(p, pos_lo) && sees_a_key(p, pos_hi)) {
    if (p.causal) kt_end = min(nkt, pos_hi / kKeys + 1);
    if (p.window > 0) kt_begin = max(0, (pos_lo - p.window + 1) / kKeys);
  }

  load_tile<kDh, kBlockM>(qs, qg, p.q_ss, q0, p.sq, kThreadCount);
  cp_async_commit();
  if (kt_begin < kt_end) {
    load_tile<kDh, kKeys>(ring, kg, p.k_ss, kt_begin * kKeys, p.skv, kThreadCount);
    load_tile<kDh, kKeys>(ring + L::kElems, vg, p.v_ss, kt_begin * kKeys, p.skv, kThreadCount);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  __nv_bfloat16* qrows = qs + warp * 16 * kStride;
  unsigned qf[L::kK][4];
#pragma unroll
  for (int kc = 0; kc < L::kK; ++kc) load_a<kStride>(qf[kc], qrows, kc);

  // position of this thread's first row (g of the warp's 16; g + 8 is
  // the second)
  const int pos0 = q0 + warp * 16 + g + p.q_offset;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[L::kN][4];
#pragma unroll
  for (int nt = 0; nt < L::kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __nv_bfloat16* ks = ring + ((kt - kt_begin) & 1) * 2 * L::kElems;
    __nv_bfloat16* vs = ks + L::kElems;
    if (kt + 1 < kt_end) {
      __nv_bfloat16* nks = ring + ((kt + 1 - kt_begin) & 1) * 2 * L::kElems;
      load_tile<kDh, kKeys>(nks, kg, p.k_ss, (kt + 1) * kKeys, p.skv, kThreadCount);
      load_tile<kDh, kKeys>(nks + L::kElems, vg, p.v_ss, (kt + 1) * kKeys, p.skv, kThreadCount);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < L::kK; ++kc)
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        unsigned b[4];
        load_b<kStride>(b, ks, n2, kc);
        mma_bf16(s[2 * n2], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qf[kc], b[2], b[3]);
      }

    // scale; mask only a tile that crosses the diagonal, the window's
    // edge or Skv (block-uniform)
    const int k0 = kt * kKeys;
    const bool masked = k0 + kKeys > p.skv || (p.causal && k0 + kKeys - 1 > pos_lo) ||
                        (p.window > 0 && k0 <= pos_hi - p.window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale;
        if (masked) {
          const int kp = k0 + nt * 8 + 2 * t + (e & 1);
          const int pos = pos0 + (e >> 1) * 8;
          if (kp >= p.skv)
            x = -INFINITY;
          else if ((p.causal && kp > pos) || (p.window > 0 && kp <= pos - p.window))
            x = kNeg;
        }
        s[nt][e] = x;
      }

    // online softmax; s becomes p (f32) in place
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNeg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          rs += s[nt][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int nt = 0; nt < L::kN; ++nt) {
        acc[nt][2 * r] *= corr;
        acc[nt][2 * r + 1] *= corr;
      }
      m[r] = m_new;
    }

    // O += round_bf16(P).V: two n-tiles of p are one A fragment
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < L::kK; ++n2) {
        unsigned b[4];
        load_b_trans<kStride>(b, vs, n2, kc);
        mma_bf16(acc[2 * n2], a, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  const float lf0 = fmaxf(l[0], 1e-30f), lf1 = fmaxf(l[1], 1e-30f);
  const int row0 = q0 + warp * 16;
  store_rows<kDh>(acc, lf0, lf1, qrows,
                  static_cast<__nv_bfloat16*>(p.o) +
                      (static_cast<long long>(bb) * p.sq * p.h + hh) * kDh,
                  static_cast<long long>(p.h) * kDh, row0, p.sq);
  if (kLse && t == 0) {
    float* lse = p.lse + (static_cast<long long>(bb) * p.h + hh) * p.sq;
    if (row0 + g < p.sq) lse[row0 + g] = m[0] + logf(lf0);
    if (row0 + g + 8 < p.sq) lse[row0 + g + 8] = m[1] + logf(lf1);
  }
}

template <int kDh, bool kLse>
int launch_bf16(const Params& p, cudaStream_t stream) {
  // the Q tile and two stages of K and V
  constexpr int kBlockM = Fwd<kDh>::kBlockM;
  constexpr size_t smem =
      static_cast<size_t>(kBlockM + 4 * kKeys) * Tile<kDh>::kStride * sizeof(__nv_bfloat16);
  auto kern = flash_fwd_bf16_kernel<kDh, kLse>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.h, p.b);
  kern<<<grid, Fwd<kDh>::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kDh, bool kLse>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kRows + 2 * kKeys) * (kDh + 2) * sizeof(T) +
                          static_cast<size_t>(kRows) * (kKeys + 1) * sizeof(float);
  auto kern = flash_fwd_kernel<T, kDh, kLse>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.sq + kRows - 1) / kRows, p.h, p.b);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLse>
int dispatch_f32(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<float, 32, kLse>(p, s);
    case 64: return launch<float, 64, kLse>(p, s);
    case 80: return launch<float, 80, kLse>(p, s);
    case 128: return launch<float, 128, kLse>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kLse>
int dispatch_bf16(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_bf16<32, kLse>(p, s);
    case 64: return launch_bf16<64, kLse>(p, s);
    case 80: return launch_bf16<80, kLse>(p, s);
    case 128: return launch_bf16<128, kLse>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel); dh one of 32, 64, 80, 128. Strides are in elements; the last
// dimension is contiguous and o is a contiguous (B, Sq, H, Dh) tensor. For
// bf16 every row must start 16-byte aligned (the base pointers aligned,
// the batch, sequence and head strides multiples of 8 elements).
// lse (B, H, Sq) float32 is written when it is not null (#11). scale is
// Dh^-0.5 rounded to float32 by the caller, as the plain version uses it.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int dtype, int dh, int b, int h, int hk,
                                      int sq, int skv, long long q_sb, long long q_ss,
                                      long long q_sh, long long k_sb, long long k_ss,
                                      long long k_sh, long long v_sb, long long v_ss,
                                      long long v_sh, int causal, int window, int q_offset,
                                      float scale, void* stream) {
  if (b <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 || skv <= 0 || b > 65535 ||
      h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    lse,  b,    h,      hk,     sq,       skv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh,     causal,
           window, q_offset, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return lse ? dispatch_f32<true>(p, dh, s) : dispatch_f32<false>(p, dh, s);
  if (dtype == 1) return lse ? dispatch_bf16<true>(p, dh, s) : dispatch_bf16<false>(p, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
