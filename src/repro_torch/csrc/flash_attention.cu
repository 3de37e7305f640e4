// flash_attention — GQA flash-attention forward (#10) and the same forward
// writing the row log-sum-exp (#11), from one template.
//
// Replaces: flash_attention_pallas (repro/kernels/flash_attention/
// flash_kernel.py:83) and flash_attention_fwd_pallas (:257), which the
// model reaches through repro/models/attention.py:140 when
// cfg.use_flash_kernel is set: every full-sequence attention of forward
// and prefill. On the main path (starcoder2-7b) H = 36 query heads share
// Hk = 4 KV heads (a group of 9), Dh = 128, causal, bf16.
//
// What it computes is the Pallas kernel's (flash_kernel.py:36-80):
// s = dot(q, k) in f32, times Dh^-0.5 after the dot; masked scores
// (causal k_pos <= q_pos, window k_pos > q_pos - window, q_pos = row +
// q_offset) are -1e30 and the running max starts at -1e30; l sums the f32
// p; the PV product takes p rounded to the value type, f32 accumulation;
// o = acc / max(l, 1e-30) in the input type; lse = m + log(max(l, 1e-30)).
// A key past Skv is no key at all (-inf: p = 0 exactly), so ragged Sq and
// Skv need no padding.
//
// Bound on the H100: operations. One call does 4*B*H*Sq*Skv*Dh/2 flops
// (causal) on B*(Sq*H + 2*Skv*Hk)*Dh elements: hundreds of flops per byte.
// This first kernel is plain SIMT f32 FMAs (no tensor cores): it stays
// far from the bf16 tensor rate the bound assumes. mma/wgmma, TMA and
// warp specialisation are later work.
//
// Design: one block per (tile of 64 query rows, query head, batch), 256
// threads as 16 x 16. The Q tile, one K/V tile of 64 keys and the 64 x 64
// probability tile sit in shared memory; scores, the running max m, the
// sum l and the output accumulator stay in f32 registers: thread (ty, tx)
// owns rows 4ty..4ty+3, the score columns tx + 16j (j < 4) and the output
// columns tx + 16e (e < Dh/16). Row max and row sum reduce over the 16
// lanes of a half-warp with shuffles. The KV head is h / (H / Hk).
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
// Shared-memory rows are Dh + 2 elements long, so a row is an odd number
// of 4-byte words (bf16) or of 8-byte pairs (f32): the 16 lanes reading
// the same column of 16 consecutive K rows hit 16 different banks.
// Dh = 128 needs 66.5 KB (bf16) or 116 KB (f32) of shared memory: above
// the default 48 KB, hence cudaFuncSetAttribute.

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

template <typename T, bool kLse>
int dispatch_dh(const Params& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32, kLse>(p, s);
    case 64: return launch<T, 64, kLse>(p, s);
    case 128: return launch<T, 128, kLse>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension is contiguous and o is a contiguous (B, Sq, H, Dh) tensor.
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
  if (dtype == 0)
    return lse ? dispatch_dh<float, true>(p, dh, s) : dispatch_dh<float, false>(p, dh, s);
  if (dtype == 1)
    return lse ? dispatch_dh<__nv_bfloat16, true>(p, dh, s)
               : dispatch_dh<__nv_bfloat16, false>(p, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
