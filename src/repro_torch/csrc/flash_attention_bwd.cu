// flash_attention_bwd — GQA flash-attention backward (#12): dq, then dk/dv.
//
// Replaces: flash_attention_bwd_pallas (repro/kernels/flash_attention/
// flash_kernel.py:302; the dq pallas_call at :315 with its body
// _flash_dq_kernel at :174-209, the dk/dv pallas_call at :345 with its body
// _flash_dkv_kernel at :212-254), the backward of the custom_vjp around the
// flash forward. The port reaches it through the torch.autograd.Function
// in kernels/flash_attention/ops.py whenever the model trains with
// use_flash_kernel: once per layer per microbatch. On the training path
// (minicpm-2b) H = Hk = 36, Dh = 64, causal, bf16.
//
// What it computes is the Pallas kernels' arithmetic. From q, k, v, dO,
// the forward's row log-sum-exp lse and delta = rowsum(dO * O) (f32, both
// (B, H, Sq); delta is computed by the wrapper, as the Pallas wrapper does
// at :313):
//   s  = dot(q, k) in f32, times Dh^-0.5 after the dot;
//   p  = visible ? exp(s - lse) : 0 (causal k_pos <= q_pos, window k_pos >
//        q_pos - window, q_pos = row + q_offset, and a key past Skv is no
//        key at all);
//   dp = dot(dO, v) in f32;  ds = p * (dp - delta) * Dh^-0.5;
//   dq = sum over keys of round_T(ds) * k           (:202-205)
//   dv = sum over rows of round_T(p) * dO           (:241-243)
//   dk = sum over rows of round_T(ds) * q, with ds from the unrounded p
//                                                    (:246-249)
// accumulated in f32 and written in the input type T. A row that sees no
// key gets p = 0 everywhere, so its dq is 0 and it adds nothing to dk and
// dv, as in the Pallas backward (which is not the autodiff of the forward
// there: the forward averages every masked key for such a row).
//
// Bound on the H100: operations. The dq pass does three products of
// B*H*Sq*Skv*Dh multiply-adds (halved when causal: s, dp, dq), the dk/dv
// pass four (s, dp, dv, dk): 7 products on B*(2*Sq*H + 2*Skv*Hk)*Dh
// elements in and as many out, hundreds of flops per byte. This first
// kernel is plain SIMT f32 FMAs (no tensor cores) like the forward: it
// stays far from the bf16 tensor rate the bound assumes. mma/wgmma, TMA
// and one pass computing s and dp once are later work.
//
// Design. The TPU kernels carry their accumulators in VMEM scratch along a
// sequential grid axis; here one block owns its output tile and loops over
// the other axis itself, accumulators in f32 registers, so no two blocks
// write one element: no atomics, deterministic results.
//   * dq: one block per (64 query rows, query head, batch), 256 threads as
//     16 x 16; Q and dO tiles, then each K/V tile, in shared memory. Thread
//     (ty, tx) computes s and dp for rows 4ty..4ty+3 and keys tx + 16j,
//     writes round_T(ds) to a shared 64 x 64 tile, then accumulates dq for
//     its rows and the columns tx + 16e.
//   * dk/dv: one block per (64 keys, KV head, batch). K and V stay in
//     shared memory; the block walks the group's query heads (outer) and
//     their query tiles (inner), the order of the Pallas `inner` grid axis
//     (:216-217), staging each Q/dO tile with its lse and delta. Thread
//     (ty, tx) computes s^T and dp^T for keys 4ty..4ty+3 and rows tx + 16j,
//     writes round_T(p^T) and round_T(ds^T) to two shared tiles, then
//     accumulates dv and dk for its keys and the columns tx + 16e. The
//     group sum stays inside the block: no cross-block reduction.
// A tile in which no (row, key) pair can be visible is skipped; in the
// backward that is always exact (p is 0 there). Shared memory at Dh = 128:
// dq 146 KB (f32) / 81 KB (bf16), dk/dv 163 KB / 98 KB, above the default
// 48 KB, hence cudaFuncSetAttribute.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;            // contiguous (B, Sq, H, Dh)
  void* dk;            // contiguous (B, Skv, Hk, Dh)
  void* dv;
  int b, h, hk, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int causal, window, q_offset;
  float scale;
};

// Does the query at absolute position pos see key kp?
__device__ __forceinline__ bool visible(const BwdParams& p, int pos, int kp) {
  return kp < p.skv && (!p.causal || kp <= pos) && (p.window <= 0 || kp > pos - p.window);
}

// Can any row of [r0, r1) see any key of [k0, k1)? (A tile for which this
// is false is skipped; a true answer may still leave every pair masked.)
__device__ __forceinline__ bool tile_may_see(const BwdParams& p, int r0, int r1, int k0, int k1) {
  const int pos_lo = r0 + p.q_offset;
  const int pos_hi = r1 - 1 + p.q_offset;
  if (p.causal && k0 > pos_hi) return false;
  if (p.window > 0 && k1 - 1 <= pos_lo - p.window) return false;
  return true;
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kStride = kDh + 2;
  constexpr int kSStride = kKeys + 1;
  constexpr int kE = kDh / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kRows * kStride;
  T* ks = dos + kRows * kStride;
  T* vs = ks + kKeys * kStride;
  float* dss = reinterpret_cast<float*>(vs + kKeys * kStride);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.hk);
  const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.sq;

  stage<T, kDh>(qs, qg, p.q_ss, q0, p.sq);
  stage<T, kDh>(dos, dog, p.do_ss, q0, p.sq);

  float lse[4], dlt[4], acc[4][kE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse[i] = r < p.sq ? p.lse[row_base + r] : 0.f;
    dlt[i] = r < p.sq ? p.delta[row_base + r] : 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[i][e] = 0.f;
  }

  const int r1 = min(q0 + kRows, p.sq);
  const int nkt = (p.skv + kKeys - 1) / kKeys;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kKeys;
    if (!tile_may_see(p, q0, r1, k0, min(k0 + kKeys, p.skv))) continue;  // block-uniform
    stage<T, kDh>(ks, kg, p.k_ss, k0, p.skv);
    stage<T, kDh>(vs, vg, p.v_ss, k0, p.skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kDh; d += 2) {
      float2 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = load2(qs + (ty * 4 + i) * kStride + d);
        ov[i] = load2(dos + (ty * 4 + i) * kStride + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = load2(ks + (tx + 16 * j) * kStride + d);
        vv[j] = load2(vs + (tx + 16 * j) * kStride + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
          dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float pij = 0.f;
        if (r < p.sq && visible(p, r + p.q_offset, kp))
          pij = expf(__fmul_rn(s[i][j], p.scale) - lse[i]);
        const float ds = pij * (dp[i][j] - dlt[i]) * p.scale;
        dss[(ty * 4 + i) * kSStride + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * kSStride + c];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float kk = to_f32(ks[c * kStride + tx + 16 * e]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(dsv[i], kk, acc[i][e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    T* out = static_cast<T*>(p.dq) + ((static_cast<long long>(bb) * p.sq + r) * p.h + hh) * kDh;
#pragma unroll
    for (int e = 0; e < kE; ++e) out[tx + 16 * e] = from_f32<T>(acc[i][e]);
  }
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int kStride = kDh + 2;
  constexpr int kSStride = kRows + 1;
  constexpr int kE = kDh / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kKeys * kStride;
  T* qs = vs + kKeys * kStride;
  T* dos = qs + kRows * kStride;
  float* pts = reinterpret_cast<float*>(dos + kRows * kStride);  // round_T(p^T)
  float* dsts = pts + kKeys * kSStride;                           // round_T(ds^T)
  float* lse_s = dsts + kKeys * kSStride;
  float* dlt_s = lse_s + kRows;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int g = p.h / p.hk;
  const int k1 = min(k0 + kKeys, p.skv);

  stage<T, kDh>(ks, static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
                p.skv);
  stage<T, kDh>(vs, static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
                p.skv);

  float dk[4][kE], dv[4][kE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int nqt = (p.sq + kRows - 1) / kRows;
  for (int gm = 0; gm < g; ++gm) {
    const int hh = kvh * g + gm;
    const T* qg = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
    const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.sq;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * kRows;
      if (!tile_may_see(p, q0, min(q0 + kRows, p.sq), k0, k1)) continue;  // block-uniform
      stage<T, kDh>(qs, qg, p.q_ss, q0, p.sq);
      stage<T, kDh>(dos, dog, p.do_ss, q0, p.sq);
      for (int i = threadIdx.x; i < kRows; i += kThreads) {
        const int r = q0 + i;
        lse_s[i] = r < p.sq ? p.lse[row_base + r] : 0.f;
        dlt_s[i] = r < p.sq ? p.delta[row_base + r] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < kDh; d += 2) {
        float2 kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = load2(ks + (ty * 4 + i) * kStride + d);
          vv[i] = load2(vs + (ty * 4 + i) * kStride + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = load2(qs + (tx + 16 * j) * kStride + d);
          ov[j] = load2(dos + (tx + 16 * j) * kStride + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i].x, qv[j].x, st[i][j]);
            st[i][j] = fmaf(kv[i].y, qv[j].y, st[i][j]);
            dpt[i][j] = fmaf(vv[i].x, ov[j].x, dpt[i][j]);
            dpt[i][j] = fmaf(vv[i].y, ov[j].y, dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int r = q0 + c;
          float pt = 0.f;
          if (r < p.sq && visible(p, r + p.q_offset, kp))
            pt = expf(__fmul_rn(st[i][j], p.scale) - lse_s[c]);
          const float ds = pt * (dpt[i][j] - dlt_s[c]) * p.scale;
          pts[(ty * 4 + i) * kSStride + c] = round_to<T>(pt);
          dsts[(ty * 4 + i) * kSStride + c] = round_to<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < kRows; ++c) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pts[(ty * 4 + i) * kSStride + c];
          sv[i] = dsts[(ty * 4 + i) * kSStride + c];
        }
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float ov = to_f32(dos[c * kStride + tx + 16 * e]);
          const float qv = to_f32(qs[c * kStride + tx + 16 * e]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][e] = fmaf(pv[i], ov, dv[i][e]);
            dk[i][e] = fmaf(sv[i], qv, dk[i][e]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= p.skv) continue;
    const long long off = ((static_cast<long long>(bb) * p.skv + kp) * p.hk + kvh) * kDh;
    T* dko = static_cast<T*>(p.dk) + off;
    T* dvo = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dko[tx + 16 * e] = from_f32<T>(dk[i][e]);
      dvo[tx + 16 * e] = from_f32<T>(dv[i][e]);
    }
  }
}

template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int kDh>
int launch(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t tiles = static_cast<size_t>(kRows + kKeys) * 2 * (kDh + 2) * sizeof(T);
  constexpr size_t smem_dq = tiles + static_cast<size_t>(kRows) * (kKeys + 1) * sizeof(float);
  constexpr size_t smem_dkv =
      tiles + (static_cast<size_t>(2) * kKeys * (kRows + 1) + 2 * kRows) * sizeof(float);
  auto dq_kern = flash_bwd_dq_kernel<T, kDh>;
  auto dkv_kern = flash_bwd_dkv_kernel<T, kDh>;
  int err = allow_smem(dq_kern, smem_dq);
  if (err) return err;
  err = allow_smem(dkv_kern, smem_dkv);
  if (err) return err;
  dq_kern<<<dim3((p.sq + kRows - 1) / kRows, p.h, p.b), kThreads, smem_dq, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkv_kern<<<dim3((p.skv + kKeys - 1) / kKeys, p.hk, p.b), kThreads, smem_dkv, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const BwdParams& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv all of it).
// Strides of q, k, v and dout are in elements, the last dimension
// contiguous; lse and delta are contiguous (B, H, Sq) float32; dq is a
// contiguous (B, Sq, H, Dh) tensor, dk and dv contiguous (B, Skv, Hk, Dh).
// scale is Dh^-0.5 rounded to float32 by the caller.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, void* dk, void* dv, int dtype, int dh, int b, int h, int hk,
    int sq, int skv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (b <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 || skv <= 0 || b > 65535 ||
      h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{q,    k,    v,    dout, lse,   delta, dq,    dk,     dv,     b,
                    h,    hk,   sq,   skv,  q_sb,  q_ss,  q_sh,  k_sb,   k_ss,   k_sh,
                    v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, causal, window, q_offset, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dh<float>(p, dh, s);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(p, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
