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
// elements in and as many out, hundreds of flops per byte: the bf16
// tensor rate is the limit.
//
// Design. The TPU kernels carry their accumulators in VMEM scratch along a
// sequential grid axis; here one block owns its output tile and loops over
// the other axis itself, accumulators in f32 registers, so no two blocks
// write one element: no atomics, deterministic results. (One pass that
// computes s and dp once, five products, would need dq by atomics or by
// per-KV-tile partials; it stays open.)
//
// bf16 (flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel): mma.sync
// tensor cores, the fragment helpers of flash_common.cuh, 4 warps of 16
// rows (or keys), two-stage cp.async rings.
//   * dq: one block per (64 query rows, query head, batch), heaviest causal
//     tiles first. Q and dO stay in shared memory; K/V tiles stream
//     through the ring. A warp computes S = Q.K^T and dP = dO.V^T (K and V
//     through ldmatrix), forms ds = p (dp - delta) scale in registers,
//     rounds it to bf16 straight into A fragments and adds dS.K (K through
//     ldmatrix.trans).
//   * dk/dv: one block per (64 keys, KV head, batch); each warp holds its
//     16 keys' K and V A fragments in registers (Dh <= 80; at Dh 128 they
//     are reloaded from shared memory, which keeps the 128 accumulator
//     floats of dK and dV and the S^T, dP^T tiles within 255 registers
//     without spills). Q, dO, lse and delta tiles of the group's query
//     heads (outer) and their query tiles (inner), the Pallas `inner`
//     order (:216-217), stream through the ring. A warp computes S^T =
//     K.Q^T and dP^T = V.dO^T (Q and dO through ldmatrix), p^T and ds^T
//     (from the unrounded p^T) in registers, rounds each to bf16 into A
//     fragments and adds dV += P^T.dO and dK += dS^T.Q (dO and Q through
//     ldmatrix.trans). The group sum stays inside the block.
//   Only the tiles in which some (row, key) pair can be visible are
//   visited (a contiguous range); skipping is exact in the backward (p is
//   0 there). The per-pair visibility checks run only on a tile that
//   crosses the diagonal, the window's edge, Sq or Skv: on the H100 that
//   nearly halved the pair's time at the training microbatch. dq, dk and
//   dv leave through shared memory in 16-byte stores.
//   Shared memory at Dh = 128: 102 KB (dq) and 103 KB (dk/dv).
//
// float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel, SIMT FMAs, no
// tensor cores): the same split with 256 threads as 16 x 16; thread
// (ty, tx) computes s and dp for rows 4ty..4ty+3 and keys tx + 16j
// (transposed in dk/dv), writes the rounded ds (and p^T) to shared tiles,
// then accumulates its rows and the columns tx + 16e. Nothing on the
// training path runs it; the card checks hold it to the plain version.

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

// A bf16 backward block: 4 warps of 16 query rows (dq) or 16 keys (dk/dv);
// in dk/dv each thread also copies one of a tile's 64 lse and 64 delta.
constexpr int kBwdThreads = 128;
static_assert(kBwdThreads == 2 * kRows && kBwdThreads / 32 * 16 == kKeys, "tile shape");

// Does every row of [q0, q0 + 64) see every key of [k0, k0 + 64)?
__device__ __forceinline__ bool all_visible(const BwdParams& p, int q0, int k0) {
  return q0 + kRows <= p.sq && k0 + kKeys <= p.skv &&
         (!p.causal || k0 + kKeys - 1 <= q0 + p.q_offset) &&
         (p.window <= 0 || k0 > q0 + kRows - 1 + p.q_offset - p.window);
}

// The contiguous range [lo, hi) of tiles t (of 64, over n) for which
// tile_may_see(rows or keys of tile t) holds: visibility is monotone in
// both directions, so the visible tiles form one range.
template <typename F>
__device__ __forceinline__ int2 visible_range(int n_tiles, F may_see) {
  int lo = 0;
  while (lo < n_tiles && !may_see(lo)) ++lo;
  int hi = lo;
  while (hi < n_tiles && may_see(hi)) ++hi;
  return make_int2(lo, hi);
}

template <int kDh>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_bf16_kernel(const BwdParams p) {
  using L = Tile<kDh>;
  using bf16 = __nv_bfloat16;
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + L::kElems;
  bf16* ring = dos + L::kElems;  // stage s: K at ring + 2 s kElems, then V

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.hk);
  const bf16* qg = static_cast<const bf16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const bf16* dog = static_cast<const bf16*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.sq;

  const int r_end = min(q0 + kRows, p.sq);
  const int2 kt = visible_range((p.skv + kKeys - 1) / kKeys, [&](int j) {
    return tile_may_see(p, q0, r_end, j * kKeys, min(j * kKeys + kKeys, p.skv));
  });

  load_tile<kDh>(qs, qg, p.q_ss, q0, p.sq, blockDim.x);
  load_tile<kDh>(dos, dog, p.do_ss, q0, p.sq, blockDim.x);
  if (kt.x < kt.y) {
    load_tile<kDh>(ring, kg, p.k_ss, kt.x * kKeys, p.skv, blockDim.x);
    load_tile<kDh>(ring + L::kElems, vg, p.v_ss, kt.x * kKeys, p.skv, blockDim.x);
  }
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  const int r0 = q0 + warp * 16 + g;
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse[r] = row < p.sq ? p.lse[row_base + row] : 0.f;
    dlt[r] = row < p.sq ? p.delta[row_base + row] : 0.f;
  }
  const bf16* qrows = qs + warp * 16 * kStride;
  const bf16* dorows = dos + warp * 16 * kStride;
  float acc[L::kN][4];
#pragma unroll
  for (int nt = 0; nt < L::kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int j = kt.x; j < kt.y; ++j) {
    bf16* ks = ring + ((j - kt.x) & 1) * 2 * L::kElems;
    bf16* vs = ks + L::kElems;
    if (j + 1 < kt.y) {
      bf16* nks = ring + ((j + 1 - kt.x) & 1) * 2 * L::kElems;
      load_tile<kDh>(nks, kg, p.k_ss, (j + 1) * kKeys, p.skv, blockDim.x);
      load_tile<kDh>(nks + L::kElems, vg, p.v_ss, (j + 1) * kKeys, p.skv, blockDim.x);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < L::kK; ++kc) {
      unsigned qa[4], oa[4];
      load_a<kStride>(qa, qrows, kc);
      load_a<kStride>(oa, dorows, kc);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        unsigned b[4];
        load_b<kStride>(b, ks, n2, kc);
        mma_bf16(s[2 * n2], qa, b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qa, b[2], b[3]);
        load_b<kStride>(b, vs, n2, kc);
        mma_bf16(dp[2 * n2], oa, b[0], b[1]);
        mma_bf16(dp[2 * n2 + 1], oa, b[2], b[3]);
      }
    }

    // ds = p (dp - delta) scale, p = visible ? exp(s scale - lse) : 0; the
    // checks only on a tile where some pair is not visible
    const int k0 = j * kKeys;
    if (all_visible(p, q0, k0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pij = expf(__fmul_rn(s[nt][e], p.scale) - lse[e >> 1]);
          s[nt][e] = pij * (dp[nt][e] - dlt[e >> 1]) * p.scale;
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = r0 + 8 * r;
          float pij = 0.f;
          if (row < p.sq && visible(p, row + p.q_offset, k0 + nt * 8 + 2 * t + (e & 1)))
            pij = expf(__fmul_rn(s[nt][e], p.scale) - lse[r]);
          s[nt][e] = pij * (dp[nt][e] - dlt[r]) * p.scale;
        }
    }

    // dQ += round_bf16(dS).K
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < L::kK; ++n2) {
        unsigned b[4];
        load_b_trans<kStride>(b, ks, n2, kc);
        mma_bf16(acc[2 * n2], a, b[0], b[1]);
        mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  store_rows<kDh>(acc, 1.f, 1.f, qs + warp * 16 * kStride,
                  static_cast<bf16*>(p.dq) + (static_cast<long long>(bb) * p.sq * p.h + hh) * kDh,
                  static_cast<long long>(p.h) * kDh, q0 + warp * 16, p.sq);
}

template <int kDh>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_bf16_kernel(const BwdParams p) {
  using L = Tile<kDh>;
  using bf16 = __nv_bfloat16;
  constexpr int kStride = L::kStride;
  constexpr bool kKvRegs = kDh <= 80;  // K, V A fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + L::kElems;
  bf16* ring = vs + L::kElems;  // stage s: Q at ring + 2 s kElems, then dO
  float* rows_ring = reinterpret_cast<float*>(ring + 4 * L::kElems);  // stage s: lse, delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int grp = p.h / p.hk;
  const int k1 = min(k0 + kKeys, p.skv);

  const int2 qt = visible_range((p.sq + kRows - 1) / kRows, [&](int j) {
    return tile_may_see(p, j * kRows, min(j * kRows + kRows, p.sq), k0, k1);
  });
  const int nq = qt.y - qt.x;
  const int n_it = grp * nq;

  // the copies of iteration i (group member i / nq, query tile qt.x + i % nq)
  auto issue = [&](int i, int stage) {
    const int hh = kvh * grp + i / nq;
    const int q0 = (qt.x + i % nq) * kRows;
    bf16* dst = ring + stage * 2 * L::kElems;
    load_tile<kDh>(dst, static_cast<const bf16*>(p.q) + bb * p.q_sb + hh * p.q_sh, p.q_ss, q0,
                   p.sq, blockDim.x);
    load_tile<kDh>(dst + L::kElems,
                   static_cast<const bf16*>(p.dout) + bb * p.do_sb + hh * p.do_sh, p.do_ss, q0,
                   p.sq, blockDim.x);
    const long long row_base = (static_cast<long long>(bb) * p.h + hh) * p.sq;
    const int c = threadIdx.x & (kRows - 1);
    const float* src = threadIdx.x < kRows ? p.lse : p.delta;
    const bool valid = q0 + c < p.sq;
    cp_async4(rows_ring + stage * 2 * kRows + threadIdx.x, valid ? src + row_base + q0 + c : src,
              valid);
  };

  load_tile<kDh>(ks, static_cast<const bf16*>(p.k) + bb * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
                 p.skv, blockDim.x);
  load_tile<kDh>(vs, static_cast<const bf16*>(p.v) + bb * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
                 p.skv, blockDim.x);
  cp_async_commit();
  if (n_it > 0) issue(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const bf16* krows = ks + warp * 16 * kStride;
  const bf16* vrows = vs + warp * 16 * kStride;
  unsigned kf[kKvRegs ? L::kK : 1][4], vf[kKvRegs ? L::kK : 1][4];
  if constexpr (kKvRegs) {
#pragma unroll
    for (int kc = 0; kc < L::kK; ++kc) {
      load_a<kStride>(kf[kc], krows, kc);
      load_a<kStride>(vf[kc], vrows, kc);
    }
  }
  // this thread's keys: g and g + 8 of the warp's 16
  const int key0 = k0 + warp * 16 + g;
  float dk[L::kN][4], dv[L::kN][4];
#pragma unroll
  for (int nt = 0; nt < L::kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int i = 0; i < n_it; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_it) issue(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = ring + stage * 2 * L::kElems;
    const bf16* dos = qs + L::kElems;
    const float* lse_s = rows_ring + stage * 2 * kRows;
    const float* dlt_s = lse_s + kRows;
    const int q0 = (qt.x + i % nq) * kRows;

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < L::kK; ++kc) {
      unsigned ka[4], va[4];
      if constexpr (kKvRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kc][e];
          va[e] = vf[kc][e];
        }
      } else {
        load_a<kStride>(ka, krows, kc);
        load_a<kStride>(va, vrows, kc);
      }
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        unsigned b[4];
        load_b<kStride>(b, qs, n2, kc);
        mma_bf16(st[2 * n2], ka, b[0], b[1]);
        mma_bf16(st[2 * n2 + 1], ka, b[2], b[3]);
        load_b<kStride>(b, dos, n2, kc);
        mma_bf16(dpt[2 * n2], va, b[0], b[1]);
        mma_bf16(dpt[2 * n2 + 1], va, b[2], b[3]);
      }
    }

    // p^T and ds^T (from the unrounded p^T), column c = query row q0 + c;
    // the checks only on a tile where some pair is not visible
    if (all_visible(p, q0, k0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const float pt = expf(__fmul_rn(st[nt][e], p.scale) - lse_s[c]);
          st[nt][e] = pt;
          dpt[nt][e] = pt * (dpt[nt][e] - dlt_s[c]) * p.scale;
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const int row = q0 + c;
          float pt = 0.f;
          if (row < p.sq && visible(p, row + p.q_offset, key0 + (e >> 1) * 8))
            pt = expf(__fmul_rn(st[nt][e], p.scale) - lse_s[c]);
          st[nt][e] = pt;
          dpt[nt][e] = pt * (dpt[nt][e] - dlt_s[c]) * p.scale;
        }
    }

    // dV += round_bf16(P^T).dO, dK += round_bf16(dS^T).Q
#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {
      const unsigned pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
      const unsigned da[4] = {pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
                              pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
                              pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                              pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < L::kK; ++n2) {
        unsigned b[4];
        load_b_trans<kStride>(b, dos, n2, kc);
        mma_bf16(dv[2 * n2], pa, b[0], b[1]);
        mma_bf16(dv[2 * n2 + 1], pa, b[2], b[3]);
        load_b_trans<kStride>(b, qs, n2, kc);
        mma_bf16(dk[2 * n2], da, b[0], b[1]);
        mma_bf16(dk[2 * n2 + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  const long long out = (static_cast<long long>(bb) * p.skv * p.hk + kvh) * kDh;
  const long long stride = static_cast<long long>(p.hk) * kDh;
  store_rows<kDh>(dk, 1.f, 1.f, ks + warp * 16 * kStride, static_cast<bf16*>(p.dk) + out, stride,
                  k0 + warp * 16, p.skv);
  store_rows<kDh>(dv, 1.f, 1.f, vs + warp * 16 * kStride, static_cast<bf16*>(p.dv) + out, stride,
                  k0 + warp * 16, p.skv);
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

template <int kDh>
int launch_bf16(const BwdParams& p, cudaStream_t stream) {
  using L = Tile<kDh>;
  // dq: Q and dO, two stages of K and V; dk/dv: K and V, two stages of Q,
  // dO and the 64 rows' lse and delta
  constexpr size_t smem_dq = 6 * static_cast<size_t>(L::kElems) * sizeof(__nv_bfloat16);
  constexpr size_t smem_dkv = smem_dq + 4 * static_cast<size_t>(kRows) * sizeof(float);
  auto dq_kern = flash_bwd_dq_bf16_kernel<kDh>;
  auto dkv_kern = flash_bwd_dkv_bf16_kernel<kDh>;
  int err = allow_smem(dq_kern, smem_dq);
  if (err) return err;
  err = allow_smem(dkv_kern, smem_dkv);
  if (err) return err;
  dq_kern<<<dim3((p.sq + kRows - 1) / kRows, p.h, p.b), kBwdThreads, smem_dq, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dkv_kern<<<dim3((p.skv + kKeys - 1) / kKeys, p.hk, p.b), kBwdThreads, smem_dkv, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const BwdParams& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<float, 32>(p, s);
    case 64: return launch<float, 64>(p, s);
    case 80: return launch<float, 80>(p, s);
    case 128: return launch<float, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(const BwdParams& p, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_bf16<32>(p, s);
    case 64: return launch_bf16<64>(p, s);
    case 80: return launch_bf16<80>(p, s);
    case 128: return launch_bf16<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernels), 1 = bfloat16 (the tensor-core
// kernels) — q, k, v, dout, dq, dk, dv all of it; dh one of 32, 64, 80,
// 128. Strides of q, k, v and dout are in elements, the last dimension
// contiguous (for bf16 every row 16-byte aligned: base pointers aligned,
// the batch, sequence and head strides multiples of 8 elements); lse and delta are contiguous (B, H, Sq) float32; dq is a
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
  if (dtype == 0) return dispatch_f32(p, dh, s);
  if (dtype == 1) return dispatch_bf16(p, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
