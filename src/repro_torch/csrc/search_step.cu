// fused_search — the whole greedy beam search in one launch (megakernel),
// and fused_hop — one hop of it per launch, for a host loop.
//
// Replaces: fused_search_pallas (repro/kernels/search_step/
// search_step_kernel.py:352; bodies _mega_kernel :227, _hop_update :100,
// _merge_topl :71, _gather_rows :51) and fused_hop_pallas (:309; body
// _hop_kernel :201). Semantics are those of the oracle fused_search_ref /
// fused_hop_ref (repro/kernels/search_step/ref.py), hop for hop:
// pick the first unvisited frontier slot, read its adjacency row, drop
// out-of-range / duplicate / (exclude mode) tombstoned or out-of-filter
// candidates, score the rest (RaBitQ estimator over packed codes, or exact
// L2 over f32 rows), merge into the top L with ties to the frontier, and
// narrow to the hop's schedule width. Hops count expansions performed.
// Both kernels run one body, `hop` below: the megakernel loops over it
// with the frontier in shared memory, the hop kernel runs it once between
// a frontier load from and a store to device memory.
//
// Bound on the H100: bytes, gathered. Per query per hop it must read one
// adjacency row (R*4 B = 256 B at R=64) and, for each scored candidate,
// its packed code row and two metadata floats (P+8 B = 72 B at D=128,
// 4 bits): about R*(P+12) = 4.9 KB per hop, ~0.7 MB per query over ~140
// hops, with 2*D flops per candidate. Each hop's reads depend on the
// previous hop's merge, so one query is a chain of dependent gathers:
// throughput comes from many queries in flight, not from one. The hop
// kernel also moves the (L,) frontier in and out per hop (L*12 B each
// way), which the megakernel keeps on chip.
//
// Design: one thread block per query (the GPU Jasper layout; the TPU's
// 8-query tile was a VPU vectorisation device). The frontier (ids, dists,
// visited; L <= a few hundred), the query vector and the hop's R
// candidates stay in shared memory; only the frontier, the hop count and
// the optional telemetry reach device memory.
// Per hop: R threads issue all R adjacency reads at once (the TPU form
// read rows one by one); one warp per candidate reads its code row with
// coalesced 32-bit loads, unpacks little-endian fields, dots with q_rot
// from shared memory and reduces by shuffle. The merge is rank-based and
// stable: element i of frontier ++ candidates goes to position
// #(d < d_i) + #(d == d_i at a lower position), which is the stable
// ascending order of the reference's merge (frontier first on ties), and
// which — unlike the TPU kernel's min-extraction — leaves the +inf tail
// as the oracle does. Templated on QUANT, BITS, USE_TOMB, USE_FILT and
// TEL, so exact mode, the exclude-mode masks and the counters share one
// body and cost nothing when off.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct Args {
  const int32_t* f_ids;
  const float* f_dists;
  const int32_t* f_vis;
  int L;
  const int32_t* sched;
  int max_iters;
  const float* q;
  int dq;
  const float* qa;
  const float* qb;
  const int32_t* adj;
  int R;
  int cap;
  int n_valid;
  const void* data;
  int row_width;  // packed bytes per row (QUANT) or floats per row (exact)
  const float* meta0;  // data_add (QUANT) or squared norms (exact)
  const float* meta1;  // data_rescale (QUANT)
  const uint8_t* tomb;
  const uint32_t* labels;
  uint32_t fb;
  int32_t* out_ids;
  float* out_dists;
  int32_t* out_hops;      // (Q,) hops (fused_search) or 0/1 increment (fused_hop)
  int32_t* out_counters;  // (Q, 3) scored, masked, dups; fused_hop: (Q, 4) + occupancy
  int32_t* out_occ;       // (Q, max_iters), fused_search only
  int32_t* out_vis;       // (Q, L), fused_hop only
};

// Shared-memory layout of one query's search state, carved from the
// kernel's dynamic shared memory, and the query's load into it. A macro,
// so that both kernels declare the plain locals the hop body works on,
// exactly as the megakernel declared them before the body was shared.
#define JASPER_CARVE_SMEM                                                   \
  extern __shared__ float smem[];                                           \
  const int L = a.L;                                                        \
  const int R = a.R;                                                        \
  float* sq = smem;                                        /* dq */         \
  int32_t* fi = reinterpret_cast<int32_t*>(sq + a.dq);     /* L  */         \
  float* fd = reinterpret_cast<float*>(fi + L);            /* L  */         \
  int32_t* fv = reinterpret_cast<int32_t*>(fd + L);        /* L  */         \
  int32_t* ni = fv + L;                                    /* L  */         \
  float* nd = reinterpret_cast<float*>(ni + L);            /* L  */         \
  int32_t* nv = reinterpret_cast<int32_t*>(nd + L);        /* L  */         \
  int32_t* ci = nv + L;                                    /* R  */         \
  float* cd = reinterpret_cast<float*>(ci + R);            /* R  */         \
  __shared__ int s_pick;                                                    \
  __shared__ int s_occ;                                                     \
  __shared__ int s_scored, s_masked, s_dups;                                \
  const int qi = blockIdx.x;                                                \
  const int tid = threadIdx.x;                                              \
  const size_t fo = static_cast<size_t>(qi) * L;                            \
  for (int i = tid; i < a.dq; i += kThreads) sq[i] = a.q[static_cast<size_t>(qi) * a.dq + i]; \
  for (int i = tid; i < L; i += kThreads) {                                 \
    fi[i] = a.f_ids[fo + i];                                                \
    fd[i] = a.f_dists[fo + i];                                              \
    fv[i] = a.f_vis[fo + i];                                                \
  }                                                                         \
  if (TEL && tid == 0) {                                                    \
    s_scored = 0;                                                           \
    s_masked = 0;                                                           \
    s_dups = 0;                                                             \
  }                                                                         \
  const float qa = a.qa[qi];                                                \
  const float qb = a.qb[qi]

// One hop of one query over the state JASPER_CARVE_SMEM declares. Returns
// -1, having changed nothing, when the frontier has no unvisited slot
// (uniform over the block). Otherwise expands, scores, merges and narrows
// the frontier in shared memory to width_of() — read at the narrowing,
// where the megakernel always read its schedule — and returns this
// thread's count of live slots after the narrowing (the occupancy
// telemetry sums them); with TEL, s_scored/s_masked/s_dups grow by this
// hop's counts. The caller synchronises before the frontier is read again.
template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL, typename Width>
__device__ __forceinline__ int hop(const Args& a, const int L, const int R, const float* sq,
                                   int32_t* fi, float* fd, int32_t* fv, int32_t* ni, float* nd,
                                   int32_t* nv, int32_t* ci, float* cd, int& s_pick, int& s_occ,
                                   int& s_scored, int& s_masked, int& s_dups, const float qa,
                                   const float qb, const Width& width_of) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  // ---- pick: first unvisited slot (the frontier is distance-sorted)
  if (tid == 0) {
    s_pick = L;
    s_occ = 0;
  }
  __syncthreads();
  for (int i = tid; i < L; i += kThreads)
    if (fi[i] >= 0 && fv[i] == 0) atomicMin(&s_pick, i);
  __syncthreads();
  const int pick = s_pick;
  if (pick >= L) return -1;  // uniform: converged
  const int cur = min(max(fi[pick], 0), a.cap - 1);

  // ---- expand: all R adjacency reads at once, validity epilogue
  for (int j = tid; j < R; j += kThreads) {
    const int nb = __ldg(a.adj + static_cast<size_t>(cur) * R + j);
    const bool in_range = nb >= 0 && nb < a.n_valid;
    bool dup = false;
    if (in_range)
      for (int f = 0; f < L; ++f) dup |= (fi[f] == nb);
    bool valid = in_range && !dup;
    bool dead = false, fmiss = false;
    if (USE_TOMB && valid) {
      dead = ((__ldg(a.tomb + (nb >> 3)) >> (nb & 7)) & 1) != 0;
      valid = !dead;
    }
    if (USE_FILT && valid) {
      fmiss = (__ldg(a.labels + nb) & a.fb) == 0;
      valid = !fmiss;
    }
    ci[j] = valid ? nb : -1;
    cd[j] = INFINITY;
    if (TEL) {
      if (valid) atomicAdd(&s_scored, 1);
      if (dead || fmiss) atomicAdd(&s_masked, 1);
      if (in_range && dup) atomicAdd(&s_dups, 1);
    }
  }
  __syncthreads();
  if (tid == 0) fv[pick] = 1;

  // ---- score: one warp per valid candidate
  for (int j = warp; j < R; j += kWarps) {
    const int id = ci[j];
    if (id < 0) continue;  // uniform across the warp
    if constexpr (QUANT) {
      const uint8_t* row = static_cast<const uint8_t*>(a.data) +
                           static_cast<size_t>(id) * a.row_width;
      const float dot = jasper::warp_sum(jasper::packed_dot<BITS>(row, a.row_width, sq, lane));
      if (lane == 0)
        cd[j] = jasper::rabitq_epilogue(__ldg(a.meta0 + id), qa, __ldg(a.meta1 + id), dot, qb);
    } else {
      const float* row = static_cast<const float*>(a.data) +
                         static_cast<size_t>(id) * a.row_width;
      const float dot = jasper::warp_sum(jasper::float_dot(row, a.row_width, sq, lane));
      if (lane == 0) cd[j] = jasper::l2_epilogue(qa, dot, __ldg(a.meta0 + id));
    }
  }
  __syncthreads();

  // ---- merge: stable rank of each element of frontier ++ candidates
  const int total = L + R;
  for (int e = tid; e < total; e += kThreads) {
    const bool from_f = e < L;
    const float d = from_f ? fd[e] : cd[e - L];
    int rank = 0;
    for (int f = 0; f < L; ++f) {
      const float df = fd[f];
      rank += (df < d) || (df == d && f < e);
    }
    for (int c = 0; c < R; ++c) {
      const float dc = cd[c];
      rank += (dc < d) || (dc == d && L + c < e);
    }
    if (rank < L) {
      ni[rank] = from_f ? fi[e] : ci[e - L];
      nd[rank] = d;
      nv[rank] = from_f ? fv[e] : 0;
    }
  }
  __syncthreads();

  // ---- narrow to this hop's width; count live slots
  const int width = width_of();
  int live = 0;
  for (int i = tid; i < L; i += kThreads) {
    const bool keep = i < width;
    const int id = keep ? ni[i] : -1;
    fi[i] = id;
    fd[i] = keep ? nd[i] : INFINITY;
    fv[i] = keep ? nv[i] : 0;
    live += id >= 0;
  }
  return live;
}

#define JASPER_HOP(width_of)                                                        \
  hop<QUANT, BITS, USE_TOMB, USE_FILT, TEL>(a, L, R, sq, fi, fd, fv, ni, nd, nv, ci, \
                                            cd, s_pick, s_occ, s_scored, s_masked, \
                                            s_dups, qa, qb, width_of)

template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
__global__ void __launch_bounds__(kThreads) fused_search_kernel(const Args a) {
  JASPER_CARVE_SMEM;
  int hops = 0;

  for (int t = 0; t < a.max_iters; ++t) {
    const int live = JASPER_HOP(([sched = a.sched, t] { return sched[t]; }));
    if (live < 0) break;
    ++hops;
    if (TEL) {
      if (live) atomicAdd(&s_occ, live);
      __syncthreads();
      if (tid == 0) a.out_occ[static_cast<size_t>(qi) * a.max_iters + t] = s_occ;
    }
    __syncthreads();
  }

  for (int i = tid; i < L; i += kThreads) {
    a.out_ids[fo + i] = fi[i];
    a.out_dists[fo + i] = fd[i];
  }
  if (tid == 0) a.out_hops[qi] = hops;
  if (TEL) {
    for (int t = hops + tid; t < a.max_iters; t += kThreads)
      a.out_occ[static_cast<size_t>(qi) * a.max_iters + t] = 0;
    if (tid == 0) {
      a.out_counters[qi * 3 + 0] = s_scored;
      a.out_counters[qi * 3 + 1] = s_masked;
      a.out_counters[qi * 3 + 2] = s_dups;
    }
  }
}

// One hop per launch: frontier in from device memory, one `hop` at
// `width`, frontier out with a (Q,) 0/1 hop increment and, with TEL, a
// (Q, 4) [scored, masked, dups, occupancy] block. A row with no unvisited
// slot copies its frontier through unchanged with increment 0 and zero
// counters, as fused_hop_ref leaves it.
template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
__global__ void __launch_bounds__(kThreads) fused_hop_kernel(const Args a, const int width) {
  JASPER_CARVE_SMEM;
  const int live = JASPER_HOP(([width] { return width; }));
  if (TEL && live > 0) atomicAdd(&s_occ, live);
  __syncthreads();
  for (int i = tid; i < L; i += kThreads) {
    a.out_ids[fo + i] = fi[i];
    a.out_dists[fo + i] = fd[i];
    a.out_vis[fo + i] = fv[i];
  }
  if (tid == 0) {
    a.out_hops[qi] = live >= 0 ? 1 : 0;
    if (TEL) {
      a.out_counters[qi * 4 + 0] = s_scored;
      a.out_counters[qi * 4 + 1] = s_masked;
      a.out_counters[qi * 4 + 2] = s_dups;
      a.out_counters[qi * 4 + 3] = live >= 0 ? s_occ : 0;
    }
  }
}

#undef JASPER_HOP
#undef JASPER_CARVE_SMEM

size_t smem_bytes(const Args& a) {
  return static_cast<size_t>(a.dq) * 4 + static_cast<size_t>(a.L) * 4 * 6 +
         static_cast<size_t>(a.R) * 4 * 2;
}

template <typename Kernel>
int set_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// width < 0: the megakernel over the schedule; else one hop at `width`.
template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
int launch(const Args& a, int num_q, int width, cudaStream_t s) {
  const size_t smem = smem_bytes(a);
  int err;
  if (width < 0) {
    auto kern = fused_search_kernel<QUANT, BITS, USE_TOMB, USE_FILT, TEL>;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<num_q, kThreads, smem, s>>>(a);
  } else {
    auto kern = fused_hop_kernel<QUANT, BITS, USE_TOMB, USE_FILT, TEL>;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<num_q, kThreads, smem, s>>>(a, width);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT, int BITS>
int dispatch_flags(const Args& a, int num_q, int tel, int width, cudaStream_t s) {
  const bool t = a.tomb != nullptr;
  const bool f = a.labels != nullptr;
  if (tel) {
    if (t && f) return launch<QUANT, BITS, true, true, true>(a, num_q, width, s);
    if (t) return launch<QUANT, BITS, true, false, true>(a, num_q, width, s);
    if (f) return launch<QUANT, BITS, false, true, true>(a, num_q, width, s);
    return launch<QUANT, BITS, false, false, true>(a, num_q, width, s);
  }
  if (t && f) return launch<QUANT, BITS, true, true, false>(a, num_q, width, s);
  if (t) return launch<QUANT, BITS, true, false, false>(a, num_q, width, s);
  if (f) return launch<QUANT, BITS, false, true, false>(a, num_q, width, s);
  return launch<QUANT, BITS, false, false, false>(a, num_q, width, s);
}

int dispatch(const Args& a, int num_q, int quantized, int bits, int tel, int width,
             cudaStream_t s) {
  if (!quantized) return dispatch_flags<false, 8>(a, num_q, tel, width, s);
  switch (bits) {
    case 1: return dispatch_flags<true, 1>(a, num_q, tel, width, s);
    case 2: return dispatch_flags<true, 2>(a, num_q, tel, width, s);
    case 4: return dispatch_flags<true, 4>(a, num_q, tel, width, s);
    case 8: return dispatch_flags<true, 8>(a, num_q, tel, width, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_search_launch(
    const int32_t* f_ids, const float* f_dists, const int32_t* f_vis, int num_q, int L,
    const int32_t* sched, int max_iters, const float* q, int dq, const float* qa,
    const float* qb, const int32_t* adj, int R, int cap, int n_valid, const void* data,
    int row_width, const float* meta0, const float* meta1, const uint8_t* tomb,
    const uint32_t* labels, uint32_t fb, int quantized, int bits, int telemetry,
    int32_t* out_ids, float* out_dists, int32_t* out_hops, int32_t* out_counters,
    int32_t* out_occ, void* stream) {
  Args a{f_ids, f_dists, f_vis, L, sched, max_iters, q, dq, qa, qb, adj, R, cap, n_valid,
         data, row_width, meta0, meta1, tomb, labels, fb, out_ids, out_dists, out_hops,
         out_counters, out_occ, nullptr};
  return dispatch(a, num_q, quantized, bits, telemetry, -1, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_hop_launch(
    const int32_t* f_ids, const float* f_dists, const int32_t* f_vis, int num_q, int L,
    int width, const float* q, int dq, const float* qa, const float* qb, const int32_t* adj,
    int R, int cap, int n_valid, const void* data, int row_width, const float* meta0,
    const float* meta1, const uint8_t* tomb, const uint32_t* labels, uint32_t fb,
    int quantized, int bits, int telemetry, int32_t* out_ids, float* out_dists,
    int32_t* out_vis, int32_t* out_inc, int32_t* out_counters, void* stream) {
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{f_ids, f_dists, f_vis, L, nullptr, 0, q, dq, qa, qb, adj, R, cap, n_valid,
         data, row_width, meta0, meta1, tomb, labels, fb, out_ids, out_dists, out_inc,
         out_counters, nullptr, out_vis};
  return dispatch(a, num_q, quantized, bits, telemetry, width, static_cast<cudaStream_t>(stream));
}
