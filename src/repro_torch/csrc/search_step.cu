// fused_search — the whole greedy beam search in one launch (megakernel).
//
// Replaces: fused_search_pallas (repro/kernels/search_step/
// search_step_kernel.py:352; bodies _mega_kernel :227, _hop_update :100,
// _merge_topl :71, _gather_rows :51). Semantics are those of the oracle
// fused_search_ref (repro/kernels/search_step/ref.py:120), hop for hop:
// pick the first unvisited frontier slot, read its adjacency row, drop
// out-of-range / duplicate / (exclude mode) tombstoned or out-of-filter
// candidates, score the rest (RaBitQ estimator over packed codes, or exact
// L2 over f32 rows), merge into the top L with ties to the frontier, and
// narrow to the hop's schedule width. Hops count expansions performed.
//
// Bound on the H100: bytes, gathered. Per query per hop it must read one
// adjacency row (R*4 B = 256 B at R=64) and, for each scored candidate,
// its packed code row and two metadata floats (P+8 B = 72 B at D=128,
// 4 bits): about R*(P+12) = 4.9 KB per hop, ~0.7 MB per query over ~140
// hops, with 2*D flops per candidate. Each hop's reads depend on the
// previous hop's merge, so one query is a chain of dependent gathers:
// throughput comes from many queries in flight, not from one.
//
// Design: one thread block per query (the GPU Jasper layout; the TPU's
// 8-query tile was a VPU vectorisation device). The frontier (ids, dists,
// visited; L <= a few hundred), the query vector and the hop's R
// candidates stay in shared memory for the whole search; only the final
// frontier, the hop count and the optional telemetry reach device memory.
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
  int32_t* out_hops;
  int32_t* out_counters;  // (Q, 3) scored, masked, dups
  int32_t* out_occ;       // (Q, max_iters)
};

template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
__global__ void __launch_bounds__(kThreads) fused_search_kernel(const Args a) {
  extern __shared__ float smem[];
  const int L = a.L;
  const int R = a.R;
  float* sq = smem;                                        // dq
  int32_t* fi = reinterpret_cast<int32_t*>(sq + a.dq);     // L
  float* fd = reinterpret_cast<float*>(fi + L);            // L
  int32_t* fv = reinterpret_cast<int32_t*>(fd + L);        // L
  int32_t* ni = fv + L;                                    // L
  float* nd = reinterpret_cast<float*>(ni + L);            // L
  int32_t* nv = reinterpret_cast<int32_t*>(nd + L);        // L
  int32_t* ci = nv + L;                                    // R
  float* cd = reinterpret_cast<float*>(ci + R);            // R
  __shared__ int s_pick;
  __shared__ int s_occ;
  __shared__ int s_scored, s_masked, s_dups;

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const size_t fo = static_cast<size_t>(qi) * L;
  for (int i = tid; i < a.dq; i += kThreads) sq[i] = a.q[static_cast<size_t>(qi) * a.dq + i];
  for (int i = tid; i < L; i += kThreads) {
    fi[i] = a.f_ids[fo + i];
    fd[i] = a.f_dists[fo + i];
    fv[i] = a.f_vis[fo + i];
  }
  if (TEL && tid == 0) {
    s_scored = 0;
    s_masked = 0;
    s_dups = 0;
  }
  const float qa = a.qa[qi];
  const float qb = a.qb[qi];
  int hops = 0;

  for (int t = 0; t < a.max_iters; ++t) {
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
    if (pick >= L) break;  // uniform: converged
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
    const int width = a.sched[t];
    int live = 0;
    for (int i = tid; i < L; i += kThreads) {
      const bool keep = i < width;
      const int id = keep ? ni[i] : -1;
      fi[i] = id;
      fd[i] = keep ? nd[i] : INFINITY;
      fv[i] = keep ? nv[i] : 0;
      live += id >= 0;
    }
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

size_t smem_bytes(const Args& a) {
  return static_cast<size_t>(a.dq) * 4 + static_cast<size_t>(a.L) * 4 * 6 +
         static_cast<size_t>(a.R) * 4 * 2;
}

template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
int launch(const Args& a, int num_q, cudaStream_t s) {
  auto kern = fused_search_kernel<QUANT, BITS, USE_TOMB, USE_FILT, TEL>;
  const size_t smem = smem_bytes(a);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<num_q, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT, int BITS>
int dispatch_flags(const Args& a, int num_q, int tel, cudaStream_t s) {
  const bool t = a.tomb != nullptr;
  const bool f = a.labels != nullptr;
  if (tel) {
    if (t && f) return launch<QUANT, BITS, true, true, true>(a, num_q, s);
    if (t) return launch<QUANT, BITS, true, false, true>(a, num_q, s);
    if (f) return launch<QUANT, BITS, false, true, true>(a, num_q, s);
    return launch<QUANT, BITS, false, false, true>(a, num_q, s);
  }
  if (t && f) return launch<QUANT, BITS, true, true, false>(a, num_q, s);
  if (t) return launch<QUANT, BITS, true, false, false>(a, num_q, s);
  if (f) return launch<QUANT, BITS, false, true, false>(a, num_q, s);
  return launch<QUANT, BITS, false, false, false>(a, num_q, s);
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
         out_counters, out_occ};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!quantized) return dispatch_flags<false, 8>(a, num_q, telemetry, s);
  switch (bits) {
    case 1: return dispatch_flags<true, 1>(a, num_q, telemetry, s);
    case 2: return dispatch_flags<true, 2>(a, num_q, telemetry, s);
    case 4: return dispatch_flags<true, 4>(a, num_q, telemetry, s);
    case 8: return dispatch_flags<true, 8>(a, num_q, telemetry, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
