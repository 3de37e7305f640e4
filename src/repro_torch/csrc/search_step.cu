// fused_search — the whole greedy beam search in one launch (megakernel),
// and fused_hop — one hop of it per launch, for a host loop.
//
// Replaces: fused_search_pallas (repro/kernels/search_step/
// search_step_kernel.py:352; bodies _mega_kernel :227, _hop_update :100,
// _merge_topl :71, _gather_rows :51) and fused_hop_pallas (:309; body
// _hop_kernel :201). Semantics are those of the oracle fused_search_ref /
// fused_hop_ref (repro/kernels/search_step/ref.py), hop for hop:
// pick the first unvisited frontier slot, read its adjacency row, drop
// out-of-range / duplicate (in the current frontier) / (exclude mode)
// tombstoned or out-of-filter candidates, score the rest (RaBitQ
// estimator over packed codes, or exact L2 over f32 rows), merge into the
// top L with ties to the frontier, and narrow to the hop's schedule width.
// Hops count expansions performed. Both kernels run one body, `hop`
// below: the megakernel loops over it with the frontier in shared memory,
// the hop kernel runs it once between a frontier load from and a store to
// device memory.
//
// Bound on the H100: bytes, gathered. Per query per hop it must read one
// adjacency row (R*4 B = 256 B at R=64) and, for each scored candidate,
// its packed code row and two metadata floats (P+8 B = 72 B at D=128,
// 4 bits): up to 4.9 KB a hop, ~0.3 MB a query over ~74 hops, with 2*D
// flops per candidate. Each hop's reads depend on the previous hop's
// merge, so one query is a chain of dependent gathers: throughput comes
// from many queries in flight, each with all of its hop's reads in flight.
//
// What bounds it on this card (measured, PERF.md): not the bytes but the
// latency of each hop's two dependent gathers and the instructions around
// them. The first port (a 128-thread block a query) scored one candidate a
// warp at a time behind serial dup checks and an O(L + R) merge: 9.3 % of
// the byte bound. Registers and shared memory set how many queries an SM
// holds, and a hop's instructions how long its gathers wait. This design
// reaches 34 % of the byte bound at the main shapes (2.9 ms for 10,000
// queries at L = R = 64, D = 128, 4 bits; PERF.md).
//
// Design: one warp a query, kQueriesPerBlock queries a block (a block a
// query measured 1.7x slower, PERF.md): 28 queries an SM at the main
// path's shapes (72 registers, 31,872 B of shared memory a block).
// Per hop:
//  - pick: a warp min over each lane's first unvisited slot;
//  - expand: the R adjacency ids are read into registers at once; each
//    lane tests its candidates against the frontier's ids,
//    read four at a time by every lane at once (a table built with shared
//    atomics each hop cost more than the scan: PERF.md); valid candidates
//    are compacted by ballot;
//  - stage: every valid candidate's code row and metadata are copied into
//    shared memory by cp.async, all issued before any is waited for (the
//    whole hop at R = 64 and P = 64 B; wider rows in stages of
//    kStageBytes). A group of G lanes takes a row, 16 bytes a lane (G = 4
//    at P = 64 B; 4-byte copies for rows that are not 16-byte multiples,
//    bytes for rows that are not 4-byte ones). Nothing is held in
//    registers while the copies fly;
//  - score: 4-bit rows of whole 64-byte groups (the main path) on the
//    tensor cores, 16 rows a tile against the query split into three bf16
//    parts (`score_stage_mma`); other rows on the SIMT path, a group of
//    lanes a row reading its 16-byte units, each code made an exact float
//    without a conversion (`word_dot`), reduced by a segmented shuffle.
//    Exact rows are float4 units on the SIMT path;
//  - merge: only a candidate nearer than the frontier's last kept slot
//    can enter, and only those are sorted on (distance, position), by a
//    bitonic network in registers (or shared memory past 64 keys). A
//    frontier element's rank is its index plus the count of keys strictly
//    nearer (a binary search), a key's its sorted index plus the count of
//    frontier elements no farther. That is the stable ascending order of
//    the reference's merge (frontier first on ties, candidates by
//    position), which leaves the +inf tail as the oracle does. The
//    frontier is distance-sorted, as every frontier the walk makes is.
//    Slots past the hop's width are emptied; the frontier buffers swap.
// Templated on QUANT, BITS, USE_TOMB, USE_FILT and TEL, so exact mode, the
// exclude-mode masks and the counters share one body; the counters live in
// registers and cost nothing when TEL is off.

#include "common.cuh"

namespace {

using Key = unsigned long long;  // a sort key: (distance, position)

constexpr int kQueriesPerBlock = 4;    // one warp a query
constexpr int kBlockThreads = 32 * kQueriesPerBlock;
constexpr int kAdjRegs = 2;            // adjacency ids a thread holds in flight
constexpr int kMinBlocks = 7;          // blocks an SM at the main path's shared memory
constexpr int kStageBytes = 5120;      // candidate rows staged in shared memory at once
constexpr int kMaxGroup = 8;           // most lanes that share a candidate
constexpr int kSmemLimit = 232448;     // the most dynamic shared memory a block has

struct Args {
  const int32_t* f_ids;
  const float* f_dists;
  const int32_t* f_vis;
  int num_q;
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
  // when not null, n_valid and fb are read from these device words instead
  // (a search captured in a CUDA graph then follows their current values)
  const int32_t* n_valid_dev;
  const uint32_t* fb_dev;
  int32_t* out_ids;
  float* out_dists;
  int32_t* out_hops;      // (Q,) hops (fused_search) or 0/1 increment (fused_hop)
  int32_t* out_counters;  // (Q, 3) scored, masked, dups; fused_hop: (Q, 4) + occupancy
  int32_t* out_occ;       // (Q, max_iters), fused_search only
  int32_t* out_vis;       // (Q, L), fused_hop only
  // how rows are staged and scored (set_rows): bytes a row; bytes a copy
  // from device memory (16, 4 or 1); 16-byte units a staged row; log2 of
  // the lanes that share a candidate; a staged row's stride in bytes; rows
  // a stage; the query's floats, padded to whole units
  int row_bytes;
  int vec;
  int units;
  int group_log2;
  int stride;
  int stage_rows;
  int q_floats;
  int mma;  // 4-bit rows of whole 64-byte groups: scored on the tensor cores
};

// ---------------------------------------------------------------- layout
__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Byte offsets of one query's state in shared memory: the query, two
// frontier buffers (ids, dists, visited; ids padded with -1 to 16 bytes),
// the candidates' ids by position, the compacted positions, the sort
// keys, the staged candidate rows and their metadata, and a few ints.
// ops.py `query_smem_bytes` computes the same size.
struct Layout {
  int q, front, cand_id, cand_pos, keys, stage, meta0, meta1, misc, bytes;
  int front_stride;  // bytes from one frontier buffer to the other
};

__host__ __device__ inline Layout layout(int q_floats, int L, int R, int stage_rows,
                                         int stride, int mma) {
  Layout l{};
  int off = 0;
  l.q = off;
  off += align16(q_floats * (mma ? 6 : 4));  // three bf16 parts, or f32
  l.front = off;
  l.front_stride = 3 * align16(L * 4);
  off += 2 * l.front_stride;
  l.cand_id = off;
  off += align16(R * 4);
  l.cand_pos = off;
  off += align16(R * 4);
  l.keys = off;
  off += align16(pow2_at_least(R) * 8);
  l.stage = off;
  off += stage_rows * stride;
  l.meta0 = off;
  off += align16(stage_rows * 4);
  l.meta1 = off;
  off += align16(stage_rows * 4);
  l.misc = off;
  off += 32;
  l.bytes = off;
  return l;
}

// One query's view of its shared memory. Frontier buffer b: ids at
// ids + b * stride, and likewise dists and visited (no runtime-indexed
// arrays, which would go to local memory).
struct Query {
  float* q;
  int32_t* ids;
  float* dists;
  int32_t* vis;
  int stride;  // in 4-byte elements
  int32_t* cand_id;   // (R) id of each valid candidate, by position
  int32_t* cand_pos;  // (R) positions of the valid candidates, compacted
  Key* keys;          // (pow2 >= R) sort keys of the candidates that may enter
  unsigned char* stage;  // (stage_rows, stride) the staged candidate rows
  float* meta0;       // (stage_rows) their data_add or squared norms
  float* meta1;       // (stage_rows) their data_rescale
  int32_t* misc;      // [0] valid candidates, [1] keys
};

__device__ __forceinline__ Query carve(unsigned char* smem, int slot, const Args& a) {
  const Layout l = layout(a.q_floats, a.L, a.R, a.stage_rows, a.stride, a.mma);
  unsigned char* base = smem + static_cast<size_t>(slot) * l.bytes;
  const int col = align16(a.L * 4);
  Query s;
  s.q = reinterpret_cast<float*>(base + l.q);
  s.ids = reinterpret_cast<int32_t*>(base + l.front);
  s.dists = reinterpret_cast<float*>(base + l.front + col);
  s.vis = reinterpret_cast<int32_t*>(base + l.front + 2 * col);
  s.stride = l.front_stride / 4;
  s.cand_id = reinterpret_cast<int32_t*>(base + l.cand_id);
  s.cand_pos = reinterpret_cast<int32_t*>(base + l.cand_pos);
  s.keys = reinterpret_cast<Key*>(base + l.keys);
  s.stage = base + l.stage;
  s.meta0 = reinterpret_cast<float*>(base + l.meta0);
  s.meta1 = reinterpret_cast<float*>(base + l.meta1);
  s.misc = reinterpret_cast<int32_t*>(base + l.misc);
  return s;
}

// --------------------------------------------------------- warp steps
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// --------------------------------------------------------- sort keys
// (distance, position) as one ascending 64-bit key. -0 becomes +0, so
// that keys tie where the floats compare equal.
__device__ __forceinline__ Key sort_key(float d, int pos) {
  uint32_t b = __float_as_uint(__fadd_rn(d, 0.f));
  b ^= (b >> 31) ? 0xffffffffu : 0x80000000u;
  return (static_cast<Key>(b) << 32) | static_cast<uint32_t>(pos);
}

__device__ __forceinline__ float key_dist(Key k) {
  uint32_t b = static_cast<uint32_t>(k >> 32);
  b ^= (b >> 31) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(b);
}

// Count of keys[0, n) below every key of distance d.
__device__ __forceinline__ int count_nearer(const Key* keys, int n, float d) {
  const Key target = sort_key(d, 0) & 0xffffffff00000000ull;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Count of the sorted dists[0, n) at most d.
__device__ __forceinline__ int count_no_farther(const float* dists, int n, float d) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dists[mid] <= d) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ Key min64(Key x, Key y) { return x < y ? x : y; }
__device__ __forceinline__ Key max64(Key x, Key y) { return x < y ? y : x; }

// Ascending bitonic sort of keys[0, np), np a power of two: up to 64 keys
// in registers (two a lane, exchanges by shuffle; keys past np are ~0 and
// stay last), more in shared memory.
__device__ __forceinline__ void sort_keys(Key* keys, int np) {
  const int lane = lane_id();
  if (np <= 64) {
    Key x0 = lane < np ? keys[lane] : ~0ull;
    Key x1 = lane + 32 < np ? keys[lane + 32] : ~0ull;
    for (int k = 2; k <= np; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j == 32) {  // partners in the same lane: index lane vs lane + 32
          const Key lo = min64(x0, x1);
          x1 = max64(x0, x1);
          x0 = lo;
          continue;
        }
        const Key y0 = __shfl_xor_sync(jasper::kFullMask, x0, j);
        const Key y1 = __shfl_xor_sync(jasper::kFullMask, x1, j);
        const bool low = (lane & j) == 0;
        const bool up0 = (lane & k) == 0;
        const bool up1 = ((lane + 32) & k) == 0;
        x0 = (low == up0) ? min64(x0, y0) : max64(x0, y0);
        x1 = (low == up1) ? min64(x1, y1) : max64(x1, y1);
      }
    }
    if (lane < np) keys[lane] = x0;
    if (lane + 32 < np) keys[lane + 32] = x1;
    __syncwarp();
    return;
  }
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < np / 2; i += 32) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const Key x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & k) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- scoring
// The dot of one packed 32-bit word with q. A code is made an exact float
// without an int-to-float conversion (a sixteenth of the FMA rate on this
// card): masked in place in the low or high half word and put in the
// mantissa of 2^23, 2^23 off again, it is code * 2^shift; q was stored
// scaled by 2^-shift for that place (`load_vector`), so each product is
// exactly code * q.
template <int BITS>
__device__ __forceinline__ float word_dot(uint32_t w, const float* __restrict__ q) {
  constexpr int kN = 32 / BITS;   // codes a word
  constexpr int kHalf = kN / 2;   // codes a half word
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  float qq[kN];
#pragma unroll
  for (int j = 0; j < kN; j += 4) {
    const float4 f = *reinterpret_cast<const float4*>(q + j);
    qq[j] = f.x;
    qq[j + 1] = f.y;
    qq[j + 2] = f.z;
    qq[j + 3] = f.w;
  }
  const uint32_t hi = w >> 16;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const uint32_t bits = (j < kHalf ? w : hi) & (kMask << ((j % kHalf) * BITS));
    acc = fmaf(__fsub_rn(__uint_as_float(0x4b000000u | bits), 8388608.f), qq[j], acc);
  }
  return acc;
}

// The dot of 16-byte unit u of a staged row with q: packed codes, or four
// floats of an exact row.
template <bool QUANT, int BITS>
__device__ __forceinline__ float unit_dot(const unsigned char* row, const float* q, int u) {
  if constexpr (QUANT) {
    constexpr int kW = 32 / BITS;
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * u);
    const float* qq = q + u * 4 * kW;
    return (word_dot<BITS>(v.x, qq) + word_dot<BITS>(v.y, qq + kW)) +
           (word_dot<BITS>(v.z, qq + 2 * kW) + word_dot<BITS>(v.w, qq + 3 * kW));
  } else {
    const float4 v = *reinterpret_cast<const float4*>(row + 16 * u);
    const float4 qq = *reinterpret_cast<const float4*>(q + 4 * u);
    float acc = v.x * qq.x;
    acc = fmaf(v.y, qq.y, acc);
    acc = fmaf(v.z, qq.z, acc);
    return fmaf(v.w, qq.w, acc);
  }
}

// Stage the code rows and metadata of compacted candidates [c0, c0 + m)
// in shared memory: every copy is issued (cp.async, 16 or 4 bytes; rows
// that are neither load bytes) before any is waited for. A group of G
// lanes takes a row, lane g its chunks g, g + G, ...; lane 0 of the group
// also its data_add (norm), lane 1 (0 when G = 1) its data_rescale.
template <bool QUANT>
__device__ __forceinline__ void stage_rows(const Args& a, const Query& s, int c0, int m) {
  const int t = lane_id();
  const int glog = a.group_log2;
  const int G = 1 << glog;
  const int g = t & (G - 1);
  const unsigned char* data = static_cast<const unsigned char*>(a.data);
  for (int c = t >> glog; c < m; c += 32 >> glog) {
    const int id = s.cand_id[s.cand_pos[c0 + c]];
    const unsigned char* src = data + static_cast<size_t>(id) * a.row_bytes;
    unsigned char* dst = s.stage + c * a.stride;
    if (a.vec == 16) {
      for (int u = g; u < a.units; u += G) jasper::cp_async16(dst + 16 * u, src + 16 * u, true);
    } else if (a.vec == 4) {
      for (int w = g; w < a.row_bytes / 4; w += G)
        jasper::cp_async4(dst + 4 * w, src + 4 * w, true);
    } else {
      for (int b = g; b < a.row_bytes; b += G) dst[b] = __ldg(src + b);
    }
    if (g == 0) jasper::cp_async4(s.meta0 + c, a.meta0 + id, true);
    if (QUANT && g == (G > 1 ? 1 : 0)) jasper::cp_async4(s.meta1 + c, a.meta1 + id, true);
  }
  jasper::cp_async_commit();
  jasper::cp_async_wait<0>();
  __syncwarp();
}

// Append `key` when `enter`: every lane of the warp calls it together.
__device__ __forceinline__ void append_key(const Query& s, bool enter, Key key) {
  const int lane = lane_id();
  const unsigned vote = __ballot_sync(jasper::kFullMask, enter);
  int at = 0;
  if (lane == 0 && vote) at = atomicAdd(s.misc + 1, __popc(vote));
  at = __shfl_sync(jasper::kFullMask, at, 0);
  if (enter) s.keys[at + __popc(vote & ((1u << lane) - 1u))] = key;
}

// Distances of the staged candidates [c0, c0 + m): a group of G lanes a
// candidate, reduced by a segmented shuffle. Only a candidate nearer than
// `thresh` (the frontier's distance at the last kept slot) can enter the
// kept frontier; its sort key is appended to keys (count in misc[1]).
template <bool QUANT, int BITS>
__device__ __forceinline__ void score_stage(const Args& a, const Query& s, int c0, int m,
                                            float qa, float qb, float thresh) {
  const int t = lane_id();
  const int glog = a.group_log2;
  const int G = 1 << glog;
  const int g = t & (G - 1);
  const int step = 32 >> glog;
  for (int base = 0; base < m; base += step) {  // uniform over the warp
    const int c = base + (t >> glog);
    float acc = 0.f;
    if (c < m) {
      const unsigned char* row = s.stage + c * a.stride;
      for (int u = g; u < a.units; u += G) acc += unit_dot<QUANT, BITS>(row, s.q, u);
    }
    for (int off = G >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(jasper::kFullMask, acc, off);
    bool enter = false;
    Key key = 0;
    if (c < m && g == 0) {
      const float d = QUANT ? jasper::rabitq_epilogue(s.meta0[c], qa, s.meta1[c], acc, qb)
                            : jasper::l2_epilogue(qa, acc, s.meta0[c]);
      enter = d < thresh;
      key = sort_key(d, s.cand_pos[c0 + c]);
    }
    append_key(s, enter, key);
  }
}

// The tensor-core score of 4-bit rows made of whole 64-byte groups (the
// main path: one group at D = 128). A tile of 16 staged rows is the A
// operand of mma.sync m16n8k16, the query the B operand: split exactly
// into three bf16 parts (q = h0 + h1 + h2, each part 8 significant bits
// of the 24), part n in column n, so that every product code * h is exact
// and dot = sum over the three columns. A quad of lanes reads a row as
// four 16-byte units; each 32-bit word gives four bf16x2 pairs of codes
// (nibbles m and m + 4, put in the mantissa of 128 and 128 taken off), and
// the k positions of a 16-code step map to dims as `mma_dim` says (the
// query's parts are stored in that order by `load_vector`). On integer
// operands every sum is exact, so the result is the SIMT path's bit for
// bit; otherwise the tensor core's f32 accumulation is within rounding.
__device__ __forceinline__ int mma_dim(int unit, int step, int slot, int e) {
  return 32 * unit + 8 * (step >> 1) + 2 * (step & 1) + slot + 4 * e;
}

__device__ __forceinline__ unsigned codes_bf16(uint32_t w, int m) {
  return jasper::bf16x2_fma(((w >> (4 * m)) & 0x000f000fu) | 0x43004300u, 0x3f803f80u,
                            0xc300c300u);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The top 16 bits of x rounded to nearest even: x as bf16.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ void score_stage_mma(const Args& a, const Query& s, int c0, int m,
                                                float qa, float qb, float thresh) {
  const int lane = lane_id();
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int groups = a.units >> 2;
  const uint2* qp = reinterpret_cast<const uint2*>(s.q);
  const int tiles = (m + 15) >> 4;
  for (int mt = 0; mt < tiles; ++mt) {
    const int ca = 16 * mt + g;
    const unsigned char* ra = s.stage + ca * a.stride + 16 * t4;
    const unsigned char* rb = ra + 8 * a.stride;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int gi = 0; gi < groups; ++gi) {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 va = ca < m ? *reinterpret_cast<const uint4*>(ra + 64 * gi) : zero;
      const uint4 vb = ca + 8 < m ? *reinterpret_cast<const uint4*>(rb + 64 * gi) : zero;
      const uint2* bq = qp + (g * groups + gi) * 32 + t4;
#pragma unroll
      for (int step = 0; step < 8; ++step) {
        const uint32_t wa = word_of(va, step >> 1);
        const uint32_t wb = word_of(vb, step >> 1);
        const int m0 = 2 * (step & 1);
        const unsigned frag[4] = {codes_bf16(wa, m0), codes_bf16(wb, m0),
                                  codes_bf16(wa, m0 + 1), codes_bf16(wb, m0 + 1)};
        const uint2 b = g < 3 ? bq[4 * step] : make_uint2(0, 0);
        jasper::mma_bf16(acc, frag, b.x, b.y);
      }
    }
    // rows ca and ca + 8: columns 0 and 1 in this lane, column 2 in the next
    float x0 = acc[0] + acc[1];
    float x1 = acc[2] + acc[3];
    x0 += __shfl_down_sync(jasper::kFullMask, x0, 1);
    x1 += __shfl_down_sync(jasper::kFullMask, x1, 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = ca + 8 * half;
      bool enter = false;
      Key key = 0;
      if (t4 == 0 && c < m) {
        const float d =
            jasper::rabitq_epilogue(s.meta0[c], qa, s.meta1[c], half ? x1 : x0, qb);
        enter = d < thresh;
        key = sort_key(d, s.cand_pos[c0 + c]);
      }
      append_key(s, enter, key);
    }
  }
}

// The frontier's first live unvisited slot, or L (uniform over the query).
__device__ __forceinline__ int first_open(const int32_t* fi, const int32_t* fv, int L) {
  int first = L;
  for (int i = lane_id(); i < L; i += 32) {
    if (fi[i] >= 0 && fv[i] == 0) {
      first = i;
      break;
    }
  }
  return __reduce_min_sync(jasper::kFullMask, first);
}

struct Counters {
  int scored = 0, masked = 0, dups = 0;
};

// One hop of one query from frontier buffer `cur` into buffer cur ^ 1.
// Returns -1, having changed nothing, when the frontier has no unvisited
// slot (uniform over the query). Otherwise expands, scores and merges,
// narrows to `width`, and returns the live slots after the narrowing with
// TEL (the occupancy telemetry), else 0; with TEL, cnt grows by this
// thread's share of the hop's counts.
template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
__device__ __forceinline__ int hop(const Args& a, const Query& s, const int cur,
                                   const int width,
                   const float qa, const float qb, Counters& cnt) {
  const int L = a.L;
  const int R = a.R;
  const int t = lane_id();
  const int32_t* fi = s.ids + cur * s.stride;
  const float* fd = s.dists + cur * s.stride;
  int32_t* fv = s.vis + cur * s.stride;
  int32_t* ni = s.ids + (cur ^ 1) * s.stride;
  float* nd = s.dists + (cur ^ 1) * s.stride;
  int32_t* nv = s.vis + (cur ^ 1) * s.stride;

  // ---- pick: first unvisited slot (the frontier is distance-sorted)
  const int pick = first_open(fi, fv, L);
  if (pick >= L) return -1;  // uniform: converged
  const int node = min(max(fi[pick], 0), a.cap - 1);

  // ---- expand: all of the adjacency row's reads at once ...
  const int32_t* adj = a.adj + static_cast<size_t>(node) * R;
  int nb[kAdjRegs];
#pragma unroll
  for (int k = 0; k < kAdjRegs; ++k) {
    const int j = k * 32 + t;
    nb[k] = j < R ? __ldg(adj + j) : -1;
  }
  // ... then the dup test of this thread's candidates: a scan of the
  // frontier's ids, four at a time, each read by every t at once (no
  // atomics, no barrier; the ids' padding is -1, as no candidate in range is)
  bool dup[kAdjRegs] = {};
  const int4* f4 = reinterpret_cast<const int4*>(fi);
  for (int f = 0; f < (L + 3) / 4; ++f) {
    const int4 v = f4[f];
#pragma unroll
    for (int k = 0; k < kAdjRegs; ++k)
      dup[k] |= (nb[k] == v.x) | (nb[k] == v.y) | (nb[k] == v.z) | (nb[k] == v.w);
  }
  if (t == 0) {
    s.misc[0] = 0;
    s.misc[1] = 0;
  }
  __syncwarp();

  // validity epilogue of candidate j (id: its adjacency entry, in the
  // frontier when in_frontier) and its place in the compacted list; every
  // lane of the warp calls it together
  auto classify = [&](const int j, const int id, const bool in_frontier) {
    const bool in_range =
        j < R && id >= 0 && id < (a.n_valid_dev != nullptr ? __ldg(a.n_valid_dev) : a.n_valid);
    const bool dup = in_range && in_frontier;
    bool valid = in_range && !dup;
    bool dead = false, fmiss = false;
    if (USE_TOMB && valid) {
      dead = ((__ldg(a.tomb + (id >> 3)) >> (id & 7)) & 1) != 0;
      valid = !dead;
    }
    if (USE_FILT && valid) {
      fmiss = (__ldg(a.labels + id) & (a.fb_dev != nullptr ? __ldg(a.fb_dev) : a.fb)) == 0;
      valid = !fmiss;
    }
    if (TEL) {
      cnt.scored += valid;
      cnt.masked += dead || fmiss;
      cnt.dups += dup;
    }
    const unsigned vote = __ballot_sync(jasper::kFullMask, valid);
    int base = 0;
    if (t == 0 && vote) base = atomicAdd(s.misc, __popc(vote));
    base = __shfl_sync(jasper::kFullMask, base, 0);
    if (valid) {
      s.cand_pos[base + __popc(vote & ((1u << t) - 1u))] = j;
      s.cand_id[j] = id;
    }
  };
#pragma unroll
  for (int k = 0; k < kAdjRegs; ++k) classify(k * 32 + t, nb[k], dup[k]);
  for (int j0 = kAdjRegs * 32; j0 < R; j0 += 32) {
    const int id = j0 + t < R ? __ldg(adj + j0 + t) : -1;
    bool in_frontier = false;
    for (int f = 0; f < L; ++f) in_frontier |= fi[f] == id;
    classify(j0 + t, id, in_frontier);
  }
  if (t == 0) fv[pick] = 1;
  __syncwarp();
  const int n = s.misc[0];

  // ---- score: the rows of a stage (every candidate of the main path's
  // R = 64) in flight together; only candidates that can enter the kept
  // frontier go on to the sort
  const int keep = min(L, width);
  const float thresh = keep > 0 ? fd[keep - 1] : -INFINITY;
  for (int c0 = 0; c0 < n; c0 += a.stage_rows) {
    const int m = min(a.stage_rows, n - c0);
    stage_rows<QUANT>(a, s, c0, m);
    if (QUANT && BITS == 4 && a.mma) {
      score_stage_mma(a, s, c0, m, qa, qb, thresh);
    } else {
      score_stage<QUANT, BITS>(a, s, c0, m, qa, qb, thresh);
    }
    __syncwarp();  // the stage is read before it is staged again
  }
  const int nk = s.misc[1];

  const int np = pow2_at_least(nk);
  for (int i = nk + t; i < np; i += 32) s.keys[i] = ~0ull;
  __syncwarp();
  if (np > 1) sort_keys(s.keys, np);

  // ---- merge by rank, stable; narrow to this hop's width. A candidate
  // that did not enter is no nearer than any kept frontier slot, so the
  // keys alone give every kept rank.
  int live = 0;
  for (int i = t; i < L; i += 32) {
    const float d = fd[i];
    const int rank = i + count_nearer(s.keys, nk, d);
    if (rank < keep) {
      const int id = fi[i];
      ni[rank] = id;
      nd[rank] = d;
      nv[rank] = fv[i];
      live += id >= 0;
    }
  }
  for (int k = t; k < nk; k += 32) {
    const Key key = s.keys[k];
    const float d = key_dist(key);
    const int rank = k + count_no_farther(fd, L, d);
    if (rank < keep) {
      ni[rank] = s.cand_id[static_cast<uint32_t>(key)];
      nd[rank] = d;
      nv[rank] = 0;
      ++live;
    }
  }
  for (int i = max(keep, 0) + t; i < L; i += 32) {
    ni[i] = -1;
    nd[i] = INFINITY;
    nv[i] = 0;
  }
  __syncwarp();
  return TEL ? __reduce_add_sync(jasper::kFullMask, live) : 0;
}

// The query's frontier (into buffer 0) from device memory; the ids'
// padding to 16 bytes (both buffers) is -1.
__device__ __forceinline__ void load_frontier(const Args& a, const Query& s, int qi) {
  const int t = lane_id();
  const size_t fo = static_cast<size_t>(qi) * a.L;
  for (int i = t; i < a.L; i += 32) {
    s.ids[i] = __ldg(a.f_ids + fo + i);
    s.dists[i] = __ldg(a.f_dists + fo + i);
    s.vis[i] = __ldg(a.f_vis + fo + i);
  }
  for (int i = a.L + t; i < align16(a.L * 4) / 4; i += 32) {
    s.ids[i] = -1;
    s.ids[s.stride + i] = -1;
  }
}

// The query's vector from device memory, padded with zeros to whole
// 16-byte units of its row: for the tensor cores as three bf16 parts in
// fragment order; for packed codes on the SIMT path scaled for `word_dot`
// (code i of a word sits at shift BITS * (i mod half a word's codes)).
// Rows that are not whole units are staged over zeros, which the stage
// keeps (each row is copied to the same bytes every time).
template <bool QUANT, int BITS>
__device__ __forceinline__ void load_vector(const Args& a, const Query& s, int qi) {
  const int t = lane_id();
  const float* q = a.q + static_cast<size_t>(qi) * a.dq;
  if (QUANT && BITS == 4 && a.mma) {
    // entry ((n * groups + gi) * 8 + step) * 4 + t4: part n's B fragment
    // pair of k-step `step` of unit group gi for the lanes of quad t4; a
    // thread splits its four dims once and writes all three parts
    const int groups = a.units >> 2;
    uint2* qp = reinterpret_cast<uint2*>(s.q);
    for (int i = t; i < groups * 32; i += 32) {
      const int t4 = i & 3;
      const int step = (i >> 2) & 7;
      const int gi = i >> 5;
      uint32_t part[3][2][2];
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = mma_dim(4 * gi + t4, step, slot, e);
          const float x = d < a.dq ? __ldg(q + d) : 0.f;
          const uint32_t h0 = bf16_bits(x);
          const float r1 = __fsub_rn(x, __uint_as_float(h0 << 16));
          const uint32_t h1 = bf16_bits(r1);
          part[0][slot][e] = h0;
          part[1][slot][e] = h1;
          part[2][slot][e] = bf16_bits(__fsub_rn(r1, __uint_as_float(h1 << 16)));
        }
      }
#pragma unroll
      for (int n = 0; n < 3; ++n)
        qp[n * groups * 32 + i] = make_uint2(part[n][0][0] | (part[n][0][1] << 16),
                                             part[n][1][0] | (part[n][1][1] << 16));
    }
  } else {
    for (int i = t; i < a.q_floats; i += 32) {
      float v = i < a.dq ? __ldg(q + i) : 0.f;
      if (QUANT) v = __fmul_rn(v, __uint_as_float((127u - (i % (16 / BITS)) * BITS) << 23));
      s.q[i] = v;
    }
  }
  if (a.vec != 16) {
    int4* stage4 = reinterpret_cast<int4*>(s.stage);
    for (int i = t; i < a.stage_rows * a.stride / 16; i += 32)
      stage4[i] = make_int4(0, 0, 0, 0);
  }
}

template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks) fused_search_kernel(const Args a,
                                                                                 int) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = threadIdx.x / 32;
  const int qi = blockIdx.x * kQueriesPerBlock + slot;
  if (qi >= a.num_q) return;  // a whole query (a whole block when it owns one)
  const Query s = carve(smem, slot, a);
  const int t = lane_id();
  load_frontier(a, s, qi);
  load_vector<QUANT, BITS>(a, s, qi);
  __syncwarp();
  const float qa = a.qa[qi];
  const float qb = a.qb[qi];
  Counters cnt;
  int cur = 0, hops = 0;
  for (int it = 0; it < a.max_iters; ++it) {
    const int live =
        hop<QUANT, BITS, USE_TOMB, USE_FILT, TEL>(a, s, cur, __ldg(a.sched + it), qa, qb, cnt);
    if (live < 0) break;
    cur ^= 1;
    ++hops;
    if (TEL && t == 0) a.out_occ[static_cast<size_t>(qi) * a.max_iters + it] = live;
  }
  const size_t fo = static_cast<size_t>(qi) * a.L;
  for (int i = t; i < a.L; i += 32) {
    a.out_ids[fo + i] = s.ids[cur * s.stride + i];
    a.out_dists[fo + i] = s.dists[cur * s.stride + i];
  }
  if (t == 0) a.out_hops[qi] = hops;
  if (TEL) {
    for (int it = hops + t; it < a.max_iters; it += 32)
      a.out_occ[static_cast<size_t>(qi) * a.max_iters + it] = 0;
    const int scored = __reduce_add_sync(jasper::kFullMask, cnt.scored);
    const int masked = __reduce_add_sync(jasper::kFullMask, cnt.masked);
    const int dups = __reduce_add_sync(jasper::kFullMask, cnt.dups);
    if (t == 0) {
      a.out_counters[qi * 3 + 0] = scored;
      a.out_counters[qi * 3 + 1] = masked;
      a.out_counters[qi * 3 + 2] = dups;
    }
  }
}

// One hop per launch: frontier in from device memory, one `hop` at
// `width`, frontier out with a (Q,) 0/1 hop increment and, with TEL, a
// (Q, 4) [scored, masked, dups, occupancy] block. A row with no unvisited
// slot copies its frontier through unchanged with increment 0 and zero
// counters, as fused_hop_ref leaves it.
template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
    fused_hop_kernel(const Args a, const int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = threadIdx.x / 32;
  const int qi = blockIdx.x * kQueriesPerBlock + slot;
  if (qi >= a.num_q) return;
  const Query s = carve(smem, slot, a);
  const int t = lane_id();
  load_frontier(a, s, qi);
  __syncwarp();
  Counters cnt;
  int live = -1;
  if (first_open(s.ids, s.vis, a.L) < a.L) {  // else no hop: skip the query
    load_vector<QUANT, BITS>(a, s, qi);
    __syncwarp();
    live = hop<QUANT, BITS, USE_TOMB, USE_FILT, TEL>(a, s, 0, width, a.qa[qi], a.qb[qi], cnt);
  }
  const int cur = live >= 0 ? 1 : 0;
  const size_t fo = static_cast<size_t>(qi) * a.L;
  for (int i = t; i < a.L; i += 32) {
    a.out_ids[fo + i] = s.ids[cur * s.stride + i];
    a.out_dists[fo + i] = s.dists[cur * s.stride + i];
    a.out_vis[fo + i] = s.vis[cur * s.stride + i];
  }
  if (t == 0) a.out_hops[qi] = live >= 0 ? 1 : 0;
  if (TEL) {
    const int scored = __reduce_add_sync(jasper::kFullMask, cnt.scored);
    const int masked = __reduce_add_sync(jasper::kFullMask, cnt.masked);
    const int dups = __reduce_add_sync(jasper::kFullMask, cnt.dups);
    if (t == 0) {
      a.out_counters[qi * 4 + 0] = scored;
      a.out_counters[qi * 4 + 1] = masked;
      a.out_counters[qi * 4 + 2] = dups;
      a.out_counters[qi * 4 + 3] = live >= 0 ? live : 0;
    }
  }
}

// ------------------------------------------------------------------ host
// How the kernels load a row: 16-byte units when the row's width and the
// table's base allow it, else 4-byte words, else bytes (floats: float4 or
// float); a power-of-two group of lanes (at most 32) shares a candidate.
void set_rows(Args& a, bool quantized, int bits) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.data);
  a.row_bytes = quantized ? a.row_width : a.row_width * 4;
  if (a.row_bytes % 16 == 0 && base % 16 == 0) {
    a.vec = 16;
  } else if (!quantized || (a.row_bytes % 4 == 0 && base % 4 == 0)) {
    a.vec = 4;
  } else {
    a.vec = 1;
  }
  a.units = (a.row_bytes + 15) / 16;
  a.group_log2 = 0;
  while ((1 << a.group_log2) < a.units && (2 << a.group_log2) <= kMaxGroup) ++a.group_log2;
  a.mma = quantized && bits == 4 && a.units % 4 == 0;
  // an odd count of units a stride puts the rows a SIMT round reads on
  // distinct banks; a tensor-core tile reads two rows' units contiguously
  a.stride = 16 * (a.mma || a.units % 2 == 1 ? a.units : a.units + 1);
  const int fit = kStageBytes / a.stride;
  a.stage_rows = fit < 1 ? 1 : (fit < a.R ? fit : a.R);
  a.q_floats = a.units * (quantized ? 128 / bits : 4);
}

using KernelFn = void (*)(const Args, int);

// width < 0: the megakernel over the schedule; else one hop at `width`.
// With `info`, launch nothing and report the kernel's [registers, resident
// queries per SM, shared bytes a block, local bytes a thread, queries a
// block].
template <bool QUANT, int BITS, bool USE_TOMB, bool USE_FILT, bool TEL>
int launch(const Args& a, int width, cudaStream_t s, int* info) {
  const KernelFn kern = width < 0 ? fused_search_kernel<QUANT, BITS, USE_TOMB, USE_FILT, TEL>
                                  : fused_hop_kernel<QUANT, BITS, USE_TOMB, USE_FILT, TEL>;
  const int smem =
      layout(a.q_floats, a.L, a.R, a.stage_rows, a.stride, a.mma).bytes * kQueriesPerBlock;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (smem > 48 * 1024 &&
      (err = static_cast<int>(cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))) != 0)
    return err;
  if (info != nullptr) {
    cudaFuncAttributes attr;
    if ((err = static_cast<int>(cudaFuncGetAttributes(&attr, kern))) != 0) return err;
    int blocks = 0;
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kBlockThreads, smem));
    if (err != 0) return err;
    info[0] = attr.numRegs;
    info[1] = blocks * kQueriesPerBlock;
    info[2] = smem;
    info[3] = static_cast<int>(attr.localSizeBytes);
    info[4] = kQueriesPerBlock;
    return 0;
  }
  const int grid = (a.num_q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  kern<<<grid, kBlockThreads, smem, s>>>(a, width);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT, int BITS>
int dispatch_flags(const Args& a, bool t, bool f, int tel, int width, cudaStream_t s,
                   int* info) {
  if (tel) {
    if (t && f) return launch<QUANT, BITS, true, true, true>(a, width, s, info);
    if (t) return launch<QUANT, BITS, true, false, true>(a, width, s, info);
    if (f) return launch<QUANT, BITS, false, true, true>(a, width, s, info);
    return launch<QUANT, BITS, false, false, true>(a, width, s, info);
  }
  if (t && f) return launch<QUANT, BITS, true, true, false>(a, width, s, info);
  if (t) return launch<QUANT, BITS, true, false, false>(a, width, s, info);
  if (f) return launch<QUANT, BITS, false, true, false>(a, width, s, info);
  return launch<QUANT, BITS, false, false, false>(a, width, s, info);
}

int dispatch(Args a, int quantized, int bits, bool tomb, bool filt, int tel, int width,
             cudaStream_t s, int* info) {
  set_rows(a, quantized != 0, bits);
  if (!quantized) return dispatch_flags<false, 8>(a, tomb, filt, tel, width, s, info);
  switch (bits) {
    case 1: return dispatch_flags<true, 1>(a, tomb, filt, tel, width, s, info);
    case 2: return dispatch_flags<true, 2>(a, tomb, filt, tel, width, s, info);
    case 4: return dispatch_flags<true, 4>(a, tomb, filt, tel, width, s, info);
    case 8: return dispatch_flags<true, 8>(a, tomb, filt, tel, width, s, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_search_launch(
    const int32_t* f_ids, const float* f_dists, const int32_t* f_vis, int num_q, int L,
    const int32_t* sched, int max_iters, const float* q, int dq, const float* qa,
    const float* qb, const int32_t* adj, int R, int cap, int n_valid, const void* data,
    int row_width, const float* meta0, const float* meta1, const uint8_t* tomb,
    const uint32_t* labels, uint32_t fb, const int32_t* n_valid_dev, const uint32_t* fb_dev,
    int quantized, int bits, int telemetry, int32_t* out_ids, float* out_dists,
    int32_t* out_hops, int32_t* out_counters, int32_t* out_occ, void* stream) {
  Args a{f_ids,   f_dists, f_vis,  num_q,     L,         sched,    max_iters, q,
         dq,      qa,      qb,     adj,       R,         cap,      n_valid,   data,
         row_width, meta0, meta1,  tomb,      labels,    fb,       n_valid_dev, fb_dev,
         out_ids, out_dists, out_hops, out_counters, out_occ, nullptr};
  return dispatch(a, quantized, bits, tomb != nullptr, labels != nullptr, telemetry, -1,
                  static_cast<cudaStream_t>(stream), nullptr);
}

extern "C" int fused_hop_launch(
    const int32_t* f_ids, const float* f_dists, const int32_t* f_vis, int num_q, int L,
    int width, const float* q, int dq, const float* qa, const float* qb, const int32_t* adj,
    int R, int cap, int n_valid, const void* data, int row_width, const float* meta0,
    const float* meta1, const uint8_t* tomb, const uint32_t* labels, uint32_t fb,
    const int32_t* n_valid_dev, const uint32_t* fb_dev, int quantized, int bits,
    int telemetry, int32_t* out_ids, float* out_dists, int32_t* out_vis, int32_t* out_inc,
    int32_t* out_counters, void* stream) {
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{f_ids,   f_dists, f_vis,  num_q,     L,         nullptr,  0,         q,
         dq,      qa,      qb,     adj,       R,         cap,      n_valid,   data,
         row_width, meta0, meta1,  tomb,      labels,    fb,       n_valid_dev, fb_dev,
         out_ids, out_dists, out_inc, out_counters, nullptr, out_vis};
  return dispatch(a, quantized, bits, tomb != nullptr, labels != nullptr, telemetry, width,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The registers, resident queries per SM (the occupancy API), shared bytes
// a block, local bytes a thread and queries a block of one instance:
// fused_hop's when hop_kernel, else fused_search's, for (L, R, dq) and a
// row of row_width bytes (QUANT) or floats, 16-byte aligned. Writes
// info[0..4]; returns the CUDA error code.
extern "C" int fused_search_occupancy(int hop_kernel, int quantized, int bits, int tomb,
                                      int filt, int telemetry, int L, int R, int dq,
                                      int row_width, int* info) {
  Args a{};
  a.L = L;
  a.R = R;
  a.dq = dq;
  a.row_width = row_width;
  return dispatch(a, quantized, bits, tomb != 0, filt != 0, telemetry, hop_kernel ? 0 : -1,
                  nullptr, info);
}
