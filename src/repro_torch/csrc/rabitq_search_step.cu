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
// Design: one warp a query, four queries a block (fewer when a query's
// shared slot is large), no block barrier. A query's K ids arrive in one
// coalesced round; then every in-range candidate's code row goes to
// shared memory by cp.async (16-byte units where the rows allow, 4- or
// 1-byte ones otherwise) while its two metadata floats, tombstone byte
// and label word go to the registers of the lane that owns its id — all
// in one round, one wait. A tombstoned or filtered row in range is loaded
// anyway (it saves the round its mask would cost) and gets +inf. Rows
// score from shared memory with rabitq_rows.cuh's scorer (a group of G
// lanes a row in a whole warp's order, eight FMA chains a lane, codes
// made floats exactly by a byte permute), which
// rabitq_gather_distance (rabitq_distance.cu) shares, so the two kernels
// score a row alike, bit for bit: the scoring, not the bytes, is most of
// the time. A round stages up to kStageBytes of rows (128 rows at most);
// wider rows (2,304 B at D = 4,608, 4 bits) take several rounds. Outputs
// leave as one coalesced write a round. Invalid candidates (id < 0, id >=
// n_valid or n, tombstoned, out of filter) get +inf; out = max(add + qa +
// rescale * (dot - qsum), 0) otherwise.

#include "rabitq_rows.cuh"

namespace {

constexpr int kMaxWarps = 4;         // warps (queries) a block
constexpr int kStageBytes = 16384;   // staged code rows a query a round
constexpr int kMaxRows = 128;        // rows a round: four ids a lane
constexpr int kSmemLimit = 232448;   // shared bytes a block may use

// A query's (a warp's) shared slot: the query (P * 8/BITS floats), for
// rows of more than 32 units (32-bit words, or bytes; shorter rows keep
// the query in registers), the staged rows (a stride of whole 16-byte
// units), then the round's ids and dots. ops.py `step_smem_bytes`
// computes the same.
struct Slot {
  int q_bytes, stride, rows, bytes;
};

__host__ __device__ inline Slot slot_of(int k, int p, int bits) {
  Slot s;
  const int units = (p & 3) == 0 ? p >> 2 : p;  // words, or bytes, a row
  s.q_bytes = units > 32 ? (p * (8 / bits) * 4 + 15) & ~15 : 0;
  s.stride = (p + 15) & ~15;
  int rows = kStageBytes / s.stride;
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  s.rows = k < rows ? k : rows;
  s.bytes = (s.q_bytes + s.rows * s.stride + s.rows * 8 + 15) & ~15;
  return s;
}

struct Args {
  const int32_t* ids;
  const uint8_t* packed;
  const float* add;
  const float* rescale;
  const uint8_t* tomb;
  const uint32_t* labels;
  const float* q;
  const float* qa;
  const float* qsum;
  float* out;
  int num_q, k, p, n, n_valid;
  uint32_t fb;
};

// Copies of rows [0, m) of the round (ids in sid) into the stage: each row
// UNIT bytes at a time, a group of lanes a row; rows out of range are not
// read. UNIT 1 is a plain copy (rows whose width is not a multiple of 4).
template <int UNIT>
__device__ __forceinline__ void stage_rows(const Args& a, const int32_t* sid, int m,
                                           unsigned char* stage, int stride, int lane) {
  const int units = a.p / UNIT;
  const int G = units < 32 ? jasper::pow2_at_least(units) : 32;
  const int per = 32 / G;
  const int g = lane & (G - 1);
  for (int r0 = 0; r0 < m; r0 += per) {
    const int r = r0 + lane / G;
    if (r >= m) continue;
    const int id = sid[r];
    if (id < 0 || id >= a.n_valid || id >= a.n) continue;
    const uint8_t* src = a.packed + static_cast<size_t>(id) * a.p;
    unsigned char* dst = stage + r * stride;
    for (int u = g; u < units; u += G) {
      if (UNIT == 16)
        jasper::cp_async16(dst + 16 * u, src + 16 * u, true);
      else if (UNIT == 4)
        jasper::cp_async4(dst + 4 * u, src + 4 * u, true);
      else
        dst[u] = __ldg(src + u);
    }
  }
}

// The round's rows [0, m) scored into sdot (rabitq_rows.cuh); rows of at
// most 32 units keep lane g's codes of the query (qrow) in registers.
template <int BITS, bool WORDS>
__device__ __forceinline__ void score_round(const unsigned char* stage, int stride, float* sdot,
                                            int m, const float* __restrict__ qrow,
                                            const float* qt, int units, int lane) {
  constexpr int kCpu = WORDS ? 32 / BITS : 8 / BITS;
  const int G = units < 32 ? jasper::pow2_at_least(units) : 32;
  const int g = lane & (G - 1);
  float qr[kCpu];
#pragma unroll
  for (int j = 0; j < kCpu; ++j) qr[j] = units <= 32 && g < units ? __ldg(qrow + g * kCpu + j) : 0.f;
  jasper::score_rows<BITS, WORDS>(stage, stride, sdot, m, qr, qt, units, lane);
}

__device__ __forceinline__ bool in_range(const Args& a, int id) {
  return id >= 0 && id < a.n_valid && id < a.n;
}

template <int BITS, bool USE_TOMB, bool USE_FILT>
__global__ void __launch_bounds__(32 * kMaxWarps)
rabitq_search_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kIds = kMaxRows / 32;  // ids a lane owns
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= a.num_q) return;  // a whole warp: no block barrier follows
  const Slot s = slot_of(a.k, a.p, BITS);
  unsigned char* slot = smem + (threadIdx.x >> 5) * s.bytes;
  float* qt = reinterpret_cast<float*>(slot);
  unsigned char* stage = slot + s.q_bytes;
  int32_t* sid = reinterpret_cast<int32_t*>(stage + s.rows * s.stride);
  float* sdot = reinterpret_cast<float*>(sid + s.rows);

  // rows of whole 32-bit words score a word a lane, other rows a byte a
  // lane
  const bool words = (a.p & 3) == 0;
  const int units = words ? a.p >> 2 : a.p;
  const int dq = a.p * (8 / BITS);
  const int unit = (a.p & 15) == 0 && (reinterpret_cast<uintptr_t>(a.packed) & 15) == 0
                       ? 16
                       : ((a.p & 3) == 0 && (reinterpret_cast<uintptr_t>(a.packed) & 3) == 0 ? 4
                                                                                            : 1);
  const float* qrow = a.q + static_cast<size_t>(qi) * dq;
  if (units > 32) {  // the query, transposed: code j of unit u at qt[j * units + u]
    const int cpu = words ? 32 / BITS : 8 / BITS;
    for (int i = lane; i < dq; i += 32) {
      const int u = i / cpu;
      jasper::cp_async4(qt + (i - u * cpu) * units + u, qrow + i, true);
    }
  }
  const float qa = __ldg(a.qa + qi);
  const float qb = __ldg(a.qsum + qi);
  const int32_t* qids = a.ids + static_cast<size_t>(qi) * a.k;

  for (int base = 0; base < a.k; base += s.rows) {
    const int m = min(s.rows, a.k - base);
    // round 1: the ids (and, on the first round, a wide row's query)
    for (int j = lane; j < m; j += 32) jasper::cp_async4(sid + j, qids + base + j, true);
    jasper::cp_async_commit();
    jasper::cp_async_wait<0>();
    __syncwarp();
    // round 2: every in-range candidate's row into the stage, and the
    // metadata, tombstone byte and label word of this lane's ids into its
    // registers, all at once
    float ad[kIds], rs[kIds];
    uint32_t tb[kIds], lb[kIds];
    int ids[kIds];
#pragma unroll
    for (int i = 0; i < kIds; ++i) {
      const int j = lane + 32 * i;
      ids[i] = j < m ? sid[j] : -1;
      ad[i] = rs[i] = 0.f;
      tb[i] = lb[i] = 0;
      if (in_range(a, ids[i])) {
        ad[i] = __ldg(a.add + ids[i]);
        rs[i] = __ldg(a.rescale + ids[i]);
        if (USE_TOMB) tb[i] = __ldg(a.tomb + (ids[i] >> 3));
        if (USE_FILT) lb[i] = __ldg(a.labels + ids[i]);
      }
    }
    if (unit == 16)
      stage_rows<16>(a, sid, m, stage, s.stride, lane);
    else if (unit == 4)
      stage_rows<4>(a, sid, m, stage, s.stride, lane);
    else
      stage_rows<1>(a, sid, m, stage, s.stride, lane);
    jasper::cp_async_commit();
    jasper::cp_async_wait<0>();
    __syncwarp();
    if (words)
      score_round<BITS, true>(stage, s.stride, sdot, m, qrow, qt, units, lane);
    else
      score_round<BITS, false>(stage, s.stride, sdot, m, qrow, qt, units, lane);
    __syncwarp();
    // the estimates of this lane's ids, masked, in one coalesced write
    float* out = a.out + static_cast<size_t>(qi) * a.k + base;
#pragma unroll
    for (int i = 0; i < kIds; ++i) {
      const int j = lane + 32 * i;
      if (j < m) {
        bool live = in_range(a, ids[i]);
        if (USE_TOMB && live) live = ((tb[i] >> (ids[i] & 7)) & 1) == 0;
        if (USE_FILT && live) live = (lb[i] & a.fb) != 0;
        out[j] = live ? jasper::rabitq_epilogue(ad[i], qa, rs[i], sdot[j], qb) : INFINITY;
      }
    }
    __syncwarp();  // the next round reuses the slot
  }
}

// Warps (queries) a block at (k, p): as many slots as fit, at most
// kMaxWarps; 0 when one does not fit.
inline int warps_per_block(const Slot& s) {
  const int n = kSmemLimit / s.bytes;
  return n > kMaxWarps ? kMaxWarps : n;
}

template <int BITS, bool USE_TOMB, bool USE_FILT>
int launch(const Args& a, cudaStream_t stream) {
  const Slot s = slot_of(a.k, a.p, BITS);
  const int wpb = warps_per_block(s);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = wpb * s.bytes;
  auto kern = rabitq_search_step_kernel<BITS, USE_TOMB, USE_FILT>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<(a.num_q + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int dispatch_masks(const Args& a, cudaStream_t s) {
  if (a.tomb && a.labels) return launch<BITS, true, true>(a, s);
  if (a.tomb) return launch<BITS, true, false>(a, s);
  if (a.labels) return launch<BITS, false, true>(a, s);
  return launch<BITS, false, false>(a, s);
}

template <int BITS>
int occupancy_of(int k, int p, int* info) {
  const Slot s = slot_of(k, p, BITS);
  const int wpb = warps_per_block(s);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rabitq_search_step_kernel<BITS, false, false>;
  int e = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, wpb * s.bytes));
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, kern));
  if (e != 0) return e;
  int blocks = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 32 * wpb,
                                                                     wpb * s.bytes));
  info[0] = attr.numRegs;
  info[1] = blocks;
  info[2] = wpb * s.bytes;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = wpb;
  return e;
}

}  // namespace

extern "C" int rabitq_search_step_launch(const int32_t* ids, const uint8_t* packed,
                                         const float* data_add, const float* data_rescale,
                                         int num_q, int k, int p, int n, const uint8_t* tomb,
                                         const uint32_t* labels, uint32_t fb, const float* q,
                                         const float* qa, const float* qsum, int n_valid,
                                         int bits, float* out, void* stream) {
  const Args a{ids, packed, data_add, data_rescale, tomb, labels, q, qa, qsum, out,
               num_q, k, p, n, n_valid, fb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return dispatch_masks<1>(a, s);
    case 2: return dispatch_masks<2>(a, s);
    case 4: return dispatch_masks<4>(a, s);
    case 8: return dispatch_masks<8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// registers a thread, resident blocks an SM, shared bytes a block, local
// (spilled) bytes a thread and queries a block of the unmasked kernel at
// (bits, k, p)
extern "C" int rabitq_search_step_occupancy(int bits, int k, int p, int* info) {
  switch (bits) {
    case 1: return occupancy_of<1>(k, p, info);
    case 2: return occupancy_of<2>(k, p, info);
    case 4: return occupancy_of<4>(k, p, info);
    case 8: return occupancy_of<8>(k, p, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
