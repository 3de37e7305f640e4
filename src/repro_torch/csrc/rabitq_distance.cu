// rabitq_distance / rabitq_gather_distance — RaBitQ estimated squared L2,
// with no masking epilogue:
//
//   est = max((add_c + qa) + rescale_c * (<unpack(code_c), q_rot> - qsum), 0)
//
// rabitq_distance replaces rabitq_distance_pallas (repro/kernels/rabitq_dot/
// rabitq_kernel.py:172): every (query, row) pair of a (Q, D) rotated query
// block and a (C, P) packed code table, the estimator over a full scan.
// Bound on the H100: bytes. At (Q, C) = (10,000, 131,072), D = 128, 4 bits
// the output is 5.24 GB = 1.57 ms at 3.35 TB/s; the 2QCD = 3.36e11 products
// are 0.34 ms on the tensor cores (the codes are 8.4 MB).
//
// Design: the products on the tensor cores, exactly. A code is an integer
// below 2^BITS <= 256, so exact in bf16; a float32 query splits exactly
// into three bf16 parts (q = h0 + h1 + h2, 8 significant bits each), so
// every product code * h is exact and mma.sync m16n8k16 (bf16 in, f32
// accumulate) takes three products a k-step. On integer operands every
// partial sum is an integer below 2^24: the result is the plain version's
// bit for bit. A block computes a 64-query x 256-row tile, 8 warps of 32 x
// 64, over k-chunks of 64 dims: the chunk's packed code bytes and query
// floats arrive by 16-byte cp.async (the next chunk's while this one is
// multiplied); the codes are unpacked once into bf16 in shared memory and
// the query chunk is split into its three parts there (bf16_split.cuh);
// fragments come by ldmatrix, a code fragment serving all three parts. The
// estimator epilogue runs on the accumulators in registers: two
// neighbouring lanes swap halves so that each holds four consecutive
// columns of one row, and a warp's 16-byte streaming stores write its
// rows' 128-byte lines whole, 32 bytes of 16 rows a store. 95,744 B of
// shared memory a block at 4 bits and at most 128 registers a thread: two
// blocks an SM, one storing while the other multiplies. Only the first D
// unpacked codes count (D <= P * 8/BITS): the query's parts past D are
// zero. Ragged Q, C and D are masked in-kernel.
//
// rabitq_gather_distance replaces rabitq_gather_distance_pallas
// (rabitq_kernel.py:97): per query, K candidate code rows already gathered
// into a contiguous (Q, K, P) buffer with their (Q, K) metadata, as the JAX
// kernel takes them. Bound: bytes, P + 8 B read and 4 B written per
// candidate against 2D flops (at (10,000 x 64), P = 64, D = 128: 54 MB,
// 0.016 ms at 3.35 TB/s). Design: one warp a query at a time, four warps
// a block, no block barrier, persistent: the grid holds only as many
// blocks as are resident at once, and warp w of W takes queries w, w + W,
// ... A query's K rows are one contiguous K x P slab (4 KB at the main
// shape), so nothing waits on an id: an item (a query's rows, at most
// kGatherStageBytes of them, and the query itself) goes to one of the
// warp's two shared buffers by cp.async (16-byte units where the slab's
// address and length allow, 4- or 1-byte ones otherwise) while the warp
// scores the item before it from the other buffer, so a warp's loads and
// its scoring overlap. The metadata (one float a lane, coalesced) and the
// query scalars go to registers at an item's start and are used after its
// scoring. The rows score with rabitq_rows.cuh's scorer, the one
// rabitq_search_step (#3, rabitq_search_step.cu) uses — a group of G lanes
// a row, eight FMA chains a lane, xor shuffles G/2 .. 1 — so #3 and #5
// score a row alike by construction. Outputs leave as one coalesced write
// an item. Wide rows (2,304 B at D = 4,608, 4 bits) take several items a
// query and read the query transposed from the buffer. Only the first D
// codes count: the query's codes past D are staged as zeros.

#include <mutex>

#include "bf16_split.cuh"
#include "rabitq_rows.cuh"

namespace {

// ------------------------------------------------------ rabitq_distance
constexpr int kBM = 64;             // queries a block tile
constexpr int kBN = 256;            // code rows a block tile
constexpr int kKC = 64;             // dims a k-chunk: four mma k-steps
constexpr int kThreads = 256;       // 8 warps: 2 (queries) x 4 (rows)
constexpr int kStride = kKC + 8;    // bf16 a shared row: 9 units of 16 B
constexpr int kParts = 3;

// Shared memory of a block: the query chunk's three bf16 parts (A), the
// unpacked code chunk (B), the next query chunk as floats and the next
// code chunk as packed bytes (both arriving by cp.async while A and B are
// multiplied), and the tile's metadata.
constexpr int kMetaFloats = 2 * (kBN + kBM);  // add, rescale; qa, qsum

template <int BITS>
struct Chunk {
  static constexpr int kBytes = kKC * BITS / 8;             // a row's packed chunk
  static constexpr int kUnit = kBytes < 16 ? kBytes : 16;   // bytes a cp.async
  // staged row stride: 16 B of padding past 32 B keeps a quarter-warp's
  // reads of 8 rows on distinct banks
  static constexpr int kStage = kBytes >= 32 ? kBytes + 16 : kBytes;
  static constexpr int kA = kParts * kBM * kStride * 2;
  static constexpr int kB = kBN * kStride * 2;
  static constexpr int kQ = kBM * kKC * 4;
  static constexpr int kPacked = kBN * kStage;
  static constexpr int kMeta = kA + kB + kQ + kPacked;
  static constexpr int kSmem = kMeta + kMetaFloats * 4;
};

// The staged query chunk into its three bf16 parts, [part][row][dim]:
// q = h0 + h1 + h2 exactly (bf16_split.cuh). Thread t splits the float4s it
// staged.
__device__ __forceinline__ void split_queries(__nv_bfloat16* As, const float* qs) {
#pragma unroll
  for (int j = 0; j < kBM * kKC / 4 / kThreads; ++j) {
    const int f = threadIdx.x + kThreads * j;
    const int r = f >> 4;
    const int c = 4 * (f & 15);
    uint2 h[kParts];
    jasper::bf16_split4(*reinterpret_cast<const float4*>(qs + r * kKC + c), h);
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      *reinterpret_cast<uint2*>(As + (p * kBM + r) * kStride + c) = h[p];
  }
}

// Copies of k-chunk kc of the tile's packed rows into a staging buffer:
// whole units by cp.async (zero past the row or the table), or, for rows
// that are not a whole number of units or a base off 16 bytes, one byte at
// a time.
template <int BITS>
__device__ __forceinline__ void stage_codes(uint8_t* staged, const uint8_t* __restrict__ packed,
                                            int nc, int p, int n0, int kc, bool vec) {
  using C = Chunk<BITS>;
  const int b0 = kc * C::kBytes;
  if (vec) {
    constexpr int kUnits = C::kBytes / C::kUnit;
    for (int i = threadIdx.x; i < kBN * kUnits; i += kThreads) {
      const int r = i / kUnits;
      const int off = (i - r * kUnits) * C::kUnit;
      const bool valid = n0 + r < nc && b0 + off < p;
      const uint8_t* src = valid ? packed + static_cast<size_t>(n0 + r) * p + b0 + off : packed;
      const unsigned dst = jasper::smem_addr(staged + r * C::kStage + off);
      if constexpr (C::kUnit == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                     "r"(valid ? 16 : 0));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                     "r"(valid ? 8 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < kBN * C::kBytes; i += kThreads) {
      const int r = i / C::kBytes;
      const int off = i - r * C::kBytes;
      staged[r * C::kStage + off] =
          n0 + r < nc && b0 + off < p ? __ldg(packed + static_cast<size_t>(n0 + r) * p + b0 + off)
                                      : 0;
    }
  }
}

// bf16 pairs (lo, hi) of two codes below 128: 128 + code in the mantissa of
// 128, then 128 taken off, exactly.
__device__ __forceinline__ unsigned small_codes_bf16(unsigned lo, unsigned hi) {
  return jasper::bf16x2_fma(lo | (hi << 16) | 0x43004300u, 0x3f803f80u, 0xc300c300u);
}

// N packed words (N * 32/BITS codes) of a row into bf16, 8 codes (one
// 16-byte unit) at a time.
template <int BITS, int N>
__device__ __forceinline__ void unpack_words(__nv_bfloat16* dst, const uint32_t (&w)[N]) {
  constexpr int kCodes = 32 / BITS;  // codes a word
  constexpr unsigned kMask = (1u << BITS) - 1u;
#pragma unroll
  for (int g = 0; g < N * kCodes / 8; ++g) {
    unsigned pr[4];
    if constexpr (BITS == 4) {
      // word g holds dims 8g..8g+7, its byte i dims 2i (low nibble), 2i+1
      const uint32_t lo = w[g] & 0x0f0f0f0fu;
      const uint32_t hi = (w[g] >> 4) & 0x0f0f0f0fu;
      const uint32_t t0 = __byte_perm(lo, hi, 0x5140);  // dims 0..3, a byte each
      const uint32_t t1 = __byte_perm(lo, hi, 0x7362);  // dims 4..7
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = jasper::bf16x2_fma(
            __byte_perm(i < 2 ? t0 : t1, 0x43434343u, (i & 1) ? 0x4342 : 0x4140), 0x3f803f80u,
            0xc300c300u);
    } else if constexpr (BITS == 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = w[2 * g + (i >> 1)];
        const int s = 16 * (i & 1);
        pr[i] = flash::pack_bf16(static_cast<float>((x >> s) & 0xffu),
                                 static_cast<float>((x >> (s + 8)) & 0xffu));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dim = 8 * g + 2 * i;
        const uint32_t x = w[dim / kCodes];
        const int s = (dim % kCodes) * BITS;
        pr[i] = small_codes_bf16((x >> s) & kMask, (x >> (s + BITS)) & kMask);
      }
    }
    *reinterpret_cast<uint4*>(dst + 8 * g) = make_uint4(pr[0], pr[1], pr[2], pr[3]);
  }
}

// The staged chunk unpacked into bf16, [row][dim]: thread t unpacks row
// t's 64 codes, read as 16-byte (at 1 bit 8-byte) vectors. Codes past d are
// left as they are: the query's parts there are zero.
template <int BITS>
__device__ __forceinline__ void unpack_codes(__nv_bfloat16* Bs, const uint8_t* staged) {
  using C = Chunk<BITS>;
  const uint8_t* src = staged + threadIdx.x * C::kStage;
  __nv_bfloat16* dst = Bs + threadIdx.x * kStride;
  if constexpr (BITS == 1) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const uint32_t w[2] = {v.x, v.y};
    unpack_words<BITS, 2>(dst, w);
  } else {
#pragma unroll
    for (int i = 0; i < C::kBytes / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      unpack_words<BITS, 4>(dst + i * (128 / BITS), w);
    }
  }
}

// Copies of a tile's metadata, add and rescale of its rows, qa and qsum of
// its queries, into meta (zero past nc, nq).
__device__ __forceinline__ void stage_meta(float* meta, const float* __restrict__ add,
                                           const float* __restrict__ rescale,
                                           const float* __restrict__ qa,
                                           const float* __restrict__ qsum, int nq, int nc, int m0,
                                           int n0) {
  for (int i = threadIdx.x; i < kBN; i += kThreads) {
    const bool valid = n0 + i < nc;
    jasper::cp_async4(meta + i, valid ? add + n0 + i : add, valid);
    jasper::cp_async4(meta + kBN + i, valid ? rescale + n0 + i : rescale, valid);
  }
  for (int i = threadIdx.x; i < kBM; i += kThreads) {
    const bool valid = m0 + i < nq;
    jasper::cp_async4(meta + 2 * kBN + i, valid ? qa + m0 + i : qa, valid);
    jasper::cp_async4(meta + 2 * kBN + kBM + i, valid ? qsum + m0 + i : qsum, valid);
  }
}

// A block computes one output tile: the next chunk's copies are in flight
// while this one is multiplied (two barriers a chunk), then each warp
// applies the epilogue to its dots in registers and stores them.
template <int BITS>
__global__ void __launch_bounds__(kThreads, 2)
rabitq_distance_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ add,
                       const float* __restrict__ rescale, const float* __restrict__ q,
                       const float* __restrict__ qa, const float* __restrict__ qsum,
                       float* __restrict__ out, int nq, int nc, int p, int d, int vec_q,
                       int vec_codes, int vec_out) {
  using C = Chunk<BITS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + C::kA);
  float* qs = reinterpret_cast<float*>(smem + C::kA + C::kB);
  uint8_t* staged = smem + C::kA + C::kB + C::kQ;
  float* meta = reinterpret_cast<float*>(smem + C::kMeta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // rows 32 wm .. of the query tile
  const int wn = warp & 3;   // rows 64 wn .. of the code tile
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = d > kKC ? (d + kKC - 1) / kKC : 1;

  stage_meta(meta, add, rescale, qa, qsum, nq, nc, m0, n0);
  jasper::stage_floats<kBM, kKC, kThreads>(qs, q, nq, d, m0, 0, vec_q);
  stage_codes<BITS>(staged, packed, nc, p, n0, 0, vec_codes);
  jasper::cp_async_commit();
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kc = 0; kc < chunks; ++kc) {
    jasper::cp_async_wait<0>();
    __syncthreads();  // chunk kc staged; every warp done with chunk kc - 1
    split_queries(As, qs);
    unpack_codes<BITS>(Bs, staged);
    __syncthreads();
    if (kc + 1 < chunks) {
      jasper::stage_floats<kBM, kKC, kThreads>(qs, q, nq, d, m0, (kc + 1) * kKC, vec_q);
      stage_codes<BITS>(staged, packed, nc, p, n0, kc + 1, vec_codes);
      jasper::cp_async_commit();
    }
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      unsigned b[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) flash::load_b<kStride>(b[j], Bs + 64 * wn * kStride, j, ks);
      // the smallest part first: the sum grows from its finest terms
#pragma unroll
      for (int part = kParts - 1; part >= 0; --part) {
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          flash::load_a<kStride>(a[mt], As + (part * kBM + 32 * wm + 16 * mt) * kStride, ks);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            jasper::mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)],
                             b[nt >> 1][2 * (nt & 1) + 1]);
      }
    }
  }

  // The epilogue from the accumulators: lanes t and t ^ 1 (columns 2t4,
  // 2t4 + 1 and the next two, rows g and g + 8) swap halves, so the even
  // lane holds four columns of row g and the odd one four of row g + 8.
  // A warp's store then writes 32 bytes of 16 rows, and four of them (n-
  // tiles 2j, 2j + 1 of both m-tiles) the warp's whole 128-byte lines.
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int odd = t4 & 1;
  float a_r[2], b_r[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int mr = 32 * wm + 16 * mt + g + 8 * odd;  // row of the tile
    a_r[mt] = meta[2 * kBN + mr];
    b_r[mt] = meta[2 * kBN + kBM + mr];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int nc0 = 64 * wn + 8 * nt + 4 * (t4 >> 1);  // column of the tile
    const float4 ad = *reinterpret_cast<const float4*>(meta + nc0);
    const float4 rs = *reinterpret_cast<const float4*>(meta + kBN + nc0);
    const int n = n0 + nc0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* c = acc[mt][nt];
      const float x = __shfl_xor_sync(jasper::kFullMask, odd ? c[0] : c[2], 1);
      const float y = __shfl_xor_sync(jasper::kFullMask, odd ? c[1] : c[3], 1);
      const float4 dot = odd ? make_float4(x, y, c[2], c[3]) : make_float4(c[0], c[1], x, y);
      const int m = m0 + 32 * wm + 16 * mt + g + 8 * odd;
      if (m >= nq) continue;
      const float a = a_r[mt];
      const float b = b_r[mt];
      const float e[4] = {jasper::rabitq_epilogue(ad.x, a, rs.x, dot.x, b),
                          jasper::rabitq_epilogue(ad.y, a, rs.y, dot.y, b),
                          jasper::rabitq_epilogue(ad.z, a, rs.z, dot.z, b),
                          jasper::rabitq_epilogue(ad.w, a, rs.w, dot.w, b)};
      float* row = out + static_cast<size_t>(m) * nc + n;
      if (vec_out) {
        if (n < nc) __stcs(reinterpret_cast<float4*>(row), make_float4(e[0], e[1], e[2], e[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < nc) row[j] = e[j];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BITS>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(rabitq_distance_kernel<BITS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Chunk<BITS>::kSmem));
}

template <int BITS>
int launch_all_pairs(const uint8_t* packed, const float* add, const float* rescale,
                     const float* q, const float* qa, const float* qsum, float* out, int nq,
                     int nc, int p, int d, cudaStream_t s) {
  static jasper::PerDevice smem_set;
  const int attr = jasper::once_per_device(smem_set, set_smem<BITS>);
  if (attr != 0) return attr;
  const dim3 grid((nq + kBM - 1) / kBM, (nc + kBN - 1) / kBN);
  const int vec_q = (d & 3) == 0 && aligned16(q);
  const int vec_codes = p % Chunk<BITS>::kUnit == 0 && aligned16(packed);
  const int vec_out = (nc & 3) == 0 && aligned16(out);
  rabitq_distance_kernel<BITS><<<grid, kThreads, Chunk<BITS>::kSmem, s>>>(
      packed, add, rescale, q, qa, qsum, out, nq, nc, p, d, vec_q, vec_codes, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int occupancy_of(int* info) {
  int e = set_smem<BITS>();
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, rabitq_distance_kernel<BITS>));
  if (e != 0) return e;
  int blocks = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rabitq_distance_kernel<BITS>, kThreads, Chunk<BITS>::kSmem));
  info[0] = attr.numRegs;
  info[1] = blocks;
  info[2] = Chunk<BITS>::kSmem;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return e;
}

// ------------------------------------------------ rabitq_gather_distance
constexpr int kGatherWarps = 4;            // warps a block
constexpr int kGatherStageBytes = 16384;   // a warp's staged rows an item
constexpr int kGatherMaxRows = 128;        // rows an item: four a lane
constexpr int kSmemLimit = 232448;         // shared bytes a block may use

// A warp's shared slot: two buffers, each the query (P * 8/BITS floats,
// zero past D; transposed for rows of more than 32 units) and an item's
// rows back to back (a stride of P), then the item's dots. ops.py
// `gather_smem_bytes` computes the same.
struct GatherSlot {
  int q_bytes, stage_bytes, rows, bytes;
};

__host__ __device__ inline GatherSlot gather_slot_of(int k, int p, int bits) {
  GatherSlot s;
  s.q_bytes = (p * (8 / bits) * 4 + 15) & ~15;
  int rows = kGatherStageBytes / (p > 0 ? p : 1);
  rows = rows < 1 ? 1 : (rows > kGatherMaxRows ? kGatherMaxRows : rows);
  s.rows = k < rows ? k : rows;
  s.stage_bytes = (s.rows * p + 15) & ~15;
  s.bytes = 2 * (s.q_bytes + s.stage_bytes) + ((s.rows * 4 + 15) & ~15);
  return s;
}

// Warps a block: as many slots as fit, at most kGatherWarps; 0 when one
// does not fit.
inline int gather_warps_per_block(const GatherSlot& s) {
  const int n = kSmemLimit / s.bytes;
  return n > kGatherWarps ? kGatherWarps : n;
}

struct GatherArgs {
  const uint8_t* cand;
  const float* add;
  const float* rescale;
  const float* q;
  const float* qa;
  const float* qsum;
  float* out;
  int num_q, k, p, d;
};

// n contiguous bytes from src into a buffer's rows: 16-byte cp.async units
// where the address and length allow, 4-byte ones, else bytes.
__device__ __forceinline__ void stage_slab(const uint8_t* src, int n, unsigned char* stage,
                                           int lane) {
  const unsigned align = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) | n;
  if ((align & 15) == 0) {
    for (int u = lane; u < n >> 4; u += 32) jasper::cp_async16(stage + 16 * u, src + 16 * u, true);
  } else if ((align & 3) == 0) {
    for (int u = lane; u < n >> 2; u += 32) jasper::cp_async4(stage + 4 * u, src + 4 * u, true);
  } else {
    for (int u = lane; u < n; u += 32) stage[u] = __ldg(src + u);
  }
}

// An item is one query's rows [base, base + m): its rows and the query go
// into buffer `buf` by cp.async, one commit group; the query as it is for
// rows of at most 32 units, transposed otherwise (code j of unit u at
// j * units + u), zero past d.
template <int BITS, bool WORDS>
__device__ __forceinline__ void stage_item(const GatherArgs& a, const GatherSlot& s, int units,
                                           int qi, int base, unsigned char* buf, int lane) {
  constexpr int kCpu = WORDS ? 32 / BITS : 8 / BITS;
  const float* qrow = a.q + static_cast<size_t>(qi) * a.d;
  float* sq = reinterpret_cast<float*>(buf);
  for (int i = lane; i < units * kCpu; i += 32) {
    const int u = i / kCpu;
    float* dst = units > 32 ? sq + (i - u * kCpu) * units + u : sq + i;
    jasper::cp_async4(dst, qrow + (i < a.d ? i : 0), i < a.d);
  }
  const int m = min(s.rows, a.k - base);
  stage_slab(a.cand + (static_cast<size_t>(qi) * a.k + base) * a.p, m * a.p, buf + s.q_bytes,
             lane);
  jasper::cp_async_commit();
}

// An item's rows [0, m) scored into sdot with rabitq_rows.cuh's
// score_rows. UNITS > 0 is the row's width in words as a compile-time
// constant (a power of two, at most 32: the group is the row), and whole
// passes of the warp go to score_rows with a constant row count, so its
// bounds fold away and a lane's chains interleave; the rows past the last
// whole pass take one more call. A row's dot is the same either way.
template <int BITS, bool WORDS, int UNITS>
__device__ __forceinline__ void score_item(const unsigned char* rows, int p, float* sdot, int m,
                                           const float (&qr)[WORDS ? 32 / BITS : 8 / BITS],
                                           const float* qt, int units, int lane) {
  if constexpr (UNITS > 0) {
    constexpr int kPass = jasper::kScoreChains<BITS> * (32 / UNITS);
    int r0 = 0;
    for (; r0 + kPass <= m; r0 += kPass)
      jasper::score_rows<BITS, WORDS>(rows + r0 * 4 * UNITS, 4 * UNITS, sdot + r0, kPass, qr, qt,
                                      UNITS, lane);
    if (r0 < m)
      jasper::score_rows<BITS, WORDS>(rows + r0 * 4 * UNITS, 4 * UNITS, sdot + r0, m - r0, qr,
                                      qt, UNITS, lane);
  } else {
    jasper::score_rows<BITS, WORDS>(rows, p, sdot, m, qr, qt, units, lane);
  }
}

// Persistent: warp w of the grid's W takes queries w, w + W, ..., each in
// items of at most s.rows rows, and stages item t + 1 into one buffer while
// it scores item t from the other. UNITS: as score_item.
template <int BITS, bool WORDS, int UNITS>
__global__ void __launch_bounds__(32 * kGatherWarps)
rabitq_gather_kernel(GatherArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kCpu = WORDS ? 32 / BITS : 8 / BITS;  // codes a unit
  constexpr int kOwn = kGatherMaxRows / 32;           // rows a lane owns
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * (blockDim.x >> 5);
  int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= a.num_q) return;  // a whole warp: no block barrier follows
  const GatherSlot s = gather_slot_of(a.k, a.p, BITS);
  unsigned char* slot = smem + (threadIdx.x >> 5) * s.bytes;
  const int buf_bytes = s.q_bytes + s.stage_bytes;
  float* sdot = reinterpret_cast<float*>(slot + 2 * buf_bytes);
  const int units = UNITS > 0 ? UNITS : (WORDS ? a.p >> 2 : a.p);
  const int G = units < 32 ? jasper::pow2_at_least(units) : 32;
  const int g = lane & (G - 1);

  int base = 0, b = 0;
  stage_item<BITS, WORDS>(a, s, units, qi, 0, slot, lane);
  while (true) {
    // this item's metadata and query scalars into registers: they are
    // needed only after the scoring
    const int m = min(s.rows, a.k - base);
    const size_t row0 = static_cast<size_t>(qi) * a.k + base;
    float ad[kOwn], rs[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int j = lane + 32 * i;
      ad[i] = j < m ? __ldg(a.add + row0 + j) : 0.f;
      rs[i] = j < m ? __ldg(a.rescale + row0 + j) : 0.f;
    }
    const float qa = __ldg(a.qa + qi);
    const float qb = __ldg(a.qsum + qi);
    // the next item in flight while this one scores
    int next_q = qi, next_base = base + s.rows;
    if (next_base >= a.k) {
      next_q += n_warps;
      next_base = 0;
    }
    const bool more = next_q < a.num_q;
    if (more) {
      stage_item<BITS, WORDS>(a, s, units, next_q, next_base, slot + (b ^ 1) * buf_bytes, lane);
      jasper::cp_async_wait<1>();
    } else {
      jasper::cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* buf = slot + b * buf_bytes;
    const float* sq = reinterpret_cast<const float*>(buf);
    float qr[kCpu];
#pragma unroll
    for (int j = 0; j < kCpu; ++j) qr[j] = units <= 32 && g < units ? sq[g * kCpu + j] : 0.f;
    score_item<BITS, WORDS, UNITS>(buf + s.q_bytes, a.p, sdot, m, qr, sq, units, lane);
    __syncwarp();
    float* out = a.out + row0;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int j = lane + 32 * i;
      if (j < m) out[j] = jasper::rabitq_epilogue(ad[i], qa, rs[i], sdot[j], qb);
    }
    if (!more) break;
    __syncwarp();  // the next item rewrites sdot; buffer b takes the one after
    qi = next_q;
    base = next_base;
    b ^= 1;
  }
}

using GatherKernel = void (*)(GatherArgs);

// An instance, its shared-memory limit raised to kSmemLimit once a device
// (err: the result of that call on the current device).
template <int BITS, bool WORDS, int UNITS>
GatherKernel gather_instance(int* err) {
  static jasper::PerDevice smem_set;
  *err = jasper::once_per_device(smem_set, [] {
    return static_cast<int>(
        cudaFuncSetAttribute(rabitq_gather_kernel<BITS, WORDS, UNITS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
  });
  return rabitq_gather_kernel<BITS, WORDS, UNITS>;
}

// The instance for rows of p bytes: rows of 4, 8, 16 or 32 words (D = 128
// at 1, 2, 4 and 8 bits) take their width as a constant; other rows of
// whole words, and rows of bytes, read it at run time.
template <int BITS>
GatherKernel gather_kernel_for(int p, int* err) {
  if ((p & 3) != 0) return gather_instance<BITS, false, 0>(err);
  switch (p >> 2) {
    case 4: return gather_instance<BITS, true, 4>(err);
    case 8: return gather_instance<BITS, true, 8>(err);
    case 16: return gather_instance<BITS, true, 16>(err);
    case 32: return gather_instance<BITS, true, 32>(err);
    default: return gather_instance<BITS, true, 0>(err);
  }
}

// Resident blocks an SM of an instance at its warps and shared bytes a
// block on the current device (the occupancy API), remembered for the next
// launch of that shape on that device.
int gather_blocks_per_sm(GatherKernel kern, int wpb, int smem, int* blocks) {
  struct Seen {
    GatherKernel kern;
    int device, wpb, smem, blocks;
  };
  static Seen seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  int device = 0;
  int e = static_cast<int>(cudaGetDevice(&device));
  if (e != 0) return e;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < n_seen; ++i)
      if (seen[i].kern == kern && seen[i].device == device && seen[i].wpb == wpb &&
          seen[i].smem == smem) {
        *blocks = seen[i].blocks;
        return 0;
      }
  }
  e = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, 32 * wpb, smem));
  if (e != 0) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (n_seen < 64) seen[n_seen++] = Seen{kern, device, wpb, smem, *blocks};
  return 0;
}

// The grid: one block of wpb warps for every wpb queries, at most as many
// as are resident on the card at once (the warps then loop).
template <int BITS>
int launch_gather(const GatherArgs& a, cudaStream_t st) {
  const GatherSlot s = gather_slot_of(a.k, a.p, BITS);
  const int wpb = gather_warps_per_block(s);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = wpb * s.bytes;
  int e = 0, blocks = 0, sms = 0, device = 0;
  const GatherKernel kern = gather_kernel_for<BITS>(a.p, &e);
  if (e == 0) e = gather_blocks_per_sm(kern, wpb, smem, &blocks);
  if (e == 0) e = static_cast<int>(cudaGetDevice(&device));
  if (e == 0)
    e = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (e != 0) return e;
  const int need = (a.num_q + wpb - 1) / wpb;
  const int resident = (blocks > 0 ? blocks : 1) * sms;
  kern<<<need < resident ? need : resident, 32 * wpb, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int gather_occupancy_of(int k, int p, int* info) {
  const GatherSlot s = gather_slot_of(k, p, BITS);
  const int wpb = gather_warps_per_block(s);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  int e = 0, blocks = 0;
  const GatherKernel kern = gather_kernel_for<BITS>(p, &e);
  if (e == 0) e = gather_blocks_per_sm(kern, wpb, wpb * s.bytes, &blocks);
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, kern));
  info[0] = attr.numRegs;
  info[1] = blocks;
  info[2] = wpb * s.bytes;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = wpb;
  return e;
}

}  // namespace

extern "C" int rabitq_distance_launch(const uint8_t* packed, const float* data_add,
                                      const float* data_rescale, const float* q,
                                      const float* qa, const float* qsum, float* out, int nq,
                                      int nc, int p, int d, int bits, void* stream) {
  if ((nc + kBN - 1) / kBN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_all_pairs<1>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    case 2: return launch_all_pairs<2>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    case 4: return launch_all_pairs<4>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    case 8: return launch_all_pairs<8>(packed, data_add, data_rescale, q, qa, qsum, out, nq, nc, p, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// registers a thread, resident blocks an SM, shared bytes a block and
// local (spilled) bytes a thread of the all-pairs kernel at `bits`
extern "C" int rabitq_distance_occupancy(int bits, int* info) {
  switch (bits) {
    case 1: return occupancy_of<1>(info);
    case 2: return occupancy_of<2>(info);
    case 4: return occupancy_of<4>(info);
    case 8: return occupancy_of<8>(info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rabitq_gather_distance_launch(const uint8_t* cand, const float* cand_add,
                                             const float* cand_rescale, const float* q, int d,
                                             const float* qa, const float* qsum, float* out,
                                             int nq, int k, int p, int bits, void* stream) {
  const GatherArgs a{cand, cand_add, cand_rescale, q, qa, qsum, out, nq, k, p, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_gather<1>(a, s);
    case 2: return launch_gather<2>(a, s);
    case 4: return launch_gather<4>(a, s);
    case 8: return launch_gather<8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// registers a thread, resident blocks an SM, shared bytes a block, local
// (spilled) bytes a thread and queries a block of the gathered-rows kernel
// at (bits, k, p)
extern "C" int rabitq_gather_distance_occupancy(int bits, int k, int p, int* info) {
  switch (bits) {
    case 1: return gather_occupancy_of<1>(k, p, info);
    case 2: return gather_occupancy_of<2>(k, p, info);
    case 4: return gather_occupancy_of<4>(k, p, info);
    case 8: return gather_occupancy_of<8>(k, p, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
