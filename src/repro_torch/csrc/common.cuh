// Shared device helpers for the Jasper search kernels (sm_90a), and the
// cp.async copies and the bf16 tensor-core product that the search and
// flash kernels use. The RaBitQ row scorer is rabitq_rows.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace jasper {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Partial (per-lane) dot of a float row with q (d floats). float4 loads
// when the row is 16-byte aligned and d a multiple of 4.
__device__ __forceinline__ float float_dot(const float* __restrict__ row, int d,
                                           const float* __restrict__ q, int lane) {
  float acc = 0.f;
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int i = lane; i < (d >> 2); i += 32) {
      const float4 v = __ldg(r4 + i);
      const float* qq = q + 4 * i;
      acc += v.x * qq[0];
      acc += v.y * qq[1];
      acc += v.z * qq[2];
      acc += v.w * qq[3];
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += __ldg(row + i) * q[i];
  }
  return acc;
}

// RaBitQ estimator epilogue, in the reference's association order:
// (add + qa) + rescale * (dot - qsum), clamped at 0. The _rn intrinsics
// keep the compiler from contracting it into an FMA, so the kernels round
// like the plain PyTorch version.
__device__ __forceinline__ float rabitq_epilogue(float add, float qa, float rescale,
                                                 float dot, float qsum) {
  const float est = __fadd_rn(__fadd_rn(add, qa), __fmul_rn(rescale, __fsub_rn(dot, qsum)));
  return fmaxf(est, 0.f);
}

// Exact squared-L2 epilogue: (|q|^2 - 2 q.c) + |c|^2, clamped at 0.
__device__ __forceinline__ float l2_epilogue(float qsq, float dot, float csq) {
  return fmaxf(__fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, dot)), csq), 0.f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (then
// nothing is read: a row past the end becomes zeros, never garbage).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// d += a * b on the tensor cores: mma.sync m16n8k16, bf16 in, f32
// accumulate (a: 16 x 16 row-major fragment, b: 16 x 8 column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x * y + z on two bf16 lanes, rounded to nearest.
__device__ __forceinline__ unsigned bf16x2_fma(unsigned x, unsigned y, unsigned z) {
  unsigned r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(y), "r"(z));
  return r;
}

// A kernel's attributes belong to the device that was current when they
// were set. `once_per_device(state, set)` runs `set` (a cudaFuncSetAttribute
// call, say) the first time it is reached with each device current and
// returns that device's result every time after.
constexpr int kMaxDevices = 64;

struct PerDevice {
  std::mutex mu;
  bool done[kMaxDevices] = {};
  int result[kMaxDevices] = {};
};

template <typename Set>
int once_per_device(PerDevice& state, Set set) {
  int dev = 0;
  const int e = static_cast<int>(cudaGetDevice(&dev));
  if (e != 0) return e;
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(state.mu);
  if (!state.done[dev]) {
    state.result[dev] = set();
    state.done[dev] = true;
  }
  return state.result[dev];
}

}  // namespace jasper
