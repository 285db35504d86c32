// Helpers shared by the LM kernels (flash_attention.cu, ssd_scan.cu,
// bitplane_matmul.cu): float32 <-> input type, the float32 tile product
// on the CUDA cores, and the launch's shared-memory limit.
//
// The tile product serves the kernels that keep float32 tiles in shared
// memory: the float32 instantiations of ssd_scan, flash_attention and
// bitplane_matmul (whose 1e-4 tolerance rules out bfloat16 or TF32
// products), and ssd_scan's backward for both types. Those run 256
// threads as a 16 x 16 grid (ty, tx); a thread owns the tile elements
// (ty + 16 i, tx + 16 j) for i < rm, j < cm, so a warp reads a row of the
// right-hand operand at consecutive addresses and at most two addresses
// of the left-hand one. Their other bfloat16 paths run on the tensor
// cores instead, through lm_mma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lm {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's and XLA's float32 -> bfloat16 casts
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc[i][j] += sum_k A(ty + 16 i, k) * ks[k] * B(k, tx + 16 j) over
// k < kdim, for i < rm <= RM and j < cm <= CM; ks may be null (1). A(r, k)
// = A[r * sar + k * sak] and B(k, c) = B[k * sbk + c * sbc], so either
// operand is read as it lies or transposed (with an odd leading
// dimension a transposed read still hits 16 banks).
template <int RM, int CM>
__device__ __forceinline__ void mm_acc_strided(
    float (&acc)[RM][CM], const float* A, int sar, int sak, const float* B,
    int sbk, int sbc, int kdim, int rm, int cm, int ty, int tx,
    const float* ks = nullptr) {
  for (int k = 0; k < kdim; ++k) {
    const float s = ks ? ks[k] : 1.f;
    float a[RM], b[CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = i < rm ? A[(ty + 16 * i) * sar + k * sak] * s : 0.f;
#pragma unroll
    for (int j = 0; j < CM; ++j)
      b[j] = j < cm ? B[k * sbk + (tx + 16 * j) * sbc] : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j)
        if (i < rm && j < cm) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[(ty + 16 i) * lda + k] * ks[k] * B[k * ldb + tx + 16 j]
// over k < kdim, for i < rm <= RM and j < cm <= CM; ks may be null (1).
template <int RM, int CM>
__device__ __forceinline__ void mm_acc(float (&acc)[RM][CM], const float* A,
                                       int lda, const float* B, int ldb,
                                       int kdim, int rm, int cm, int ty,
                                       int tx, const float* ks = nullptr) {
  mm_acc_strided(acc, A, lda, 1, B, ldb, 1, kdim, rm, cm, ty, tx, ks);
}

// Launch configuration for a kernel with `smem` bytes of dynamic shared
// memory: raises the kernel's limit past 48 KB and refuses what no block
// can hold (227 KB on Hopper).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace lm
