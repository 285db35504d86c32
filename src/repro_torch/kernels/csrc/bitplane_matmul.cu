// bitplane_matmul on Hopper: x @ W for W stored as binary bit planes.
//
// Replaces the TPU kernel src/repro/kernels/bitplane_matmul.py:56
// (bitplane_matmul; its pallas_call is at :68). Weights quantized to B
// bits, W_q in [-2^(B-1), 2^(B-1) - 1], are stored as B planes u_b
// (B, K, N) of int8 {0, 1} with U = W_q + 2^(B-1) = sum_b 2^b u_b, and
// per-column float32 scales s. For x (M, K), float32 or bfloat16, it
// computes
//   out = s * (sum_b 2^b (x @ u_b) - 2^(B-1) rowsum(x)) = s * (x @ W_q)
// with a float32 accumulator, out in x's type. The TPU kernel runs one
// matrix-unit pass per plane; the two sides are equal in exact
// arithmetic, and this kernel takes the right-hand one: it reassembles
// W_q from the planes in shared memory (exact: integers below 2^8) and
// multiplies once, as the reference's oracle (kernels/ref.py) does.
//
// Design. A classic tiled product on the CUDA cores: one block of 256
// threads per 128 x 128 output tile, walking K in steps of 16; per step
// the block loads x's 128 x 16 tile (as float32, transposed) and the B
// planes' 16 x 128 tiles (coalesced bytes), reassembles the weights and
// accumulates an 8 x 8 micro-tile per thread in registers; the epilogue
// scales by s. Ragged M, N and K are masked (the reference's wrapper
// pads M to its tile; its kernel needs M, N, K divisible by the tiles).
//
// What bounds it. At the FFN shape of the main path's model (x 4,096 x
// 3,584 bfloat16 @ W 3,584 x 14,336) it reads 29 MB of x, B x 51 MB of
// planes and writes 117 MB: 0.17 ms at 3.35 TB/s for B = 8 (0.11 ms for
// B = 4); its 4.2e11 operations take 0.43 ms at the bfloat16 tensor-core
// rate, so operations bound it. This first version multiplies in float32
// on the CUDA cores (67 TFLOP/s at most, 6.3 ms); moving the product to
// the tensor cores (the weights are exact in bfloat16 and int8) is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lm_tiles.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kStep = 16;
constexpr int kThreads = lm::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bitplane_mm(const T* __restrict__ x, const int8_t* __restrict__ planes,
                const float* __restrict__ scales, T* __restrict__ out, int M,
                int K, int N, int bits) {
  __shared__ float As[kStep][kTile + 4];  // x tile, transposed [k][m]
  __shared__ float Ws[kStep][kTile];      // reassembled W_q [k][n]
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = 1 << (bits - 1);
  const size_t plane = static_cast<size_t>(K) * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kStep) {
#pragma unroll
    for (int e = 0; e < kTile * kStep / kThreads; ++e) {
      const int idx = tid + kThreads * e;
      const int r = idx / kStep, kk = idx % kStep;
      As[kk][r] =
          m0 + r < M && k0 + kk < K
              ? lm::to_f32(x[static_cast<size_t>(m0 + r) * K + k0 + kk])
              : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kTile * kStep / kThreads; ++e) {
      const int idx = tid + kThreads * e;
      const int kk = idx / kTile, c = idx % kTile;
      float w = 0.f;
      if (k0 + kk < K && n0 + c < N) {
        const int8_t* p =
            planes + static_cast<size_t>(k0 + kk) * N + n0 + c;
        int u = 0;
        for (int b = 0; b < bits; ++b)
          u += static_cast<int>(p[b * plane]) << b;
        w = static_cast<float>(u - offset);
      }
      Ws[kk][c] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float s = scales[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M)
        out[static_cast<size_t>(m) * N + n] = lm::from_f32<T>(acc[i][j] * s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* planes, const void* scales, void* out,
           int M, int K, int N, int bits, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  bitplane_mm<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(planes),
      static_cast<const float*>(scales), static_cast<T*>(out), M, K, N, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) and out (M, N) float32 (is_bf16 = 0) or bfloat16; planes
// (bits, K, N) int8; scales (N,) float32. Needs 1 <= bits <= 8 and
// (M + 127) / 128 <= 65535.
extern "C" int bitplane_matmul_launch(int is_bf16, const void* x,
                                      const void* planes, const void* scales,
                                      void* out, int M, int K, int N,
                                      int bits, void* stream) {
  if (M < 1 || K < 1 || N < 1 || bits < 1 || bits > 8 ||
      (M + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, planes, scales, out, M, K, N,
                                            bits, s);
  return launch<float>(x, planes, scales, out, M, K, N, bits, s);
}
