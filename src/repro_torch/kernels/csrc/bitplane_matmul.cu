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
// W_q from the planes (exact: integers below 2^8) and multiplies once,
// as the reference's oracle (kernels/ref.py) does.
//
// What bounds it. At the FFN shape of the main path's model (x 4,096 x
// 3,584 bfloat16 @ W 3,584 x 14,336) it reads 29 MB of x, B x 51 MB of
// planes and writes 117 MB: 0.17 ms at 3.35 TB/s for B = 8 (0.11 ms for
// B = 4); its 4.2e11 operations take 0.43 ms at the bfloat16 tensor-core
// rate, so operations bound it.
//
// bfloat16 x (the main path's): two phases on the caller's stream, the
// planes read once. Unpacking inside the product's tiles would re-read
// all B planes once per 128-row M tile: 32 x 411 MB through L2 at the
// FFN shape, slower alone than the whole product.
//  1. bitplane_repack: each thread reads 16 bytes of each plane, forms
//     U = sum_b (word_b << b) on packed 32-bit words (every byte is 0 or
//     1, so no carry crosses a byte), subtracts 2^(B-1) per byte and
//     writes W_q as bfloat16 (K, N) to a scratch the wrapper allocates.
//     Exact: |W_q| <= 128 and bfloat16 holds integers to 256. Bytes: B K N
//     read + 2 K N written (514 MB at 8 bits, 0.153 ms at 3.35 TB/s).
//  2. bitplane_gemm: x (M, K) @ W_q (K, N), both bfloat16, float32
//     accumulators, out = acc * s[n] rounded to bfloat16 (nearest even).
//     One block of three warpgroups per 128 x 256 output tile: a producer
//     (one thread) issues TMA loads of x's 128 x 64 tile (K-major) and
//     W_q's 64 x 256 tile (N-major, four 64-column boxes) into a 4-stage
//     ring of 48 KB stages under full/empty mbarriers, with the 128-byte
//     swizzle; two consumer warpgroups each run wgmma m64n256k16 with
//     transposed B on 64 of the rows (128 float32 accumulators a thread).
//     Tiles are numbered M-fastest, so the blocks in flight share W_q's
//     column slices in L2. TMA zero-fills ragged M, N and K; the epilogue
//     masks the stores. TMA needs 16-byte row strides: K and N multiples
//     of 8.
//
// float32 x: on the CUDA cores, as first ported. The float32 tolerance
// (1e-4) rules out bfloat16 or TF32 products, and no main path runs it.
// One block of 256 threads per 128 x 128 output tile walks K in steps of
// 16, loads x's tile (transposed) and the planes' tiles (coalesced
// bytes), reassembles W_q in shared memory and accumulates an 8 x 8
// micro-tile per thread; the epilogue scales by s. Ragged edges masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lm_mma.cuh"
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

// ------------------------------------------------------ phase 1: repack
using bf16 = __nv_bfloat16;
constexpr int kRepackThreads = 256;

// W_q[i] = sum_b 2^b planes[b][i] - 2^(B-1) over the flat index i of
// (K, N), 16 values a thread; `vec` when every plane's 16 bytes are
// 16-byte aligned.
__global__ void __launch_bounds__(kRepackThreads)
    bitplane_repack(const int8_t* __restrict__ planes, bf16* __restrict__ wq,
                    size_t total, int bits, int vec) {
  const size_t i0 =
      (static_cast<size_t>(blockIdx.x) * kRepackThreads + threadIdx.x) * 16;
  if (i0 >= total) return;
  const int offset = 1 << (bits - 1);
  if (vec && i0 + 16 <= total) {
    uint32_t u[4] = {0u, 0u, 0u, 0u};
    for (int b = 0; b < bits; ++b) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          planes + static_cast<size_t>(b) * total + i0));
      u[0] += w.x << b;
      u[1] += w.y << b;
      u[2] += w.z << b;
      u[3] += w.w << b;
    }
    uint32_t packed[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = u[e >> 1] >> (16 * (e & 1));
      packed[e] = lm::pack_bf16x2(
          static_cast<float>(static_cast<int>(word & 0xff) - offset),
          static_cast<float>(static_cast<int>((word >> 8) & 0xff) - offset));
    }
    uint4* dst = reinterpret_cast<uint4*>(wq + i0);
    dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    return;
  }
  for (size_t i = i0; i < i0 + 16 && i < total; ++i) {
    int u = 0;
    for (int b = 0; b < bits; ++b)
      u += static_cast<int>(planes[static_cast<size_t>(b) * total + i]) << b;
    wq[i] = __float2bfloat16_rn(static_cast<float>(u - offset));
  }
}

int launch_repack(const void* planes, void* wq, int K, int N, int bits,
                  cudaStream_t stream) {
  const size_t total = static_cast<size_t>(K) * N;
  const int vec = total % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(planes) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const size_t per_block = static_cast<size_t>(kRepackThreads) * 16;
  const size_t blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  bitplane_repack<<<static_cast<unsigned>(blocks), kRepackThreads, 0,
                    stream>>>(static_cast<const int8_t*>(planes),
                              static_cast<bf16*>(wq), total, bits, vec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ phase 2: GEMM
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kGemmThreads = 384;  // producer, two consumer warpgroups
constexpr uint32_t kABytes = kBM * kBK * 2;  // 16 KB, 128-byte rows
constexpr uint32_t kBBytes = kBK * kBN * 2;  // 32 KB, four 8 KB boxes
constexpr uint32_t kBoxBytes = kBK * 64 * 2;
constexpr size_t kGemmSmem =
    1024 + kStages * (kABytes + kBBytes) + 2 * kStages * 8;

__global__ void __launch_bounds__(kGemmThreads, 1)
    bitplane_gemm(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ scales, bf16* __restrict__ out,
                  int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the ring to it
  const uint32_t ring = (lm::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_base = ring, b_base = ring + kStages * kABytes;
  const uint32_t full = b_base + kStages * kBBytes, empty = full + 8 * kStages;
  const int mt = (M + kBM - 1) / kBM;
  const int m0 = (blockIdx.x % mt) * kBM, n0 = (blockIdx.x / mt) * kBN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      lm::mbar_init(full + 8 * s, 1);
      lm::mbar_init(empty + 8 * s, 2);  // one arrival per consumer
    }
    lm::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    lm::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        lm::mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        lm::mbar_expect_tx(full + 8 * s, kABytes + kBBytes);
        lm::tma_load_2d(a_base + s * kABytes, &map_x, full + 8 * s, kt * kBK,
                        m0);
#pragma unroll
        for (int i = 0; i < kBN / 64; ++i)
          lm::tma_load_2d(b_base + s * kBBytes + i * kBoxBytes, &map_w,
                          full + 8 * s, n0 + 64 * i, kt * kBK);
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. + 63 of the tile
    lm::reg_alloc<232>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const uint32_t a_off = (wg - 1) * 64 * 128;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      lm::mbar_wait(full + 8 * s, (kt / kStages) & 1);
      const uint64_t da =
          lm::wgmma_desc_sw128(a_base + s * kABytes + a_off, 16, 1024);
      const uint64_t db =
          lm::wgmma_desc_sw128(b_base + s * kBBytes, kBoxBytes, 1024);
      lm::fence_regs(acc);
      lm::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // A: 32 bytes, B: 16 rows
        lm::wgmma_m64n256k16_tb(acc, da + 2 * kk, db + 128 * kk);
      lm::wgmma_commit();
      lm::wgmma_wait<0>();
      lm::fence_regs(acc);
      if (threadIdx.x % 128 == 0) lm::mbar_arrive(empty + 8 * s);
    }
    const int lane = threadIdx.x % 32;
    const int r0 = m0 + (wg - 1) * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= N) continue;
      const float2 sc = *reinterpret_cast<const float2*>(scales + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m < M)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * N + n) =
              lm::pack_bf16x2(acc[4 * j + 2 * h] * sc.x,
                              acc[4 * j + 2 * h + 1] * sc.y);
      }
    }
  }
}

// a row-major (outer, inner) bfloat16 matrix read in (box_outer,
// box_inner) boxes with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
              int box_inner, int box_outer) {
  lm::EncodeTiled fn = lm::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_gemm(const void* x, const void* wq, const void* scales, void* out,
                int M, int K, int N, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides
  if (K % 8 || N % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, K, M, kBK, kBM) ||
      !make_map(&map_w, wq, N, K, 64, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = lm::allow_smem(bitplane_gemm, kGemmSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) *
                          ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  bitplane_gemm<<<static_cast<unsigned>(tiles), kGemmThreads, kGemmSmem,
                  stream>>>(map_x, map_w, static_cast<const float*>(scales),
                            static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ float32
int launch_f32(const void* x, const void* planes, const void* scales,
               void* out, int M, int K, int N, int bits, cudaStream_t stream) {
  if ((M + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  bitplane_mm<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(planes),
      static_cast<const float*>(scales), static_cast<float*>(out), M, K, N,
      bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes (bits, K, N) int8 -> wq (K, N) bfloat16 (phase 1 alone).
extern "C" int bitplane_repack_launch(const void* planes, void* wq, int K,
                                      int N, int bits, void* stream) {
  if (K < 1 || N < 1 || bits < 1 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_repack(planes, wq, K, N, bits,
                       static_cast<cudaStream_t>(stream));
}

// x (M, K) @ wq (K, N), both bfloat16, times scales (N,) float32 ->
// out (M, N) bfloat16 (phase 2 alone). Needs K % 8 == 0, N % 8 == 0.
extern "C" int bitplane_gemm_launch(const void* x, const void* wq,
                                    const void* scales, void* out, int M,
                                    int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gemm(x, wq, scales, out, M, K, N,
                     static_cast<cudaStream_t>(stream));
}

// x (M, K) and out (M, N) float32 (is_bf16 = 0) or bfloat16; planes
// (bits, K, N) int8; scales (N,) float32; wq a (K, N) bfloat16 scratch
// for bfloat16 x (unused for float32). Needs 1 <= bits <= 8; bfloat16
// needs K % 8 == 0 and N % 8 == 0, float32 (M + 127) / 128 <= 65535.
extern "C" int bitplane_matmul_launch(int is_bf16, const void* x,
                                      const void* planes, const void* scales,
                                      void* wq, void* out, int M, int K,
                                      int N, int bits, void* stream) {
  if (M < 1 || K < 1 || N < 1 || bits < 1 || bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_f32(x, planes, scales, out, M, K, N, bits, s);
  if (K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_repack(planes, wq, K, N, bits, s);
  if (rc) return rc;
  return launch_gemm(x, wq, scales, out, M, K, N, s);
}
