// flash_attention on Hopper: causal or full online-softmax attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:61
// (flash_attention; its pallas_call is at :71). For q, k, v of shape
// (BH, L, D), float32 or bfloat16, it computes per head
//   o = softmax(scale * q k^T + mask) v,  scale = D^-1/2,
// with float32 scores, running max, denominator and accumulator, the
// denominator clamped at 1e-30, and o in q's type. The TPU kernel walks
// query tiles of tq rows and, for a causal mask, reads the KV tiles of
// tk keys below the bound clamp((qi + 1) tq / tk, 1, L / tk) (integer
// division), with key kpos <= qpos inside them. That bound is part of
// the function (with tq < tk it can drop keys below the diagonal), so
// each query row here gets its own key limit from the same formula:
//   klim = min(qpos + 1, clamp((qpos / tq + 1) tq / tk, 1, L / tk) tk).
//
// Design. One block of 256 threads per (head, 64 query rows): the block
// loads its rows of q, scaled, into shared memory as float32, then walks
// 64-key tiles of k and v up to its largest key limit (the causal
// triangle above it is never read). Per tile it forms the 64 x 64 score
// tile in registers (a 4 x 4 micro-tile per thread), masks it, updates
// each row's running max and denominator (four threads per row, warp
// shuffles), rescales the 4 x D/16 output micro-tile it keeps in
// registers and adds P v. The mask is applied by leaving masked keys
// out of the softmax, which gives what the TPU kernel's exp(-1e30 - m)
// gives: every row has key 0 in its first tile. Ragged edges (L not a
// multiple of 64, D not a multiple of 16) are zero-padded in shared
// memory and masked. D <= 128.
//
// What bounds it. At the main path's shapes (BH = 8 x 32 = 256, L = 512,
// D = 112, bfloat16, causal) it must read q, k, v and write o, 117 MB,
// or 0.035 ms at 3.35 TB/s; the causal triangle's two products are
// 1.5e10 operations, 0.015 ms at the bfloat16 tensor-core rate. So bytes
// bound it. This first version multiplies in float32 on the CUDA cores
// (67 TFLOP/s at most), so it runs above both bounds; moving the two
// products to the tensor cores is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "lm_tiles.cuh"

namespace {

constexpr int kRows = 64;  // query rows per block
constexpr int kKeys = 64;  // keys per tile

size_t smem_bytes(int dd) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (dd + 1)  // Qs
                          + static_cast<size_t>(dd) * kKeys      // Ks^T
                          + static_cast<size_t>(kKeys) * dd      // Vs
                          + kRows * (kKeys + 1)                  // Ps
                          + 3 * kRows)                           // m, l, c
         + sizeof(int) * kRows;                                  // klim
}

template <typename T>
__global__ void __launch_bounds__(lm::kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int L, int D,
              int dd, int causal, int tq, int tk, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int lq = dd + 1, lp = kKeys + 1;
  float* Qs = sm;                    // [kRows][lq], scaled
  float* Ks = Qs + kRows * lq;       // [dd][kKeys], transposed
  float* Vs = Ks + dd * kKeys;       // [kKeys][dd]
  float* Ps = Vs + kKeys * dd;       // [kRows][lp]
  float* mrow = Ps + kRows * lp;
  float* lrow = mrow + kRows;
  float* crow = lrow + kRows;
  int* klim = reinterpret_cast<int*>(crow + kRows);

  const int bh = blockIdx.x, q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * L * D;

  for (int idx = tid; idx < kRows * dd; idx += lm::kThreads) {
    const int r = idx / dd, d = idx % dd;
    float val = 0.f;
    if (q0 + r < L && d < D)
      val = lm::to_f32(q[base + static_cast<size_t>(q0 + r) * D + d]) * scale;
    Qs[r * lq + d] = val;
  }
  if (tid < kRows) {
    const int qp = q0 + tid;
    int lim = 0;
    if (qp < L) {
      if (causal) {
        int up = (qp / tq + 1) * tq / tk;
        up = min(max(up, 1), L / tk);
        lim = min(qp + 1, up * tk);
      } else {
        lim = L;
      }
    }
    klim[tid] = lim;
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  __syncthreads();
  // the key limit does not decrease with the row: the block's last row
  // has the largest
  const int kend = klim[min(kRows, L - q0) - 1];
  const int cm = dd / 16;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    for (int idx = tid; idx < kKeys * dd; idx += lm::kThreads) {
      const int j = idx / dd, d = idx % dd;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < kend && d < D) {
        const size_t off = base + static_cast<size_t>(k0 + j) * D + d;
        kv = lm::to_f32(k[off]);
        vv = lm::to_f32(v[off]);
      }
      Ks[d * kKeys + j] = kv;
      Vs[j * dd + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    lm::mm_acc<4, 4>(s, Qs, lq, Ks, kKeys, dd, 4, 4, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ps[r * lp + c] = k0 + c < klim[r] ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    {  // online softmax, four threads per row
      const int r = tid >> 2, part = tid & 3;
      float mx = -INFINITY;
      for (int c = part; c < kKeys; c += 4) mx = fmaxf(mx, Ps[r * lp + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < kKeys; c += 4) {
        const float sv = Ps[r * lp + c];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        Ps[r * lp + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        crow[r] = corr;
        lrow[r] = lrow[r] * corr + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = crow[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= c;
    }
    lm::mm_acc<4, 8>(acc, Ps, lp, Vs, dd, kKeys, 4, cm, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= L) continue;
    const float den = fmaxf(lrow[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (j < cm && d < D)
        o[base + static_cast<size_t>(q0 + r) * D + d] =
            lm::from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int L, int D, int causal, int tq, int tk, float scale,
           cudaStream_t stream) {
  const int dd = (D + 15) / 16 * 16;
  const size_t smem = smem_bytes(dd);
  cudaError_t e = lm::allow_smem(flash_fwd<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (L + kRows - 1) / kRows);
  flash_fwd<T><<<grid, lm::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), L, D, dd, causal, tq,
      tk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (bh, L, D) contiguous, float32 (is_bf16 = 0) or bfloat16.
// Needs 1 <= D <= 128, L % tq == 0, L % tk == 0, (L + 63) / 64 <= 65535.
extern "C" int flash_attention_launch(int is_bf16, const void* q,
                                      const void* k, const void* v, void* o,
                                      int bh, int L, int D, int causal,
                                      int tq, int tk, float scale,
                                      void* stream) {
  if (bh < 1 || L < 1 || D < 1 || D > 128 || tq < 1 || tk < 1 ||
      L % tq || L % tk || (L + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, bh, L, D, causal, tq, tk, scale,
                                 s);
  return launch<float>(q, k, v, o, bh, L, D, causal, tq, tk, scale, s);
}
