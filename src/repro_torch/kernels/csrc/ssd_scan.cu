// ssd_scan on Hopper: the Mamba2 SSD chunked scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:67 (ssd_scan; its
// pallas_call is at :75). For each (batch, head) row bh it takes the
// head's A (a negative scalar), x (L, P), dt (L,) and the group's B, C
// (L, N), and over chunks of Q steps computes, with da = dt A and cum the
// within-chunk inclusive cumsum of da:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//        + exp(cum_i) C_i . S                      (S: state before chunk)
//   S   <- S exp(cum_Q) + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
// with S (N, P) zero before the first chunk, all in float32, y in x's
// type. It also writes S after the last chunk (the TPU kernel's scratch
// at its end), which prefill needs as the decode state.
//
// Design. The TPU grid's sequential chunk axis becomes a loop inside one
// block of 256 threads per bh, with S resident in shared memory. The
// TPU kernel's (Q, Q) decay matrix is 256 KB at the model's Q = 256,
// more than a block's 227 KB, so the intra-chunk term is tiled: for each
// 64-row block of the chunk, the block loads C's rows, adds the
// inter-chunk term C S (scaled per row by exp(cum_i)), then for each
// 64-column block at or left of the diagonal forms the 64 x 64 weight
// tile (C B^T) exp(cum_i - cum_j) dt_j in registers, writes it to shared
// memory and adds its product with x. Entries with j > i are never
// computed (a positive decay there would overflow exp). The state update
// then walks the chunk's 64-row blocks once more. B and C are read per
// group: row bh reads B, C row bh / rep (the reference repeats them over
// the rep = H / G heads of a group before its kernel; indexing the group
// gives the same values without the copy). The cumsum is a warp scan, in
// another order than the TPU's. P, N <= 128 (zero-padded to multiples of
// 16 in shared memory); Q is bounded by shared memory (about 5,000).
//
// What bounds it. At the main path's shapes (BH = 8 x 112 = 896, L = 512,
// P = N = 64, Q = 256; x, B, C bfloat16 with B, C per group, dt float32)
// it reads 58.7 MB of x, 1.8 MB of dt and 1.0 MB of B and C and writes
// 58.7 MB of y and 14.7 MB of state: 0.040 ms at 3.35 TB/s. Its products
// over the causal half of each chunk are 2.3e10 operations, 0.023 ms at
// the bfloat16 tensor-core rate, so bytes bound it. This first version
// multiplies in float32 on the CUDA cores (67 TFLOP/s at most, 0.34 ms
// for the same products); moving them to the tensor cores is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "lm_tiles.cuh"

namespace {

constexpr int kBlk = 64;  // rows and columns of a tile of the chunk

size_t smem_floats(int nn, int pp, int q) {
  return static_cast<size_t>(nn) * pp           // S
         + static_cast<size_t>(kBlk) * (nn + 1)  // Cs
         + static_cast<size_t>(nn) * (kBlk + 1)  // Bs^T
         + static_cast<size_t>(kBlk) * pp        // Xs
         + kBlk * (kBlk + 1)                     // Ws
         + 2 * static_cast<size_t>(q)            // cum, dts
         + kBlk;                                 // wst
}

// Bs^T and Xs for chunk rows [j0, j0 + nc), zero-padded to 64 rows.
template <typename T>
__device__ __forceinline__ void load_bx(float* Bs, float* Xs, const T* bb,
                                        const T* xb, int row0, int nc, int N,
                                        int P, int nn, int pp, int tid) {
  for (int idx = tid; idx < kBlk * nn; idx += lm::kThreads) {
    const int j = idx / nn, n = idx % nn;
    Bs[n * (kBlk + 1) + j] =
        j < nc && n < N
            ? lm::to_f32(bb[static_cast<size_t>(row0 + j) * N + n])
            : 0.f;
  }
  for (int idx = tid; idx < kBlk * pp; idx += lm::kThreads) {
    const int j = idx / pp, p = idx % pp;
    Xs[j * pp + p] =
        j < nc && p < P
            ? lm::to_f32(xb[static_cast<size_t>(row0 + j) * P + p])
            : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(lm::kThreads)
    ssd_fwd(const float* __restrict__ a, const T* __restrict__ x,
            const float* __restrict__ dt, const T* __restrict__ b,
            const T* __restrict__ c, T* __restrict__ y,
            float* __restrict__ s_final, int L, int P, int N, int pp, int nn,
            int Q, int rep) {
  extern __shared__ __align__(16) float sm[];
  const int lc = nn + 1, lb = kBlk + 1, lw = kBlk + 1;
  float* S = sm;                  // [nn][pp]
  float* Cs = S + nn * pp;        // [kBlk][lc]
  float* Bs = Cs + kBlk * lc;     // [nn][lb], B^T
  float* Xs = Bs + nn * lb;       // [kBlk][pp]
  float* Ws = Xs + kBlk * pp;     // [kBlk][lw]
  float* cum = Ws + kBlk * lw;    // [Q]
  float* dts = cum + Q;           // [Q]
  float* wst = dts + Q;           // [kBlk]

  const int bh = blockIdx.x, tid = threadIdx.x, ty = tid >> 4,
            tx = tid & 15, lane = tid & 31;
  const float av = a[bh];
  const T* xb = x + static_cast<size_t>(bh) * L * P;
  const float* dtb = dt + static_cast<size_t>(bh) * L;
  const T* bb = b + static_cast<size_t>(bh / rep) * L * N;
  const T* cb = c + static_cast<size_t>(bh / rep) * L * N;
  T* yb = y + static_cast<size_t>(bh) * L * P;
  const int cmp = pp / 16, rmn = nn / 16;

  for (int idx = tid; idx < nn * pp; idx += lm::kThreads) S[idx] = 0.f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    for (int t = tid; t < Q; t += lm::kThreads) dts[t] = dtb[c0 + t];
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt A, one warp
      float carry = 0.f;
      for (int t0 = 0; t0 < Q; t0 += 32) {
        const int t = t0 + lane;
        float val = t < Q ? dts[t] * av : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float nb = __shfl_up_sync(0xffffffffu, val, off);
          if (lane >= off) val += nb;
        }
        val += carry;
        if (t < Q) cum[t] = val;
        carry = __shfl_sync(0xffffffffu, val, 31);
      }
    }
    __syncthreads();
    const float seg_end = cum[Q - 1];

    for (int i0 = 0; i0 < Q; i0 += kBlk) {
      const int nr = min(kBlk, Q - i0);
      for (int idx = tid; idx < kBlk * nn; idx += lm::kThreads) {
        const int r = idx / nn, n = idx % nn;
        Cs[r * lc + n] =
            r < nr && n < N
                ? lm::to_f32(cb[static_cast<size_t>(c0 + i0 + r) * N + n])
                : 0.f;
      }
      __syncthreads();

      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      // inter-chunk: exp(cum_i) C_i . S
      lm::mm_acc<4, 8>(acc, Cs, lc, S, pp, nn, 4, cmp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float e = r < nr ? expf(cum[i0 + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= e;
      }
      // intra-chunk, column blocks at or left of the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kBlk) {
        const int nc = min(kBlk, Q - j0);
        load_bx(Bs, Xs, bb, xb, c0 + j0, nc, N, P, nn, pp, tid);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        lm::mm_acc<4, 4>(w, Cs, lc, Bs, lb, nn, 4, 4, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ty + 16 * i, cc = tx + 16 * j;
            const int ii = i0 + r, jj = j0 + cc;
            Ws[r * lw + cc] = r < nr && cc < nc && jj <= ii
                                  ? w[i][j] * expf(cum[ii] - cum[jj]) *
                                        dts[jj]
                                  : 0.f;
          }
        __syncthreads();
        lm::mm_acc<4, 8>(acc, Ws, lw, Xs, pp, kBlk, 4, cmp, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= nr) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = tx + 16 * j;
          if (j < cmp && p < P)
            yb[static_cast<size_t>(c0 + i0 + r) * P + p] =
                lm::from_f32<T>(acc[i][j]);
        }
      }
    }

    // state update: S <- S exp(seg_end) + sum_j (B_j wst_j) x_j^T
    float accs[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) accs[i][j] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += kBlk) {
      const int nc = min(kBlk, Q - j0);
      load_bx(Bs, Xs, bb, xb, c0 + j0, nc, N, P, nn, pp, tid);
      if (tid < kBlk)
        wst[tid] = tid < nc
                       ? expf(seg_end - cum[j0 + tid]) * dts[j0 + tid]
                       : 0.f;
      __syncthreads();
      lm::mm_acc<8, 8>(accs, Bs, lb, Xs, pp, kBlk, rmn, cmp, ty, tx, wst);
      __syncthreads();
    }
    const float e = expf(seg_end);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i < rmn && j < cmp) {
          const int idx = (ty + 16 * i) * pp + tx + 16 * j;
          S[idx] = S[idx] * e + accs[i][j];
        }
    __syncthreads();
  }

  float* sf = s_final + static_cast<size_t>(bh) * N * P;
  for (int idx = tid; idx < N * P; idx += lm::kThreads)
    sf[idx] = S[(idx / P) * pp + idx % P];
}

template <typename T>
int launch(const float* a, const void* x, const float* dt, const void* b,
           const void* c, void* y, float* s_final, int bh, int L, int P,
           int N, int Q, int rep, cudaStream_t stream) {
  const int pp = (P + 15) / 16 * 16, nn = (N + 15) / 16 * 16;
  const size_t smem = sizeof(float) * smem_floats(nn, pp, Q);
  cudaError_t e = lm::allow_smem(ssd_fwd<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_fwd<T><<<bh, lm::kThreads, smem, stream>>>(
      a, static_cast<const T*>(x), dt, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), s_final, L, P, N, pp, nn,
      Q, rep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (bh,) float32; x (bh, L, P); dt (bh, L) float32; b, c (bh / rep, L, N);
// y (bh, L, P); s_final (bh, N, P) float32; x, b, c, y all float32
// (is_bf16 = 0) or all bfloat16. Needs L % Q == 0, bh % rep == 0,
// 1 <= P, N <= 128.
extern "C" int ssd_scan_launch(int is_bf16, const void* a, const void* x,
                               const void* dt, const void* b, const void* c,
                               void* y, void* s_final, int bh, int L, int P,
                               int N, int Q, int rep, void* stream) {
  if (bh < 1 || L < 1 || Q < 1 || L % Q || rep < 1 || bh % rep || P < 1 ||
      P > 128 || N < 1 || N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dtf = static_cast<const float*>(dt);
  float* sf = static_cast<float*>(s_final);
  if (is_bf16)
    return launch<__nv_bfloat16>(af, x, dtf, b, c, y, sf, bh, L, P, N, Q,
                                 rep, s);
  return launch<float>(af, x, dtf, b, c, y, sf, bh, L, P, N, Q, rep, s);
}
