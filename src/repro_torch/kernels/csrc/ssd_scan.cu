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
// bfloat16 (ssd_fwd_wgmma, the main path's): Hopper's wgmma and TMA, the
// chain of flash_attention.cu's flash_fwd_wgmma with G = C B^T for q k^T,
// W = G 2^(cum_i - cum_j) dt_j (j <= i) for P, W x for P v. One
// warpgroup of 128 threads a block runs one head bh (and one 64-column
// slice of P: P past 64 is two independent slices, each its own block,
// W formed in both) through its chunks in order. The grid's blocks of a
// group's heads are neighbours, so its B and C come from L2. Builds of
// N <= 64 and N <= 128 (one or two 64-column TMA boxes; three blocks an
// SM and two, by registers and shared memory). Per chunk:
//   - dt and log2 e times the cumsum of dt A (four warp scans and their
//     carries), and w_t = 2^(cum_Q - cum_t) dt_t, in shared memory;
//   - per 64-row tile i: C_i (a TMA ring of two); y = 2^cum_i C_i S
//     (wgmma from shared memory, S's bfloat16 copy as a transposed B);
//     then for each 64-row tile j <= i, B_j and x_j (a TMA ring of two
//     slots, 3-D maps that zero-fill past L and the row width): G = C_i
//     B_j^T (wgmma m64n64k16, both operands from shared memory), W in
//     float32 registers (masked to j <= i on the diagonal tile, every
//     weight of a row past the chunk 2^-inf = 0), rounded to bfloat16 A
//     fragments, y += W x_j (wgmma with A from registers, x transposed
//     B); y through shared memory to 16-byte stores (rows past the chunk
//     are not stored);
//   - the state, S <- 2^cum_Q S + (B w)^T x_j over the tiles j, in the
//     last row tile, which reads every (B, x) tile of the chunk: beside
//     its W x_j, (B w)^T by ldmatrix.trans of B's swizzled tile, times
//     w_j and rounded to bfloat16 in registers, an A fragment of wgmma
//     against x_j. S stays float32 in the warpgroup's accumulator
//     registers over the chunks (N 128: two m64 halves) and is written
//     from there, never read back: into `states` (before chunk c >= 1),
//     s_final (after the last), and its bfloat16 copy in shared memory
//     for the next chunk.
// The leader thread requests every tile in the order the warpgroup reads
// it; a slot is refilled after a block barrier that follows the wgmma
// waits of its last reader. Every sum runs in a fixed order (no atomics):
// two launches give the same bits. The roundings the plain version
// lacks: W, S and B w to bfloat16 as operands (C, B and x are bfloat16
// already), each one bfloat16 step of its value; exponentials by ex2.approx
// (2 ulp). Sums are float32 in another order. The wrapper zero-pads x, B
// and C to a multiple of 8 columns (TMA's 16-byte row strides); P, N <=
// 128; Q up to what shared memory holds (fwd_wgmma_smem: 10,368 at N
// 128, 13,760 at N 64).
//
// float32 (ssd_fwd): on the CUDA cores, unchanged since first ported (the
// float32 tolerance, 1e-4, rules out bfloat16 and TF32 products). The
// TPU grid's sequential chunk axis becomes a loop inside one
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
// the bfloat16 tensor-core rate, so bytes bound it. The bfloat16 kernel
// forms G on whole 64 x 64 tiles, at or below the diagonal, and one
// exponential for each of their elements: 896 heads x 2 chunks x 10 tile
// pairs x 4,096 = 7.3e7 ex2 at this shape, 0.019 ms at the SFU's 3.9e12
// a second, half the bytes bound (Mamba2-1.3B's, BH 512: 4.2e7, 0.011
// ms). Its grid is 896 blocks, three an SM (168 registers a thread):
// 2.26 waves of 396 (Mamba2's 512 blocks, two an SM: 1.94 waves of 264).
// Each block's chain of dependent products and waits, not the bytes, the
// products or the exponentials, sets its time (scripts/ssd_fwd_ablate.py:
// no variant that drops one of them saves a third of it). The float32
// build multiplies on the CUDA cores (67 TFLOP/s at most).
//
// Both forward builds take an optional `states` buffer (bh, L / Q - 1, N,
// P) float32 and write into it S_c, the float32 state before each chunk c
// >= 1, for the backward (as flash's forward saves its log-sum-exp);
// serving passes none.
//
// Backward (ssd_bwd_mma for bfloat16, ssd_bwd for float32). It replaces
// no TPU kernel: the TPU has none, and the reference differentiates its
// jnp ssd_chunked (src/repro/models/mamba.py:70); the port trains through
// the forward kernel, so it needs this one. From dy and an optional
// d(s_final) it computes dx, ddt, da (d of each row's A) and dB, dC. Per
// row bh the chunks are walked from the last to the first, carrying dS,
// the float32 gradient of the state after the chunk (d(s_final), or
// zero). Per chunk, with cum the inclusive cumsum of dt a, L_ij =
// exp(cum_i - cum_j) (j <= i only: never formed above the diagonal, where
// the exponent is positive), G = C B^T, W = G L dt_j and w_j = exp(cum_Q -
// cum_j) dt_j:
//   intra: dx += W^T dy; dW = dy x^T, dG = dW L dt_j; dC += dG B,
//          dB += dG^T C; ddt_j += sum_i dW G L; dcum_i += sum_j dW W,
//          dcum_j -= sum_i dW W;
//   inter: dC_i += exp(cum_i) S_c dy_i, dcum_i += exp(cum_i) (C_i S_c).dy_i,
//          d(S_c) gains sum_i exp(cum_i) C_i^T dy_i;
//   state: dB_j += w_j dS x_j, dx_j += w_j dS^T B_j, dw_j = B_j^T dS x_j:
//          ddt_j += exp(cum_Q - cum_j) dw_j, dcum_j -= w_j dw_j, dcum_Q +=
//          sum_j w_j dw_j + exp(cum_Q) <S_c, dS>;
//   then dS <- exp(cum_Q) dS + the inter part, and the cumsum's backward:
//   d(da)_k = sum_{i >= k} dcum_i (a reverse warp scan), ddt_k += a
//   d(da)_k, da += sum_k dt_k d(da)_k.
// dB and dC are summed over a group's heads without float atomics: each
// block adds its heads' rows, in order, into its own float32 partial (L,
// N), and the wrapper sums a group's partials in order (the gradient of
// the reference's jnp.repeat of B and C over the heads). Every sum runs
// in a fixed order, so two launches give the same bits. The inter-chunk
// products are skipped at chunk 0 (its state is zero and the initial
// state's gradient is no output).
//
// bfloat16 (ssd_bwd_mma, the training path's): on the tensor cores, with
// mma.sync m16n8k16 (lm_mma.cuh), bfloat16 operands and float32 sums. One
// block of 8 warps runs `nh` heads of one group (the host's
// ssd_scan.py::bwd_mma_heads picks nh, at most 2 at P <= 64 and 1 above,
// where each head's dx_j sums stay in registers; ceil(rep / nh) blocks a
// group, the last with the rest; one block an SM, its 255 registers a
// thread). Warp w owns 16 rows (w % 4) of a 64-row tile and half w / 4 of
// the tile's columns. Per chunk:
//   - each head's cumsum, times log2 e (every exponential one exp2f);
//   - the column walk, per 64-row tile j: B_j and each head's x_j into
//     shared memory (cp.async); the state terms (U = B_j dS, over this
//     half of N; V = x_j dS^T over this half's columns n, times w_j and
//     summed over the heads into dB_j); then every tile pair (j, i >= j),
//     C_i and the heads' dy_i in a double-buffered cp.async ring: G^T =
//     B_j C_i^T ONCE for the block's heads, per head dW^T = x_j dy_i^T,
//     then in float32 registers L, W, dG and the row (over i) and column
//     (over j, warp reductions, then four row blocks in order) sums, W^T
//     packed to bfloat16 as the A fragments of dx_j += W^T dy_i (dx_j in
//     registers over the walk); the heads' dG summed in float32, rounded
//     once to a bfloat16 [j][i] tile, then ONE dB_j += dG^T C_i (dB_j in
//     registers) and ONE dC_i = dG B_j (ldmatrix.trans), stored into the
//     block's partial at j = 0 and added after (each element by one
//     thread); at the tile's end the two halves' dx_j and row sums meet
//     in shared memory and dx_j, dB_j and ddt_j's share are written;
//   - the row walk (chunks > 0), per 64-row tile i: dy_i S_c^T per head
//     (S_c float32 from `states`), into dC_i and dcum_i; dS +=
//     (exp(cum_i) C_i)^T dy_i in place (dS float32 in shared memory);
//   - the cumsum's backward, a warp a head (warp reductions, fixed order).
// The roundings the plain version lacks, each at most one bfloat16 step of
// its value: W as the operand of W^T dy; the block's summed dG for dG B
// and dG^T C; dS for x dS^T (dB alone). The products that reach ddt and
// da, float32 outputs held to the float32 tolerance, take their float32
// operand as two bfloat16 terms hi + lo (about 2^-16 of its value, two
// mma.sync each): dS for B dS, S_c for dy S_c^T, exp(cum_i) C_i for
// (exp(cum_i) C_i)^T dy. Rows past the chunk and columns past P, N are
// zero-filled. P, N <= 128; Q up to what shared memory holds (bwd_mma_smem:
// 7,360 at P 64, N 128; 10,816 at P = N = 64; 1,216 at P = N = 128).
//
// What bounds it. At Mamba2-1.3B's training shape (BH 512, L 512, P 64,
// N 128, Q 256, rep 64; chip_smoke.py::ssd_bwd_bound) the least work is
// 2.2e10 operations (C B^T, dG B and dG^T C once a group, not a head;
// 0.0222 ms at the bfloat16 peak) against 140 MB of traffic (0.0419 ms
// at 3.35 TB/s): bytes bound it. At Zamba2-7B's (BH 896, N 64, rep 112)
// 0.0631 ms, bytes (operations 0.0269). This design does 4.8e10 a launch
// at Mamba2's shape (5.2e10 at Zamba2's): the group's products once a
// block of 2 heads, not a group of 64 or 112; whole 64 x 64 tiles on the
// diagonal; the split operands' second products.
//
// float32 (ssd_bwd): on the CUDA cores (the float32 tolerance, 1e-4,
// rules out bfloat16 and TF32 products). A block of 256 threads runs hb
// heads of one group in turn (hb divides rep; the host picks it so the
// grid fills the SMs in the fewest waves). Per chunk it walks the column
// tiles j of 64 rows (32 where shared memory cannot hold 64 at P, N =
// 128) with dx_j and dB_j in registers (the state terms, then the
// intra-chunk terms over the row tiles i >= j), then the row tiles i with
// dC_i in registers (the inter-chunk terms, then the intra-chunk terms
// over the column tiles j <= i), recomputing G and dW in each walk, every
// tile float32 in shared memory, every product lm::mm_acc_strided. Shared
// memory bounds Q: at P = 64 up to 5,171 (N = 128) and 7,654 (N = 64); at
// P = N = 128 up to 1,075 (the forward takes more).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "lm_mma.cuh"
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
            float* __restrict__ s_final, float* __restrict__ states, int L,
            int P, int N, int pp, int nn, int Q, int rep) {
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
    // the state before the next chunk, saved for the backward
    float* st = states != nullptr && c0 + Q < L
                    ? states + (static_cast<size_t>(bh) * (L / Q - 1) +
                                c0 / Q) * N * P
                    : nullptr;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i < rmn && j < cmp) {
          const int n = ty + 16 * i, p = tx + 16 * j;
          const int idx = n * pp + p;
          S[idx] = S[idx] * e + accs[i][j];
          if (st != nullptr && n < N && p < P)
            st[static_cast<size_t>(n) * P + p] = S[idx];
        }
    __syncthreads();
  }

  float* sf = s_final + static_cast<size_t>(bh) * N * P;
  for (int idx = tid; idx < N * P; idx += lm::kThreads)
    sf[idx] = S[(idx / P) * pp + idx % P];
}

// ---------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;
using lm::ex2;
using lm::static_for;
constexpr int kTile = 64;  // rows of a chunk's tile; 64 columns a TMA box
constexpr float kLog2e = 1.4426950408889634f;

// rows [0, 64) of a (., W) bfloat16 matrix at src into a [64][ld] tile,
// the first 16 wk columns, zeros at rows >= valid and columns >= W, by
// `nt` threads (this one is `tid`). 16-byte cp.async where rows are
// 16-byte aligned (W % 8 == 0), else plain loads.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int W, int wk, int valid, int tid,
                                          int nt) {
  const int wp = 16 * wk;
  if (W % 8 == 0) {
    const int cpr = wp / 8;
    for (int idx = tid; idx < kTile * cpr; idx += nt) {
      const int r = idx / cpr, c = idx % cpr * 8;
      const bool ok = r < valid && c < W;
      lm::cp_async16(lm::smem_u32(dst + r * ld + c),
                     ok ? src + static_cast<size_t>(r) * W + c : src, ok);
    }
  } else {
    for (int idx = tid; idx < kTile * wp; idx += nt) {
      const int r = idx / wp, c = idx % wp;
      dst[r * ld + c] = r < valid && c < W
                            ? src[static_cast<size_t>(r) * W + c]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

// acc (16 rows x 16 pk) += A (16 x 16) * rows [16 kk, 16 kk + 16) of a
// [.][ld] bfloat16 tile (k-major: row k, column p), ldmatrix.trans
template <int PK>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * PK][4],
                                         const uint32_t (&a)[4],
                                         const bf16* tile, int ld, int kk,
                                         int pk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dp = 0; dp < PK; ++dp) {
    if (dp >= pk) break;
    uint32_t b[4];
    lm::ldmatrix_x4_trans(
        b, lm::smem_u32(tile + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   ld +
                        dp * 16 + (lane >> 4) * 8));
    lm::mma_bf16_16816(acc[2 * dp], a, b[0], b[1]);
    lm::mma_bf16_16816(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// ssd_fwd_wgmma<NB>: the bfloat16 forward, one warpgroup a block, N in
// NB boxes of 64 columns (1: N <= 64, 2: N <= 128), one 64-column slice
// of P a block (see the header).
constexpr int kFwdThreads = 128;
constexpr uint32_t kBoxBytes = kTile * kTile * 2;  // 64 rows of 128 bytes
constexpr int kFwdStages = 2;                      // (B, x) ring slots
constexpr int kCSlots = 2;                         // C ring slots

template <int NB>
struct FwdTiles {
  static constexpr uint32_t kNBytes = NB * kBoxBytes;     // a C or B tile
  static constexpr uint32_t kSlot = kNBytes + kBoxBytes;  // B, then x
  // the C ring, the (B, x) ring, S in bfloat16 (NB * 64 rows of 64), y's
  // tile on its way out
  static constexpr uint32_t kTiles =
      kCSlots * kNBytes + kFwdStages * kSlot + kNBytes + kBoxBytes;
};

// Shared memory of a launch at chunk q: per chunk row t, log2 e times
// the cumsum, dt and w_t = 2^(cum_Q - cum_t) dt_t (float32), the warps'
// four partial sums and the barriers, then (aligned to the swizzle's
// 1,024 bytes) the tiles
size_t fwd_wgmma_smem(int nb, int q) {
  const size_t qp = (q + kTile - 1) / kTile * kTile;
  const size_t head = 4 * (3 * qp + 4) + 8 * (kCSlots + kFwdStages);
  return head + 1024 + (nb == 1 ? FwdTiles<1>::kTiles : FwdTiles<2>::kTiles);
}

template <int NB>
__global__ void __launch_bounds__(kFwdThreads, NB == 1 ? 3 : 2)
    ssd_fwd_wgmma(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c,
                  const float* __restrict__ a, const float* __restrict__ dt,
                  bf16* __restrict__ y, float* __restrict__ s_final,
                  float* __restrict__ states, int L, int P, int N, int Q,
                  int rep, int slices) {
  using T = FwdTiles<NB>;
  constexpr int S = kFwdStages, KN = 4 * NB;  // k-steps of 16 over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qp = (Q + kTile - 1) / kTile * kTile, nt = qp / kTile;
  float* cum = reinterpret_cast<float*>(smem_raw);  // [qp] log2 e cumsum
  float* dts = cum + qp;                            // [qp] dt
  float* wst = dts + qp;                            // [qp] w_t
  float* tot = wst + qp;                            // [4] the warps' sums
  const uint32_t base = lm::smem_u32(smem_raw);
  const uint32_t c_full = base + 4 * (3 * qp + 4);  // [kCSlots] C tiles
  const uint32_t x_full = c_full + 8 * kCSlots;      // [S] (B, x) slots
  // the 128-byte swizzle repeats every 1,024 bytes: align the tiles to it
  const uint32_t cs = (x_full + 8 * S + 1023u) & ~1023u;  // [.][NB][64][64]
  const uint32_t ring = cs + kCSlots * T::kNBytes;  // [S] B [NB][64][64], x
  const uint32_t sb = ring + S * T::kSlot;    // [NB * 64][64] S, bfloat16
  unsigned char* ys = smem_raw + (sb + T::kNBytes - base);  // [64][64] y

  const int bh = blockIdx.x / slices, ps = blockIdx.x % slices;
  const int grp = bh / rep, chunks = L / Q;
  const int per_chunk = nt * (nt + 1) / 2;  // tile pairs j <= i
  const int n_c = chunks * nt, n_bx = chunks * per_chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bool leader = tid == 0;
  // The leader requests every tile, in the order the warpgroup reads
  // them: C tile (chunk, it) for each row tile of each chunk into a ring
  // of kCSlots; per chunk the (B, x) tiles j = 0..it of each row tile it,
  // into a ring of S. The i-th of either goes to slot i % ring and
  // completes that slot's phase i / ring.
  int c_next = 0, bx_next = 0;
  auto request_c = [&]() {
    if (c_next >= n_c) return;
    const int s = c_next % kCSlots;
    const int row = c_next / nt * Q + c_next % nt * kTile;
    // after the wgmma reads of the slot (waited, then a block barrier)
    // and before TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    lm::mbar_expect_tx(c_full + 8 * s, T::kNBytes);
    for (int b = 0; b < NB; ++b)
      lm::tma_load_3d(cs + s * T::kNBytes + b * kBoxBytes, &map_c,
                      c_full + 8 * s, b * kTile, row, grp);
    ++c_next;
  };
  auto request_bx = [&]() {
    if (bx_next >= n_bx) return;
    const int s = bx_next % S, r = bx_next % per_chunk;
    int it = 0;  // row tile it's column tile j
    while ((it + 1) * (it + 2) / 2 <= r) ++it;
    const int j = r - it * (it + 1) / 2;
    const int row = bx_next / per_chunk * Q + j * kTile;
    const uint32_t slot = ring + s * T::kSlot;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    lm::mbar_expect_tx(x_full + 8 * s, T::kSlot);
    for (int b = 0; b < NB; ++b)
      lm::tma_load_3d(slot + b * kBoxBytes, &map_b, x_full + 8 * s,
                      b * kTile, row, grp);
    lm::tma_load_3d(slot + T::kNBytes, &map_x, x_full + 8 * s, ps * kTile,
                    row, bh);
    ++bx_next;
  };
  if (leader) {
    for (int s = 0; s < kCSlots; ++s) lm::mbar_init(c_full + 8 * s, 1);
    for (int s = 0; s < S; ++s) lm::mbar_init(x_full + 8 * s, 1);
    lm::mbar_fence_init();
    for (int s = 0; s < kCSlots; ++s) request_c();
    for (int s = 0; s < S; ++s) request_bx();
  }
  __syncthreads();

  // S (float32, N x this slice's 64 columns of P) stays in registers over
  // the chunks: half h holds rows 64 h + 16 warp + g4 (+ 8)
  float sacc[NB][32];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[h][i] = 0.f;
  float yacc[32];     // y of the row tile, float32
  float gw[32];       // G = C B^T, then W, float32
  uint32_t pa[4][4];  // W in bfloat16, the A fragments of 4 k16 steps
  // descriptors: C's and B's tiles K-major (rows of N values), x's tile
  // and S's copy N-major (rows of 64 values of P: LBO steps a box, SBO 8
  // rows); a k-step's offset is immediate
  const uint32_t hi = lm::desc_hi_sw128(1024);
  const uint32_t s_lo = lm::desc_lo(sb, kBoxBytes);
  const float av = a[bh];
  const float* dth = dt + static_cast<size_t>(bh) * L;
  const int seg = qp / 4;  // rows of the chunk a warp scans
  int uc = 0, ubx = 0;     // C tiles and (B, x) tiles read so far

  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * Q;
    // ---- dt, and log2 e times its cumsum with A: each warp scans its
    // quarter of the rows, then adds the sums of the quarters before it
    float carry = 0.f;
    for (int t0 = 0; t0 < seg; t0 += 32) {
      const int t = warp * seg + t0 + lane;
      const bool in = t0 + lane < seg;
      const float d = in && t < Q ? dth[c0 + t] : 0.f;
      float v = d * av;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float nb = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += nb;
      }
      v += carry;
      if (in) {
        cum[t] = v;
        dts[t] = d;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) tot[warp] = carry;
    __syncthreads();
    float before = 0.f;
    for (int w = 0; w < warp; ++w) before += tot[w];
    for (int t0 = 0; t0 < seg; t0 += 32) {
      const int t = warp * seg + t0 + lane;
      if (t0 + lane < seg) cum[t] = t < Q ? (cum[t] + before) * kLog2e : 0.f;
    }
    __syncthreads();
    const float cq = cum[Q - 1];
    for (int t = tid; t < qp; t += kFwdThreads)
      wst[t] = ex2(cq - cum[t]) * dts[t];  // 0 past Q, where dt is

    // (B w)^T's A fragments for tile j, B_j in `b_tile`: ldmatrix.trans
    // of B's swizzled tile, times w_j, rounded to bfloat16
    auto state_operand = [&](uint32_t(&af)[NB][4][4], uint32_t b_tile,
                             int j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // lane's row of B (j) and 8 columns (n) of ldmatrix's four 8 x 8
        // matrices: a0 (j, n), a1 (j, n + 8), a2 (j + 8, n), a3 (both)
        const int r = kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
        const int cb = warp * 2 + ((lane >> 3) & 1);
        const int jj = j * kTile + kk * 16 + 2 * t4;
        const float w0 = wst[jj], w1 = wst[jj + 1], w8 = wst[jj + 8],
                    w9 = wst[jj + 9];
#pragma unroll
        for (int h = 0; h < NB; ++h) {
          lm::ldmatrix_x4_trans(af[h][kk], b_tile + h * kBoxBytes + r * 128 +
                                               ((cb ^ (r & 7)) << 4));
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // a0, a1: j 2t4..; a2, a3: + 8
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&af[h][kk][q]));
            af[h][kk][q] = q < 2 ? lm::pack_bf16x2(v.x * w0, v.y * w1)
                                 : lm::pack_bf16x2(v.x * w8, v.y * w9);
          }
        }
      }
    };
    // S += (B w)^T x_j, x_j at x_lo
    auto issue_state = [&](uint32_t(&af)[NB][4][4], uint32_t x_lo) {
#pragma unroll
      for (int h = 0; h < NB; ++h)
        static_for<4>([&](auto step) {  // the state's products
          constexpr int kk = decltype(step)::value;
          lm::wgmma_m64n64k16_rs_tb<kk * 2048 / 16>(sacc[h], af[h][kk], x_lo,
                                                    hi);
        });
    };
    auto fence_state = [&](uint32_t(&af)[NB][4][4]) {
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        lm::fence_regs(sacc[h]);
        lm::fence_regs(af[h]);
      }
    };

    // ---- y, a row tile of 64 at a time
    for (int it = 0; it < nt; ++it, ++uc) {
      const uint32_t c_lo =
          lm::desc_lo(cs + uc % kCSlots * T::kNBytes, 16);
      const int i_lo = it * kTile + warp * 16 + g4, i_hi = i_lo + 8;
      // rows past the chunk: every weight 2^-inf = 0, nothing stored
      const float cum_lo = i_lo < Q ? cum[i_lo] : -INFINITY;
      const float cum_hi = i_hi < Q ? cum[i_hi] : -INFINITY;
      // the last row tile reads every (B, x) tile of the chunk: it also
      // runs the state's products, beside W x (measured faster than a walk
      // of their own, scripts/ssd_fwd_ablate.py)
      const bool fold = it == nt - 1;
      lm::mbar_wait(c_full + 8 * (uc % kCSlots), (uc / kCSlots) & 1);
      if (ch > 0) {
        // y = 2^cum_i C_i S, S in bfloat16 from before this chunk
        lm::fence_regs(yacc);
        lm::wgmma_fence();
        static_for<KN>([&](auto step) {  // C S's k-steps
          constexpr int kk = decltype(step)::value;
          lm::wgmma_m64n64k16_ss_tb<(kk / 4 * kBoxBytes + kk % 4 * 32) / 16,
                                    kk * 2048 / 16>(yacc, c_lo, s_lo, hi,
                                                    kk > 0);
        });
        lm::wgmma_commit();
        lm::wgmma_wait<0>();
        lm::fence_regs(yacc);
        const float e_lo = ex2(cum_lo), e_hi = ex2(cum_hi);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          yacc[4 * n] *= e_lo;
          yacc[4 * n + 1] *= e_lo;
          yacc[4 * n + 2] *= e_hi;
          yacc[4 * n + 3] *= e_hi;
        }
        if (fold) {  // S <- 2^cum_Q S, before the chunk's terms
          const float e = ex2(cq);
#pragma unroll
          for (int h = 0; h < NB; ++h)
#pragma unroll
            for (int i = 0; i < 32; ++i) sacc[h][i] *= e;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
      }
      for (int j = 0; j <= it; ++j, ++ubx) {
        const int s = ubx % S;
        const uint32_t b_tile = ring + s * T::kSlot;
        // G = C_i B_j^T, on its own: issued beside the previous tile's W x
        // (and the state's products) ptxas serialises the wgmma, slower
        // (scripts/ssd_fwd_ablate.py)
        lm::mbar_wait(x_full + 8 * s, (ubx / S) & 1);
        lm::fence_regs(gw);
        lm::wgmma_fence();
        const uint32_t b_lo = lm::desc_lo(b_tile, 16);
        static_for<KN>([&](auto step) {  // G's k-steps
          constexpr int kk = decltype(step)::value;
          constexpr int off = (kk / 4 * kBoxBytes + kk % 4 * 32) / 16;
          lm::wgmma_m64n64k16_ss<off, off>(gw, c_lo, b_lo, hi, kk > 0);
        });
        lm::wgmma_commit();
        lm::wgmma_wait<0>();
        lm::fence_regs(gw);
        // W = G 2^(cum_i - cum_j) dt_j, j <= i on the diagonal tile
        const bool diag = j == it;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = j * kTile + 8 * n + 2 * t4 + e;
            const float cj = cum[jj], dj = dts[jj];
            const float w_lo = gw[4 * n + e] * ex2(cum_lo - cj) * dj;
            const float w_hi = gw[4 * n + 2 + e] * ex2(cum_hi - cj) * dj;
            gw[4 * n + e] = diag && jj > i_lo ? 0.f : w_lo;
            gw[4 * n + 2 + e] = diag && jj > i_hi ? 0.f : w_hi;
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 4; ++h)
            pa[kk][h] = lm::pack_bf16x2(gw[8 * kk + 2 * h],
                                        gw[8 * kk + 2 * h + 1]);
        uint32_t af[NB][4][4];
        if (fold) state_operand(af, b_tile, j);
        // y += W x_j, and in the last row tile the state's terms
        lm::fence_regs(yacc);
        lm::fence_regs(pa);
        lm::fence_regs(gw);
        if (fold) fence_state(af);
        lm::wgmma_fence();
        const uint32_t x_lo = lm::desc_lo(b_tile + T::kNBytes, kBoxBytes);
        static_for<4>([&](auto step) {  // W x's k-steps
          constexpr int kk = decltype(step)::value;
          lm::wgmma_m64n64k16_rs_tb<kk * 2048 / 16>(yacc, pa[kk], x_lo, hi);
        });
        if (fold) issue_state(af, x_lo);
        lm::wgmma_commit();
        lm::wgmma_wait<0>();
        lm::fence_regs(yacc);
        lm::fence_regs(pa);
        lm::fence_regs(gw);
        if (fold) fence_state(af);
        __syncthreads();  // every warp is done with the slot (and C's)
        if (leader) {
          request_bx();
          if (diag) request_c();
        }
      }
      // y through shared memory (rows of 128 bytes, swizzled as TMA's:
      // no bank conflict either way), then 16 coalesced bytes a thread;
      // rows past the chunk and columns past P are not stored
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + g4 + 8 * hh, pc = 8 * n + 2 * t4;
          *reinterpret_cast<uint32_t*>(ys + r * 128 +
                                       (((pc >> 3) ^ (r & 7)) << 4) +
                                       (pc & 7) * 2) =
              lm::pack_bf16x2(yacc[4 * n + 2 * hh], yacc[4 * n + 2 * hh + 1]);
        }
      __syncthreads();
      bf16* yr = y + (static_cast<size_t>(bh) * L + c0 + it * kTile) * P +
                 ps * kTile;
      for (int k = tid; k < kTile * 8; k += kFwdThreads) {
        const int r = k >> 3, cc = k & 7;  // P % 8 == 0: whole 16 bytes
        if (it * kTile + r < Q && ps * kTile + 8 * cc < P)
          *reinterpret_cast<uint4*>(yr + static_cast<size_t>(r) * P +
                                    8 * cc) =
              *reinterpret_cast<const uint4*>(ys + r * 128 +
                                              ((cc ^ (r & 7)) << 4));
      }
    }

    // S after the chunk: its bfloat16 copy for the next chunk's C S (in
    // the swizzled layout TMA would give it), and the state saved for the
    // backward, or after the last chunk s_final
    const bool last = ch + 1 == chunks;
    float* out = last ? s_final + static_cast<size_t>(bh) * N * P
                 : states != nullptr
                     ? states + (static_cast<size_t>(bh) * (chunks - 1) + ch) *
                                    N * P
                     : nullptr;
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = h * kTile + warp * 16 + g4 + 8 * hh;  // row of N
          const int pc = 8 * n + 2 * t4, p = ps * kTile + pc;
          const float v0 = sacc[h][4 * n + 2 * hh];
          const float v1 = sacc[h][4 * n + 2 * hh + 1];
          if (!last)
            *reinterpret_cast<uint32_t*>(
                smem_raw + (sb - base) + r * 128 +
                (((pc >> 3) ^ (r & 7)) << 4) + (pc & 7) * 2) =
                lm::pack_bf16x2(v0, v1);
          if (out != nullptr && r < N && p < P)
            *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * P + p) =
                make_float2(v0, v1);
        }
    // the copy's generic writes before the next chunk's wgmma reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

// x (bh, L, P), b and c (bh / rep, L, N), bfloat16, P and N their row
// widths: multiples of 8 (TMA's 16-byte row strides; the wrapper
// zero-pads to them), 16-byte aligned; y (bh, L, P), s_final and states
// at (N, P)
template <int NB>
int launch_fwd_wgmma(const float* a, const void* x, const float* dt,
                     const void* b, const void* c, void* y, float* s_final,
                     float* states, int bh, int L, int P, int N, int Q,
                     int rep, cudaStream_t stream) {
  const size_t smem = fwd_wgmma_smem(NB, Q);
  if (P % 8 || N % 8 || smem > 227 * 1024 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_b, map_c;
  if (!lm::make_head_map(&map_x, x, P, L, bh, kTile) ||
      !lm::make_head_map(&map_b, b, N, L, bh / rep, kTile) ||
      !lm::make_head_map(&map_c, c, N, L, bh / rep, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = lm::allow_smem(ssd_fwd_wgmma<NB>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int slices = (P + kTile - 1) / kTile;
  ssd_fwd_wgmma<NB><<<bh * slices, kFwdThreads, smem, stream>>>(
      map_x, map_b, map_c, a, dt, static_cast<bf16*>(y), s_final, states, L,
      P, N, Q, rep, slices);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* a, const void* x, const float* dt, const void* b,
           const void* c, void* y, float* s_final, float* states, int bh,
           int L, int P, int N, int Q, int rep, cudaStream_t stream) {
  const int pp = (P + 15) / 16 * 16, nn = (N + 15) / 16 * 16;
  const size_t smem = sizeof(float) * smem_floats(nn, pp, Q);
  cudaError_t e = lm::allow_smem(ssd_fwd<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_fwd<T><<<bh, lm::kThreads, smem, stream>>>(
      a, static_cast<const T*>(x), dt, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), s_final, states, L, P, N,
      pp, nn, Q, rep);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ backward
// ssd_bwd: see the header. One block of 256 threads (a 16 x 16 grid
// (ty, tx), as the float32 forward) runs `hb` heads of one group in turn,
// each through its chunks from the last to the first, every tile float32
// in shared memory, every product on the CUDA cores
// (lm::mm_acc_strided).
constexpr int kMaxRt = kBlk / 16;  // row groups of a tile of 64 rows

// Shared memory of the backward, in floats, for tiles of `tr` rows.
size_t bwd_smem_floats(int nn, int pp, int tr, int q) {
  const size_t ldn = nn + 1, ldp = pp + 1, ldt = tr + 1;
  return 2 * nn * ldp              // dS, S_c
         + 2 * tr * (ldn + ldp)    // B_j, x_j, C_i, dy_i
         + 2 * tr * ldt            // W, dG
         + 2 * 16 * tr             // column sums, 16 partials a column
         + 5 * static_cast<size_t>(q)  // cum, dt, dcum, ddt, w_j dw_j
         + 2 * tr;                 // exp(cum_i), w_j of a tile
}

// rows [0, tr) of a (., W) matrix at src into a [tr][ld] float32 tile, the
// first wp columns, zeros at rows >= valid and columns >= W
template <typename T>
__device__ __forceinline__ void bwd_load(float* dst, int ld, const T* src,
                                         int valid, int W, int wp, int tr) {
  for (int idx = threadIdx.x; idx < tr * wp; idx += lm::kThreads) {
    const int r = idx / wp, c = idx % wp;
    dst[r * ld + c] =
        r < valid && c < W ? lm::to_f32(src[static_cast<size_t>(r) * W + c])
                           : 0.f;
  }
}

template <int RM, int CM>
__device__ __forceinline__ void bwd_zero(float (&acc)[RM][CM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;
}

// the sum over the 16 threads of one ty (a half warp); every lane gets
// the same bits
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NM, PM: N and P in groups of 16 at most (4 or 8)
template <typename T, int NM, int PM>
__global__ void __launch_bounds__(lm::kThreads)
    ssd_bwd(const float* __restrict__ a, const T* __restrict__ x,
            const float* __restrict__ dt, const T* __restrict__ b,
            const T* __restrict__ c, const T* __restrict__ dy,
            const float* __restrict__ states,
            const float* __restrict__ ds_final, T* __restrict__ dx,
            float* __restrict__ ddt, float* __restrict__ da,
            float* __restrict__ db_part, float* __restrict__ dc_part, int L,
            int P, int N, int Q, int rep, int hb, int tr) {
  extern __shared__ __align__(16) float sm[];
  const int nn = (N + 15) / 16 * 16, pp = (P + 15) / 16 * 16;
  const int ldn = nn + 1, ldp = pp + 1, ldt = tr + 1;
  float* dS = sm;               // [nn][ldp] d(state after the chunk)
  float* Sc = dS + nn * ldp;    // [nn][ldp] the state before the chunk
  float* Bj = Sc + nn * ldp;    // [tr][ldn]
  float* Xj = Bj + tr * ldn;    // [tr][ldp]
  float* Ci = Xj + tr * ldp;    // [tr][ldn]
  float* DYi = Ci + tr * ldn;   // [tr][ldp]
  float* Ws = DYi + tr * ldp;   // [tr][ldt] W (i, j)
  float* dGs = Ws + tr * ldt;   // [tr][ldt] dG (i, j)
  float* cs1 = dGs + tr * ldt;  // [16][tr]
  float* cs2 = cs1 + 16 * tr;   // [16][tr]
  float* cum = cs2 + 16 * tr;   // [Q]
  float* dts = cum + Q;         // [Q]
  float* dcum = dts + Q;        // [Q] d(cum)
  float* dd = dcum + Q;         // [Q] d(dt) but the cumsum's share
  float* wdw = dd + Q;          // [Q] w_j dw_j
  float* er = wdw + Q;          // [tr] exp(cum_i) of a row tile
  float* wst = er + tr;         // [tr] w_j of a column tile

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15,
            lane = tid & 31;
  const int rt = tr / 16, nm = nn / 16, pm = pp / 16, nc = L / Q;
  const int grp = blockIdx.x * hb / rep;
  const T* bg = b + static_cast<size_t>(grp) * L * N;
  const T* cg = c + static_cast<size_t>(grp) * L * N;
  float* dbb = db_part + static_cast<size_t>(blockIdx.x) * L * N;
  float* dcb = dc_part + static_cast<size_t>(blockIdx.x) * L * N;

  for (int hh = 0; hh < hb; ++hh) {
    const int bh = blockIdx.x * hb + hh;
    const float av = a[bh];
    const T* xb = x + static_cast<size_t>(bh) * L * P;
    const T* dyb = dy + static_cast<size_t>(bh) * L * P;
    const float* dtb = dt + static_cast<size_t>(bh) * L;
    float da_acc = 0.f;  // warp 0
    __syncthreads();     // the previous head's last reads of dS are done
    for (int idx = tid; idx < nn * ldp; idx += lm::kThreads) {
      const int n = idx / ldp, p = idx % ldp;
      dS[idx] = ds_final != nullptr && n < N && p < P
                    ? ds_final[(static_cast<size_t>(bh) * N + n) * P + p]
                    : 0.f;
    }

    for (int ci = nc - 1; ci >= 0; --ci) {
      const int c0 = ci * Q;
      __syncthreads();
      for (int t = tid; t < Q; t += lm::kThreads) {
        dts[t] = dtb[c0 + t];
        dcum[t] = 0.f;
        dd[t] = 0.f;
      }
      __syncthreads();
      if (tid < 32) {  // inclusive cumsum of dt A, as the forward's
        float carry = 0.f;
        for (int t0 = 0; t0 < Q; t0 += 32) {
          const int t = t0 + lane;
          float v = t < Q ? dts[t] * av : 0.f;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float nb = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += nb;
          }
          v += carry;
          if (t < Q) cum[t] = v;
          carry = __shfl_sync(0xffffffffu, v, 31);
        }
      }
      __syncthreads();
      const float cq = cum[Q - 1];

      // ---- column tiles j: dx_j and dB_j (state update and intra-chunk
      // terms), the column sums of ddt and dcum
      for (int j0 = 0; j0 < Q; j0 += tr) {
        const int ncol = min(tr, Q - j0);
        bwd_load(Bj, ldn, bg + static_cast<size_t>(c0 + j0) * N, ncol, N, nn,
                 tr);
        bwd_load(Xj, ldp, xb + static_cast<size_t>(c0 + j0) * P, ncol, P, pp,
                 tr);
        if (tid < tr)
          wst[tid] = tid < ncol ? expf(cq - cum[j0 + tid]) * dts[j0 + tid]
                                : 0.f;
        __syncthreads();
        float ax[kMaxRt][PM], ab[kMaxRt][NM];
        bwd_zero(ax);
        bwd_zero(ab);
        // state update S' = e S + sum_j w_j B_j x_j^T: U = B_j dS, V = x_j
        // dS^T; dx_j = w_j U_j, dB_j = w_j V_j, dw_j = U_j . x_j
        lm::mm_acc_strided(ax, Bj, ldn, 1, dS, ldp, 1, nn, rt, pm, ty,
                           tx);
        lm::mm_acc_strided(ab, Xj, ldp, 1, dS, 1, ldp, pp, rt, nm, ty,
                           tx);
#pragma unroll
        for (int i = 0; i < kMaxRt; ++i) {
          if (i >= rt) break;
          const int r = ty + 16 * i;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < PM; ++j)
            if (j < pm) s = fmaf(ax[i][j], Xj[r * ldp + tx + 16 * j], s);
          s = half_warp_sum(s);
          const float w = wst[r];
          if (tx == 0 && r < ncol) {
            const int jj = j0 + r;
            dd[jj] += expf(cq - cum[jj]) * s;
            dcum[jj] -= w * s;
            wdw[jj] = w * s;
          }
#pragma unroll
          for (int j = 0; j < PM; ++j) ax[i][j] *= w;
#pragma unroll
          for (int j = 0; j < NM; ++j) ab[i][j] *= w;
        }
        // intra-chunk, row tiles from the diagonal down
        for (int i0 = j0; i0 < Q; i0 += tr) {
          const int nr = min(tr, Q - i0);
          bwd_load(Ci, ldn, cg + static_cast<size_t>(c0 + i0) * N, nr, N, nn,
                   tr);
          bwd_load(DYi, ldp, dyb + static_cast<size_t>(c0 + i0) * P, nr, P,
                   pp, tr);
          __syncthreads();
          float gm[kMaxRt][kMaxRt], dw[kMaxRt][kMaxRt];
          bwd_zero(gm);
          bwd_zero(dw);
          // C_i . B_j and dy_i . x_j
          lm::mm_acc_strided(gm, Ci, ldn, 1, Bj, 1, ldn, nn, rt, rt, ty,
                             tx);
          lm::mm_acc_strided(dw, DYi, ldp, 1, Xj, 1, ldp, pp, rt, rt, ty,
                             tx);
          float p1[kMaxRt], p2[kMaxRt];
#pragma unroll
          for (int j = 0; j < kMaxRt; ++j) p1[j] = p2[j] = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxRt; ++i)
#pragma unroll
            for (int j = 0; j < kMaxRt; ++j) {
              if (i >= rt || j >= rt) continue;
              const int r = ty + 16 * i, cc = tx + 16 * j;
              const int ii = i0 + r, jj = j0 + cc;
              // never form L for j > i: its exponent is positive
              const bool ok = r < nr && cc < ncol && jj <= ii;
              const float l = ok ? expf(cum[ii] - cum[jj]) : 0.f;
              const float d = ok ? dts[jj] : 0.f;
              const float w = gm[i][j] * l * d;
              Ws[r * ldt + cc] = w;
              dGs[r * ldt + cc] = dw[i][j] * l * d;
              p1[j] = fmaf(dw[i][j] * gm[i][j], l, p1[j]);  // dW G L
              p2[j] = fmaf(dw[i][j], w, p2[j]);             // dW W
            }
#pragma unroll
          for (int j = 0; j < kMaxRt; ++j)
            if (j < rt) {
              cs1[ty * tr + tx + 16 * j] = p1[j];
              cs2[ty * tr + tx + 16 * j] = p2[j];
            }
          __syncthreads();
          // W^T dy and dG^T C
          lm::mm_acc_strided(ax, Ws, 1, ldt, DYi, ldp, 1, tr, rt, pm, ty,
                             tx);
          lm::mm_acc_strided(ab, dGs, 1, ldt, Ci, ldn, 1, tr, rt, nm, ty,
                             tx);
          if (tid < ncol) {
            float s1 = 0.f, s2 = 0.f;
            for (int t = 0; t < 16; ++t) {
              s1 += cs1[t * tr + tid];
              s2 += cs2[t * tr + tid];
            }
            dd[j0 + tid] += s1;
            dcum[j0 + tid] -= s2;
          }
          __syncthreads();
        }
        // dx rows; dB rows into this block's partial (first head writes)
#pragma unroll
        for (int i = 0; i < kMaxRt; ++i) {
          const int r = ty + 16 * i;
          if (i >= rt || r >= ncol) continue;
          const size_t row = c0 + j0 + r;
#pragma unroll
          for (int j = 0; j < PM; ++j) {
            const int p = tx + 16 * j;
            if (j < pm && p < P)
              dx[(static_cast<size_t>(bh) * L + row) * P + p] =
                  lm::from_f32<T>(ax[i][j]);
          }
#pragma unroll
          for (int j = 0; j < NM; ++j) {
            const int n = tx + 16 * j;
            if (j < nm && n < N) {
              float* o = dbb + row * N + n;
              *o = hh ? *o + ab[i][j] : ab[i][j];
            }
          }
        }
        __syncthreads();  // B_j, x_j and w_j are reloaded next
      }

      // ---- S_c into shared memory, and <S_c, dS> for d(cum_Q)
      float dot = 0.f;
      if (ci > 0) {
        const float* sc =
            states + (static_cast<size_t>(bh) * (nc - 1) + ci - 1) * N * P;
        for (int idx = tid; idx < nn * ldp; idx += lm::kThreads) {
          const int n = idx / ldp, p = idx % ldp;
          const float v =
              n < N && p < P ? sc[static_cast<size_t>(n) * P + p] : 0.f;
          Sc[idx] = v;
          dot = fmaf(v, dS[idx], dot);
        }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) cs1[tid >> 5] = dot;
      __syncthreads();
      float extra = 0.f;  // thread 0: exp(cum_Q) <S_c, dS>
      if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < lm::kThreads / 32; ++w) s += cs1[w];
        extra = expf(cq) * s;
      }

      // ---- row tiles i: dC_i (inter- and intra-chunk terms), the row sums
      // of dcum, and the inter-chunk part of d(S_c)
      float aS[NM][PM];
      bwd_zero(aS);
      for (int i0 = 0; i0 < Q; i0 += tr) {
        const int nr = min(tr, Q - i0);
        bwd_load(Ci, ldn, cg + static_cast<size_t>(c0 + i0) * N, nr, N, nn,
                 tr);
        bwd_load(DYi, ldp, dyb + static_cast<size_t>(c0 + i0) * P, nr, P, pp,
                 tr);
        if (tid < tr) er[tid] = tid < nr ? expf(cum[i0 + tid]) : 0.f;
        __syncthreads();
        float ac[kMaxRt][NM];
        bwd_zero(ac);
        if (ci > 0) {
          // T = dy_i S_c^T; dC_i = exp(cum_i) T_i, dcum_i += exp(cum_i)
          // C_i . T_i
          lm::mm_acc_strided(ac, DYi, ldp, 1, Sc, 1, ldp, pp, rt, nm, ty,
                             tx);
#pragma unroll
          for (int i = 0; i < kMaxRt; ++i) {
            if (i >= rt) break;
            const int r = ty + 16 * i;
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < NM; ++j)
              if (j < nm) s = fmaf(ac[i][j], Ci[r * ldn + tx + 16 * j], s);
            s = half_warp_sum(s);
            if (tx == 0 && r < nr) dcum[i0 + r] += er[r] * s;
#pragma unroll
            for (int j = 0; j < NM; ++j) ac[i][j] *= er[r];
          }
        }
        // d(S_c) gains sum_i exp(cum_i) C_i^T dy_i (none for chunk 0: the
        // initial state is zero and its gradient is no output)
        if (ci > 0)
          lm::mm_acc_strided(aS, Ci, 1, ldn, DYi, ldp, 1, tr, nm, pm, ty, tx,
                             er);
        for (int j0 = 0; j0 <= i0; j0 += tr) {
          const int ncol = min(tr, Q - j0);
          __syncthreads();  // B_j and dG of the last tile are read
          bwd_load(Bj, ldn, bg + static_cast<size_t>(c0 + j0) * N, ncol, N,
                   nn, tr);
          bwd_load(Xj, ldp, xb + static_cast<size_t>(c0 + j0) * P, ncol, P,
                   pp, tr);
          __syncthreads();
          float gm[kMaxRt][kMaxRt], dw[kMaxRt][kMaxRt];
          bwd_zero(gm);
          bwd_zero(dw);
          lm::mm_acc_strided(gm, Ci, ldn, 1, Bj, 1, ldn, nn, rt, rt, ty,
                             tx);
          lm::mm_acc_strided(dw, DYi, ldp, 1, Xj, 1, ldp, pp, rt, rt, ty,
                             tx);
#pragma unroll
          for (int i = 0; i < kMaxRt; ++i) {
            if (i >= rt) break;
            const int r = ty + 16 * i, ii = i0 + r;
            float pr = 0.f;
#pragma unroll
            for (int j = 0; j < kMaxRt; ++j) {
              if (j >= rt) continue;
              const int cc = tx + 16 * j, jj = j0 + cc;
              const bool ok = r < nr && cc < ncol && jj <= ii;
              const float l = ok ? expf(cum[ii] - cum[jj]) : 0.f;
              const float d = ok ? dts[jj] : 0.f;
              dGs[r * ldt + cc] = dw[i][j] * l * d;
              pr = fmaf(dw[i][j], gm[i][j] * l * d, pr);  // dW W
            }
            pr = half_warp_sum(pr);
            if (tx == 0 && r < nr) dcum[ii] += pr;
          }
          __syncthreads();
          // dG B
          lm::mm_acc_strided(ac, dGs, ldt, 1, Bj, ldn, 1, tr, rt, nm, ty,
                             tx);
        }
        // dC rows into this block's partial (first head writes)
#pragma unroll
        for (int i = 0; i < kMaxRt; ++i) {
          const int r = ty + 16 * i;
          if (i >= rt || r >= nr) continue;
          const size_t row = c0 + i0 + r;
#pragma unroll
          for (int j = 0; j < NM; ++j) {
            const int n = tx + 16 * j;
            if (j < nm && n < N) {
              float* o = dcb + row * N + n;
              *o = hh ? *o + ac[i][j] : ac[i][j];
            }
          }
        }
        __syncthreads();  // C_i, dy_i and exp(cum_i) are reloaded next
      }

      // ---- dS <- exp(cum_Q) dS + sum_i exp(cum_i) C_i^T dy_i, for the
      // chunk before (none before chunk 0)
      const float eq = expf(cq);
#pragma unroll
      for (int i = 0; i < NM; ++i)
#pragma unroll
        for (int j = 0; j < PM; ++j)
          if (ci > 0 && i < nm && j < pm) {
            const int idx = (ty + 16 * i) * ldp + tx + 16 * j;
            dS[idx] = eq * dS[idx] + aS[i][j];
          }

      // ---- the cumsum: d(da)_k = sum_{i >= k} dcum_i; ddt_k += a d(da)_k,
      // da += sum_k dt_k d(da)_k
      if (tid < 32) {
        if (tid == 0) {  // d(cum_Q): w_j's share and exp(cum_Q)'s
          float s = 0.f;
          for (int t = 0; t < Q; ++t) s += wdw[t];
          dcum[Q - 1] += s + extra;
        }
        __syncwarp();
        float carry = 0.f, part = 0.f;
        for (int t1 = Q; t1 > 0; t1 -= 32) {
          const int t = t1 - 32 + lane;
          float v = t >= 0 ? dcum[t] : 0.f;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float nb = __shfl_down_sync(0xffffffffu, v, off);
            if (lane + off < 32) v += nb;
          }
          v += carry;
          carry = __shfl_sync(0xffffffffu, v, 0);
          if (t >= 0) {
            ddt[static_cast<size_t>(bh) * L + c0 + t] = dd[t] + av * v;
            part = fmaf(dts[t], v, part);
          }
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        da_acc += part;
      }
    }
    if (tid == 0) da[bh] = da_acc;
  }
}

template <typename T, int NM, int PM>
int launch_bwd_t(const float* a, const void* x, const float* dt,
                 const void* b, const void* c, const void* dy,
                 const float* states, const float* ds_final, void* dx,
                 float* ddt, float* da, float* db_part, float* dc_part,
                 int bh, int L, int P, int N, int Q, int rep, int hb, int tr,
                 size_t smem, cudaStream_t stream) {
  cudaError_t e = lm::allow_smem(ssd_bwd<T, NM, PM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd<T, NM, PM><<<bh / hb, lm::kThreads, smem, stream>>>(
      a, static_cast<const T*>(x), dt, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(dy), states, ds_final,
      static_cast<T*>(dx), ddt, da, db_part, dc_part, L, P, N, Q, rep, hb,
      tr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* a, const void* x, const float* dt, const void* b,
               const void* c, const void* dy, const float* states,
               const float* ds_final, void* dx, float* ddt, float* da,
               float* db_part, float* dc_part, int bh, int L, int P, int N,
               int Q, int rep, int hb, cudaStream_t stream) {
  const int nn = (N + 15) / 16 * 16, pp = (P + 15) / 16 * 16;
  // tiles of 64 rows where shared memory holds them, else of 32
  int tr = kBlk;
  size_t smem = sizeof(float) * bwd_smem_floats(nn, pp, tr, Q);
  if (smem > 227 * 1024) {
    tr = 32;
    smem = sizeof(float) * bwd_smem_floats(nn, pp, tr, Q);
  }
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
#define SSD_BWD(NM, PM)                                                     \
  launch_bwd_t<T, NM, PM>(a, x, dt, b, c, dy, states, ds_final, dx, ddt, da, \
                          db_part, dc_part, bh, L, P, N, Q, rep, hb, tr,     \
                          smem, stream)
  if (nn > 64) return pp > 64 ? SSD_BWD(8, 8) : SSD_BWD(8, 4);
  return pp > 64 ? SSD_BWD(4, 8) : SSD_BWD(4, 4);
#undef SSD_BWD
}

// ---------------------------------------------------- backward, bf16
// ssd_bwd_mma: see the header. One block of 8 warps runs `nh` heads of
// one group through the chunks from the last to the first. Warp w owns
// rows 16 (w % 4) of a 64-row tile and half w / 4 of its columns: of the
// 64 columns i of a (j, i) tile pair, or of N's 16-wide blocks.
constexpr int kBwdThreads = 256;
constexpr int kDgLd = kTile + 8;  // a row of the summed dG tile, bfloat16

// What a bfloat16 backward launch needs besides its arguments.
struct BwdGeom {
  int nh;    // heads a block (the last block of a group may have fewer)
  int sets;  // blocks a group
  int nk;    // N / 16, rounded up
  int pk;    // P / 16, rounded up
  int qp;    // Q rounded up to a tile
};

__host__ __device__ inline int bwd_ldn(const BwdGeom& g) { return 16 * g.nk + 8; }
__host__ __device__ inline int bwd_ldp(const BwdGeom& g) { return 16 * g.pk + 8; }
// a row of a head's float32 dS (N rows of P): +4 keeps the k-pair reads
// of B dS's fragments on 32 distinct banks
__host__ __device__ inline int bwd_lds(const BwdGeom& g) { return 16 * g.pk + 4; }
// a ring stage, bfloat16: C_i, then each head's dy_i
__host__ __device__ inline int bwd_stage(const BwdGeom& g) {
  return kTile * bwd_ldn(g) + g.nh * kTile * bwd_ldp(g);
}
// bytes of the region the column walk (B_j, each head's x_j, the summed
// dG tile, the other half's dx) and the row walk (each head's S_c as
// bfloat16 hi and lo) take in turn
__host__ __device__ inline int bwd_union_bytes(const BwdGeom& g) {
  const int cols = 2 * (kTile * bwd_ldn(g) + g.nh * kTile * bwd_ldp(g) +
                        kTile * kDgLd) +
                   4 * kTile * bwd_lds(g);
  const int rows = 4 * g.nh * 16 * g.nk * bwd_ldp(g);
  return cols > rows ? cols : rows;
}
// floats a head: cum, dcum and w_j dw_j over the chunk; the column sums
// of four row blocks; the row sums of two halves, three quantities; the
// dot's eight warp partials and its sum
__host__ __device__ inline int bwd_small_floats(const BwdGeom& g) {
  return g.nh * (3 * g.qp + 4 * kTile + 6 * kTile + 9);
}
size_t bwd_mma_smem(const BwdGeom& g) {
  return sizeof(float) * g.nh * 16 * g.nk * bwd_lds(g)  // dS, float32
         + sizeof(bf16) * 2 * bwd_stage(g)               // the ring
         + bwd_union_bytes(g) + sizeof(float) * bwd_small_floats(g);
}

// Two floats as bfloat16 pairs hi + lo: hi their rounding, lo the
// rounding of what hi leaves (together about 16 bits of each value).
__device__ __forceinline__ void split_bf16x2(float v0, float v1,
                                             uint32_t& hi, uint32_t& lo) {
  hi = lm::pack_bf16x2(v0, v1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = lm::pack_bf16x2(v0 - h.x, v1 - h.y);
}

// The sum over the four lanes of a row of an mma fragment (t = lane % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// The sum over the eight rows g = lane / 4 of a fragment's column.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The 16 x 16 A fragment at (m0, k0) of a row-major [m][ld] tile.
__device__ __forceinline__ void frag_a(uint32_t (&af)[4], const bf16* t,
                                       int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  lm::ldmatrix_x4(af, lm::smem_u32(t + (m0 + (lane & 15)) * ld + k0 +
                                   (lane >> 4) * 8));
}
// The same from a [k][ld] tile (the A matrix transposed in memory).
__device__ __forceinline__ void frag_a_t(uint32_t (&af)[4], const bf16* t,
                                         int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  lm::ldmatrix_x4_trans(
      af, lm::smem_u32(t + (k0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ld +
                       m0 + ((lane >> 3) & 1) * 8));
}
// acc[0], acc[1] (columns n0 .. n0 + 16) += a * B, B (k0 .. k0 + 16 by
// n) read from an [n][ld] tile (k along a row)
__device__ __forceinline__ void mma_nk(float (&a0)[4], float (&a1)[4],
                                       const uint32_t (&af)[4],
                                       const bf16* t, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t bb[4];
  lm::ldmatrix_x4(bb, lm::smem_u32(t + (n0 + (lane >> 4) * 8 + (lane & 7)) *
                                           ld +
                                   k0 + ((lane >> 3) & 1) * 8));
  lm::mma_bf16_16816(a0, af, bb[0], bb[1]);
  lm::mma_bf16_16816(a1, af, bb[2], bb[3]);
}
// the same with B read from a [k][ld] tile (n along a row)
__device__ __forceinline__ void mma_kn(float (&a0)[4], float (&a1)[4],
                                       const uint32_t (&af)[4],
                                       const bf16* t, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t bb[4];
  lm::ldmatrix_x4_trans(
      bb, lm::smem_u32(t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                       n0 + (lane >> 4) * 8));
  lm::mma_bf16_16816(a0, af, bb[0], bb[1]);
  lm::mma_bf16_16816(a1, af, bb[2], bb[3]);
}

// rows row0 + g (+ 8) and columns n0 + 2 t (+ 1) of an n8 block of
// an mma fragment, v, into a float32 (., N) matrix at dst (rows < rows)
__device__ __forceinline__ void put_rows(float* dst, const float (&v)[4],
                                         int row0, int n0, int rows, int N) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + (lane >> 2) + 8 * hh;
    if (row >= rows || n >= N) continue;
    float* o = dst + static_cast<size_t>(row) * N + n;
    if (N % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(v[2 * hh], v[2 * hh + 1]);
    } else {
      o[0] = v[2 * hh];
      if (n + 1 < N) o[1] = v[2 * hh + 1];
    }
  }
}
// the same block read from src into v (zeros at rows >= rows, n >= N)
__device__ __forceinline__ void get_rows(const float* src, float (&v)[4],
                                         int row0, int n0, int rows, int N) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + (lane >> 2) + 8 * hh;
    v[2 * hh] = v[2 * hh + 1] = 0.f;
    if (row >= rows || n >= N) continue;
    const float* o = src + static_cast<size_t>(row) * N + n;
    if (N % 2 == 0) {
      const float2 u = *reinterpret_cast<const float2*>(o);
      v[2 * hh] = u.x;
      v[2 * hh + 1] = u.y;
    } else {
      v[2 * hh] = o[0];
      if (n + 1 < N) v[2 * hh + 1] = o[1];
    }
  }
}

// NKH: N's 16-wide blocks in half of N at most (2 or 4); PKM: P's (4 or
// 8); HM: heads a block at most (2 or 1: each head's dx_j sums stay in
// registers over the column walk)
template <int NKH, int PKM, int HM>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_mma(const float* __restrict__ a, const bf16* __restrict__ x,
                const float* __restrict__ dt, const bf16* __restrict__ b,
                const bf16* __restrict__ c, const bf16* __restrict__ dy,
                const float* __restrict__ states,
                const float* __restrict__ ds_final, bf16* __restrict__ dx,
                float* __restrict__ ddt, float* __restrict__ da,
                float* __restrict__ db_part, float* __restrict__ dc_part,
                int L, int P, int N, int Q, int rep, BwdGeom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = bwd_ldn(g), ldp = bwd_ldp(g), lds = bwd_lds(g);
  const int nn = 16 * g.nk, pp = 16 * g.pk, nc = L / Q, qp = g.qp;
  const int stage = bwd_stage(g);
  float* dS = reinterpret_cast<float*>(smem_raw);              // [nh][nn][lds]
  bf16* ring = reinterpret_cast<bf16*>(dS + g.nh * nn * lds);  // [2][stage]
  unsigned char* uni = reinterpret_cast<unsigned char*>(ring + 2 * stage);
  bf16* Bj = reinterpret_cast<bf16*>(uni);                  // [64][ldn]
  bf16* Xj = Bj + kTile * ldn;                              // [nh][64][ldp]
  bf16* Dg = Xj + g.nh * kTile * ldp;                       // [64][kDgLd]
  float* dxo = reinterpret_cast<float*>(Dg + kTile * kDgLd);  // [64][lds]
  bf16* Sc = reinterpret_cast<bf16*>(uni);  // [nh][2 (hi, lo)][nn][ldp]
  float* cum = reinterpret_cast<float*>(uni + bwd_union_bytes(g));  // [nh][qp]
  float* dcum = cum + g.nh * qp;                            // [nh][qp]
  float* wdw = dcum + g.nh * qp;                            // [nh][qp]
  float* colsum = wdw + g.nh * qp;                          // [nh][4][64]
  float* rowsum = colsum + g.nh * 4 * kTile;                // [nh][2][3][64]
  float* red = rowsum + g.nh * 6 * kTile;                   // [nh][8]
  float* dotv = red + g.nh * 8;                             // [nh]

  const int gb = blockIdx.x / g.sets, set = blockIdx.x % g.sets;
  const int nh = min(g.nh, rep - set * g.nh);
  const int bh0 = gb * rep + set * g.nh;  // the block's first head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = warp & 3, hc = warp >> 2;  // rows 16 r, half hc
  const int gq = lane >> 2, t4 = lane & 3;
  // this half's 16-wide blocks of N: [nb0, nb0 + nbn)
  const int nkh = (g.nk + 1) / 2, nb0 = hc * nkh;
  const int nbn = max(0, min(g.nk, nb0 + nkh) - nb0);
  const bf16* bg = b + static_cast<size_t>(gb) * L * N;
  const bf16* cg = c + static_cast<size_t>(gb) * L * N;
  float* dbb = db_part + static_cast<size_t>(blockIdx.x) * L * N;
  float* dcb = dc_part + static_cast<size_t>(blockIdx.x) * L * N;

  for (int h = 0; h < nh; ++h) {
    const float* src = ds_final + static_cast<size_t>(bh0 + h) * N * P;
#pragma unroll 8
    for (int idx = tid; idx < nn * pp; idx += kBwdThreads) {
      const int n = idx / pp, p = idx % pp;
      dS[(h * nn + n) * lds + p] =
          ds_final != nullptr && n < N && p < P ? src[n * P + p] : 0.f;
    }
  }
  float da_acc = 0.f;  // warp h's head h

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * Q;
    // a ring stage: C_i and the heads' dy_i for rows [i0, i0 + 64)
    auto load_stage = [&](int s, int i0) {
      bf16* st = ring + s * stage;
      load_tile(st, ldn, cg + static_cast<size_t>(c0 + i0) * N, N, g.nk,
                Q - i0, tid, kBwdThreads);
      for (int h = 0; h < nh; ++h)
        load_tile(st + kTile * ldn + h * kTile * ldp, ldp,
                  dy + (static_cast<size_t>(bh0 + h) * L + c0 + i0) * P, P,
                  g.pk, Q - i0, tid, kBwdThreads);
    };
    __syncthreads();  // the last chunk's epilogue has read cum and dcum
    // ---- log2 e times the cumsum of dt a, a warp a head
    if (warp < nh) {
      const int h = warp;
      const float av = a[bh0 + h];
      const float* dth = dt + static_cast<size_t>(bh0 + h) * L + c0;
      float carry = 0.f;
#pragma unroll 4
      for (int t0 = 0; t0 < qp; t0 += 32) {
        const int t = t0 + lane;
        float v = t < Q ? dth[t] * av : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float nb = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += nb;
        }
        v += carry;
        cum[h * qp + t] = t < Q ? v * kLog2e : 0.f;
        dcum[h * qp + t] = 0.f;
        wdw[h * qp + t] = 0.f;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    // B_j, the heads' x_j and the first pair's stage of column tile j0
    auto load_cols = [&](int j0) {
      const int nj = min(kTile, Q - j0);
      load_tile(Bj, ldn, bg + static_cast<size_t>(c0 + j0) * N, N, g.nk, nj,
                tid, kBwdThreads);
      for (int h = 0; h < nh; ++h)
        load_tile(Xj + h * kTile * ldp, ldp,
                  x + (static_cast<size_t>(bh0 + h) * L + c0 + j0) * P, P,
                  g.pk, nj, tid, kBwdThreads);
      load_stage(0, j0);
      lm::cp_async_commit();
    };
    load_cols(0);
    __syncthreads();

    // ---- column tiles j: dx_j, dB_j and the pairs (j, i >= j)
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      // this thread's rows j (jlo, jlo + 8): cum (log2), dt
      const int jlo = j0 + 16 * r + gq;
      float cj[HM][2], dtj[HM][2];
      // row sums over i: ddt_j (dW G L), dcum_j (- dW W)
      float rs[HM][2][2];
      float dxa[HM][2 * PKM][4];
      float dba[2 * NKH][4];
#pragma unroll
      for (int h = 0; h < HM; ++h)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jj = jlo + 8 * hh;
          const bool ok = h < nh && jj < Q;
          cj[h][hh] = ok ? cum[h * qp + jj] : 0.f;
          dtj[h][hh] =
              ok ? dt[static_cast<size_t>(bh0 + h) * L + c0 + jj] : 0.f;
          rs[h][0][hh] = rs[h][1][hh] = 0.f;
        }
#pragma unroll
      for (int f = 0; f < 2 * NKH; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) dba[f][e] = 0.f;
      lm::cp_async_wait<0>();
      __syncthreads();

      // the state terms: U = B_j dS (this half's share of K = N), dx_j =
      // w_j U, dw_j = U . x_j; dB_j = sum over heads of w_j x_j dS^T
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        if (h >= nh) break;
        const float* dSh = dS + h * nn * lds;
        const bf16* Xh = Xj + h * kTile * ldp;
        float w[2], ej[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const bool ok = jlo + 8 * hh < Q;
          ej[hh] = ok ? exp2f(cum[h * qp + Q - 1] - cj[h][hh]) : 0.f;
          w[hh] = ej[hh] * dtj[h][hh];
        }
#pragma unroll
        for (int f = 0; f < 2 * PKM; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[h][f][e] = 0.f;
        for (int kb = 0; kb < nbn; ++kb) {
          const int k0 = 16 * (nb0 + kb);
          uint32_t af[4];
          frag_a(af, Bj, ldn, 16 * r, k0);
          const float* s0 = dSh + (k0 + 2 * t4) * lds + gq;
#pragma unroll
          for (int f = 0; f < 2 * PKM; ++f) {
            if (f >= 2 * g.pk) break;
            const float* s = s0 + 8 * f;
            uint32_t b0, b1, l0, l1;  // dS as hi + lo: dw_j feeds ddt, da
            split_bf16x2(s[0], s[lds], b0, l0);
            split_bf16x2(s[8 * lds], s[9 * lds], b1, l1);
            lm::mma_bf16_16816(dxa[h][f], af, b0, b1);
            lm::mma_bf16_16816(dxa[h][f], af, l0, l1);
          }
        }
        float dwp[2] = {0.f, 0.f};
#pragma unroll
        for (int f = 0; f < 2 * PKM; ++f) {
          if (f >= 2 * g.pk) break;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    Xh + (16 * r + gq + 8 * hh) * ldp + 8 * f + 2 * t4));
            dwp[hh] = fmaf(dxa[h][f][2 * hh], xv.x, dwp[hh]);
            dwp[hh] = fmaf(dxa[h][f][2 * hh + 1], xv.y, dwp[hh]);
          }
        }
        // this lane's share of the row dot (the quads are summed at the
        // tile's end); w_j dw_j is final now, into its row sum slot
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[h][0][hh] = ej[hh] * dwp[hh];
          rs[h][1][hh] = -w[hh] * dwp[hh];
          const float v = quad_sum(w[hh] * dwp[hh]);
          if (t4 == 0)
            rowsum[((h * 2 + hc) * 3 + 2) * kTile + 16 * r + gq + 8 * hh] = v;
        }
#pragma unroll
        for (int f = 0; f < 2 * PKM; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[h][f][e] *= w[e >> 1];
        // V = x_j dS^T over this half's columns n, times w_j, into dB_j
        float va[2 * NKH][4];
#pragma unroll
        for (int f = 0; f < 2 * NKH; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) va[f][e] = 0.f;
        for (int kk = 0; kk < g.pk; ++kk) {
          uint32_t af[4];
          frag_a(af, Xh, ldp, 16 * r, 16 * kk);
#pragma unroll
          for (int nb = 0; nb < NKH; ++nb) {
            if (nb >= nbn) break;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float* s =
                  dSh + (16 * (nb0 + nb) + 8 * half + gq) * lds + 16 * kk +
                  2 * t4;
              const float2 v0 = *reinterpret_cast<const float2*>(s);
              const float2 v1 = *reinterpret_cast<const float2*>(s + 8);
              lm::mma_bf16_16816(va[2 * nb + half], af,
                                 lm::pack_bf16x2(v0.x, v0.y),
                                 lm::pack_bf16x2(v1.x, v1.y));
            }
          }
        }
#pragma unroll
        for (int f = 0; f < 2 * NKH; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dba[f][e] = fmaf(w[e >> 1], va[f][e], dba[f][e]);
      }

      // ---- the pairs (j, i), i from the diagonal down, C_i and dy_i in
      // a double-buffered ring. A pair's leading barrier is the last
      // one's end: the next stage is loaded after it (the stage it
      // overwrites was read by the pair before), and the Dg tile and the
      // column sums are written after it.
      const int npair = (Q - j0 + kTile - 1) / kTile;
      for (int k = 0; k < npair; ++k) {
        const int i0 = j0 + k * kTile, s = k & 1;
        lm::cp_async_wait<0>();
        __syncthreads();
        if (k + 1 < npair) load_stage(s ^ 1, i0 + kTile);
        lm::cp_async_commit();
        const bf16* Ci = ring + s * stage;
        const bf16* Dyi = Ci + kTile * ldn;
        // G^T = B_j C_i^T: rows j, this half's 32 columns i; once for
        // every head of the block
        float gt[4][4], dgs[4][4];
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) gt[f][e] = dgs[f][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2 * NKH; ++kk) {
          if (kk >= g.nk) break;
          uint32_t af[4];
          frag_a(af, Bj, ldn, 16 * r, 16 * kk);
          mma_nk(gt[0], gt[1], af, Ci, ldn, 32 * hc, 16 * kk);
          mma_nk(gt[2], gt[3], af, Ci, ldn, 32 * hc + 16, 16 * kk);
        }
#pragma unroll
        for (int h = 0; h < HM; ++h) {
          if (h >= nh) break;
          const bf16* Dyh = Dyi + h * kTile * ldp;
          // dW^T = x_j dy_i^T
          float dw[4][4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) dw[f][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < PKM; ++kk) {
            if (kk >= g.pk) break;
            uint32_t af[4];
            frag_a(af, Xj + h * kTile * ldp, ldp, 16 * r, 16 * kk);
            mma_nk(dw[0], dw[1], af, Dyh, ldp, 32 * hc, 16 * kk);
            mma_nk(dw[2], dw[3], af, Dyh, ldp, 32 * hc + 16, 16 * kk);
          }
          // L = exp(cum_i - cum_j) (i >= j only), W = G L dt_j (to
          // bfloat16 as W^T dy's A fragments), dG = dW L dt_j (summed
          // over the heads), and the row and column sums
          const float* ch = cum + h * qp;
          uint32_t wa[2][4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int ib = i0 + 32 * hc + 8 * f + 2 * t4;
            const float2 ci2 = *reinterpret_cast<const float2*>(ch + ib);
            float wv[4], cs[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1, ii = ib + (e & 1);
              const bool ok = ii < Q && ii >= jlo + 8 * hh;
              const float l =
                  ok ? exp2f((e & 1 ? ci2.y : ci2.x) - cj[h][hh]) : 0.f;
              const float gl = gt[f][e] * l, d = dw[f][e];
              wv[e] = gl * dtj[h][hh];
              dgs[f][e] = fmaf(d * l, dtj[h][hh], dgs[f][e]);
              rs[h][0][hh] = fmaf(d, gl, rs[h][0][hh]);
              const float ww = d * wv[e];
              rs[h][1][hh] -= ww;
              cs[e & 1] += ww;
            }
            wa[f >> 1][2 * (f & 1)] = lm::pack_bf16x2(wv[0], wv[1]);
            wa[f >> 1][2 * (f & 1) + 1] = lm::pack_bf16x2(wv[2], wv[3]);
            // dcum_i: the column sums over the warp's 16 rows
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const float v = col_sum(cs[e1]);
              if (gq == 0)
                colsum[(h * 4 + r) * kTile + 32 * hc + 8 * f + 2 * t4 + e1] =
                    v;
            }
          }
          // dx_j += W^T dy_i over this half's 32 rows i
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            mma_rows<PKM>(dxa[h], wa[kk], Dyh + 32 * hc * ldp, ldp, kk,
                          g.pk);
        }
        // the heads' summed dG, rounded once, into Dg [j][i]
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(
                Dg + (16 * r + gq + 8 * hh) * kDgLd + 32 * hc + 8 * f +
                2 * t4) = lm::pack_bf16x2(dgs[f][2 * hh], dgs[f][2 * hh + 1]);
        __syncthreads();
        if (tid < nh * kTile) {
          const int h = tid / kTile, col = tid % kTile, ii = i0 + col;
          const float* cs = colsum + h * 4 * kTile + col;
          if (ii < Q)
            dcum[h * qp + ii] +=
                ((cs[0] + cs[kTile]) + cs[2 * kTile]) + cs[3 * kTile];
        }
        // dC_i's sums so far (none at the first column tile), loaded
        // under dB's products
        float dca[2 * NKH][4];
#pragma unroll
        for (int f = 0; f < 2 * NKH; ++f)
          get_rows(dcb + static_cast<size_t>(c0) * N, dca[f], i0 + 16 * r,
                   16 * nb0 + 8 * f, f < 2 * nbn && j0 > 0 ? Q : 0, N);
        // dB_j += dG^T C_i (rows j, this half's n; K = i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4];
          frag_a(af, Dg, kDgLd, 16 * r, 16 * kk);
#pragma unroll
          for (int nb = 0; nb < NKH; ++nb) {
            if (nb >= nbn) break;
            mma_kn(dba[2 * nb], dba[2 * nb + 1], af, Ci, ldn,
                   16 * (nb0 + nb), 16 * kk);
          }
        }
        // dC_i (rows i, this half's n) += dG B_j (K = j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4];
          frag_a_t(af, Dg, kDgLd, 16 * r, 16 * kk);
#pragma unroll
          for (int nb = 0; nb < NKH; ++nb) {
            if (nb >= nbn) break;
            mma_kn(dca[2 * nb], dca[2 * nb + 1], af, Bj, ldn,
                   16 * (nb0 + nb), 16 * kk);
          }
        }
#pragma unroll
        for (int f = 0; f < 2 * NKH; ++f)
          if (f < 2 * nbn)
            put_rows(dcb + static_cast<size_t>(c0) * N, dca[f],
                     i0 + 16 * r, 16 * nb0 + 8 * f, Q, N);
      }
      __syncthreads();  // the last pair has read B_j and the ring
      // the next tile's loads run under this one's results
      if (j0 + kTile < Q) load_cols(j0 + kTile);

      // ---- the column tile's results: row sums (two halves), dB_j, dx_j
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        if (h >= nh) break;
#pragma unroll
        for (int qn = 0; qn < 2; ++qn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v = quad_sum(rs[h][qn][hh]);
            if (t4 == 0)
              rowsum[((h * 2 + hc) * 3 + qn) * kTile + 16 * r + gq + 8 * hh] =
                  v;
          }
      }
#pragma unroll
      for (int f = 0; f < 2 * NKH; ++f)
        if (f < 2 * nbn)
          put_rows(dbb + static_cast<size_t>(c0) * N, dba[f], j0 + 16 * r,
                   16 * nb0 + 8 * f, Q, N);
#pragma unroll
      for (int h = 0; h < HM; ++h) {
        if (h >= nh) break;
        if (hc == 1) {
#pragma unroll
          for (int f = 0; f < 2 * PKM; ++f) {
            if (f >= 2 * g.pk) break;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(
                  dxo + (16 * r + gq + 8 * hh) * lds + 8 * f + 2 * t4) =
                  make_float2(dxa[h][f][2 * hh], dxa[h][f][2 * hh + 1]);
          }
        }
        __syncthreads();
        if (hc == 0) {
          bf16* dxh = dx + (static_cast<size_t>(bh0 + h) * L + c0) * P;
#pragma unroll
          for (int f = 0; f < 2 * PKM; ++f) {
            if (f >= 2 * g.pk) break;
            const int p = 8 * f + 2 * t4;
            if (p >= P) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = 16 * r + gq + 8 * hh, jj = j0 + row;
              if (jj >= Q) continue;
              const float2 o =
                  *reinterpret_cast<const float2*>(dxo + row * lds + p);
              const float v0 = dxa[h][f][2 * hh] + o.x;
              const float v1 = dxa[h][f][2 * hh + 1] + o.y;
              bf16* dst = dxh + static_cast<size_t>(jj) * P + p;
              if (P % 2 == 0) {
                *reinterpret_cast<uint32_t*>(dst) = lm::pack_bf16x2(v0, v1);
              } else {
                dst[0] = __float2bfloat16_rn(v0);
                if (p + 1 < P) dst[1] = __float2bfloat16_rn(v1);
              }
            }
          }
        }
        if (h == 0 && tid < nh * kTile) {
          // ddt_j's share but the cumsum's (final: its rows are done),
          // dcum_j, w_j dw_j
          const int hr = tid / kTile, row = tid % kTile, jj = j0 + row;
          const float* rsh = rowsum + hr * 6 * kTile + row;
          if (jj < Q) {
            ddt[static_cast<size_t>(bh0 + hr) * L + c0 + jj] =
                rsh[0] + rsh[3 * kTile];
            dcum[hr * qp + jj] += rsh[kTile] + rsh[4 * kTile];
            wdw[hr * qp + jj] = rsh[2 * kTile] + rsh[5 * kTile];
          }
        }
        __syncthreads();  // dxo and rowsum are rewritten next
      }
    }

    // ---- the row walk (not at chunk 0: its entry state is zero): dC_i
    // += exp(cum_i) dy_i S_c^T, dcum_i += exp(cum_i) C_i . (dy_i S_c^T),
    // and dS <- exp(cum_Q) dS + sum_i (exp(cum_i) C_i)^T dy_i
    if (ci > 0) {
      for (int h = 0; h < nh; ++h) {
        const float* sch =
            states + (static_cast<size_t>(bh0 + h) * (nc - 1) + ci - 1) * N * P;
        const float eq = exp2f(cum[h * qp + Q - 1]);
        bf16* Sh = Sc + 2 * h * nn * ldp;
        float* dSh = dS + h * nn * lds;
        float part = 0.f;
#pragma unroll 8
        for (int idx = tid; idx < nn * pp; idx += kBwdThreads) {
          const int n = idx / pp, p = idx % pp;
          const float v = n < N && p < P ? sch[static_cast<size_t>(n) * P + p]
                                         : 0.f;
          const bf16 hi = __float2bfloat16_rn(v);
          Sh[n * ldp + p] = hi;
          Sh[(nn + n) * ldp + p] = __float2bfloat16_rn(v - __bfloat162float(hi));
          float* d = dSh + n * lds + p;
          part = fmaf(v, *d, part);
          *d *= eq;
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) red[h * 8 + warp] = part;
      }
      load_stage(0, 0);
      lm::cp_async_commit();
      __syncthreads();
      if (tid < nh) {
        float s = 0.f;
        for (int w = 0; w < 8; ++w) s += red[tid * 8 + w];
        dotv[tid] = s;  // <S_c, dS>, read by the epilogue
      }
      const int nt = (Q + kTile - 1) / kTile, pu = (g.pk + 1) / 2;
      for (int k = 0; k < nt; ++k) {
        const int i0 = k * kTile, s = k & 1;
        lm::cp_async_wait<0>();
        __syncthreads();  // as the column walk's pairs
        if (k + 1 < nt) load_stage(s ^ 1, i0 + kTile);
        lm::cp_async_commit();
        const bf16* Ci = ring + s * stage;
        const bf16* Dyi = Ci + kTile * ldn;
        float dca[2 * NKH][4];  // dC_i's sums so far
#pragma unroll
        for (int f = 0; f < 2 * NKH; ++f)
          get_rows(dcb + static_cast<size_t>(c0) * N, dca[f], i0 + 16 * r,
                   16 * nb0 + 8 * f, f < 2 * nbn ? Q : 0, N);
#pragma unroll
        for (int h = 0; h < HM; ++h) {
          if (h >= nh) break;
          const bf16* Dyh = Dyi + h * kTile * ldp;
          const bf16* Sh = Sc + 2 * h * nn * ldp;  // hi, then lo
          float tt[2 * NKH][4];
#pragma unroll
          for (int f = 0; f < 2 * NKH; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) tt[f][e] = 0.f;
          for (int kk = 0; kk < g.pk; ++kk) {
            uint32_t af[4];
            frag_a(af, Dyh, ldp, 16 * r, 16 * kk);
#pragma unroll
            for (int nb = 0; nb < NKH; ++nb) {
              if (nb >= nbn) break;
              mma_nk(tt[2 * nb], tt[2 * nb + 1], af, Sh, ldp,
                     16 * (nb0 + nb), 16 * kk);
              mma_nk(tt[2 * nb], tt[2 * nb + 1], af, Sh + nn * ldp, ldp,
                     16 * (nb0 + nb), 16 * kk);
            }
          }
          float ei[2], rd[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ii = i0 + 16 * r + gq + 8 * hh;
            ei[hh] = ii < Q ? exp2f(cum[h * qp + ii]) : 0.f;
          }
#pragma unroll
          for (int f = 0; f < 2 * NKH; ++f) {
            if (f >= 2 * nbn) break;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 cv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      Ci + (16 * r + gq + 8 * hh) * ldn + 16 * nb0 + 8 * f +
                      2 * t4));
              rd[hh] = fmaf(cv.x, tt[f][2 * hh], rd[hh]);
              rd[hh] = fmaf(cv.y, tt[f][2 * hh + 1], rd[hh]);
              dca[f][2 * hh] = fmaf(ei[hh], tt[f][2 * hh], dca[f][2 * hh]);
              dca[f][2 * hh + 1] =
                  fmaf(ei[hh], tt[f][2 * hh + 1], dca[f][2 * hh + 1]);
            }
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float v = quad_sum(rd[hh]);
            if (t4 == 0)
              rowsum[(h * 2 + hc) * 3 * kTile + 16 * r + gq + 8 * hh] =
                  ei[hh] * v;
          }
        }
#pragma unroll
        for (int f = 0; f < 2 * NKH; ++f)
          if (f < 2 * nbn)
            put_rows(dcb + static_cast<size_t>(c0) * N, dca[f], i0 + 16 * r,
                     16 * nb0 + 8 * f, Q, N);
        // dS += (exp(cum_i) C_i)^T dy_i: units of 16 rows n by 32
        // columns p, a warp a unit
        for (int u = warp; u < g.nk * pu; u += kBwdThreads / 32) {
          const int nu = u / pu, pv = u % pu;
          const int nq = min(2, g.pk - 2 * pv);  // 16-wide blocks of p
          for (int h = 0; h < nh; ++h) {
            float* dSh = dS + h * nn * lds;
            const float* ch = cum + h * qp;
            float sa[4][4];
#pragma unroll
            for (int f = 0; f < 4; ++f)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float2 v = make_float2(0.f, 0.f);
                if (f < 2 * nq)
                  v = *reinterpret_cast<const float2*>(
                      dSh + (16 * nu + gq + 8 * hh) * lds + 32 * pv + 8 * f +
                      2 * t4);
                sa[f][2 * hh] = v.x;
                sa[f][2 * hh + 1] = v.y;
              }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              uint32_t af[4];
              frag_a_t(af, Ci, ldn, 16 * nu, 16 * kk);
              float ek[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int ii = i0 + 16 * kk + 2 * t4 + (e & 1) + (e >> 1) * 8;
                ek[e] = ii < Q ? exp2f(ch[ii]) : 0.f;
              }
              uint32_t al[4];  // exp(cum_i) C_i as hi + lo: dS feeds
                               // the chunk before's ddt, da
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 v = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&af[q]));
                const int hi = q >> 1;  // a2, a3: k + 8
                split_bf16x2(v.x * ek[2 * hi], v.y * ek[2 * hi + 1], af[q],
                             al[q]);
              }
              const bf16* Dyh = Dyi + h * kTile * ldp;
              mma_kn(sa[0], sa[1], af, Dyh, ldp, 32 * pv, 16 * kk);
              mma_kn(sa[0], sa[1], al, Dyh, ldp, 32 * pv, 16 * kk);
              if (nq > 1) {
                mma_kn(sa[2], sa[3], af, Dyh, ldp, 32 * pv + 16, 16 * kk);
                mma_kn(sa[2], sa[3], al, Dyh, ldp, 32 * pv + 16, 16 * kk);
              }
            }
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              if (f >= 2 * nq) break;
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<float2*>(
                    dSh + (16 * nu + gq + 8 * hh) * lds + 32 * pv + 8 * f +
                    2 * t4) = make_float2(sa[f][2 * hh], sa[f][2 * hh + 1]);
            }
          }
        }
        __syncthreads();
        if (tid < nh * kTile) {
          const int h = tid / kTile, row = tid % kTile, ii = i0 + row;
          const float* rsh = rowsum + h * 6 * kTile + row;
          if (ii < Q) dcum[h * qp + ii] += rsh[0] + rsh[3 * kTile];
        }
      }
    }

    // ---- the cumsum: d(cum_Q) gains sum_j w_j dw_j and exp(cum_Q) <S_c,
    // dS>; d(da)_k = sum_{i >= k} dcum_i; ddt_k += a d(da)_k, da +=
    // sum_k dt_k d(da)_k
    __syncthreads();
    if (warp < nh) {
      const int h = warp, bh = bh0 + h;
      const float av = a[bh];
      float* dch = dcum + h * qp;
      float s = 0.f;
      for (int t = lane; t < Q; t += 32) s += wdw[h * qp + t];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0)
        dch[Q - 1] += s + (ci > 0 ? exp2f(cum[h * qp + Q - 1]) * dotv[h] : 0.f);
      __syncwarp();
      float carry = 0.f, part = 0.f;
#pragma unroll 4
      for (int t1 = Q; t1 > 0; t1 -= 32) {
        const int t = t1 - 32 + lane;
        float v = t >= 0 ? dch[t] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float nb = __shfl_down_sync(0xffffffffu, v, off);
          if (lane + off < 32) v += nb;
        }
        v += carry;
        carry = __shfl_sync(0xffffffffu, v, 0);
        if (t >= 0) {
          float* o = ddt + static_cast<size_t>(bh) * L + c0 + t;
          *o += av * v;
          part = fmaf(dt[static_cast<size_t>(bh) * L + c0 + t], v, part);
        }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      da_acc += part;
    }
  }
  if (warp < nh && lane == 0) da[bh0 + warp] = da_acc;
}

// The bfloat16 backward's geometry for `hb` heads a block (sets =
// ceil(rep / hb) blocks a group, as the forward's); nh = 0 where the
// kernel takes no such launch (P past 64 with two heads, or shared memory).
BwdGeom bwd_geom(int P, int N, int Q, int rep, int hb) {
  BwdGeom g{};
  g.nk = (N + 15) / 16;
  g.pk = (P + 15) / 16;
  g.qp = (Q + kTile - 1) / kTile * kTile;
  if (hb < 1 || hb > rep) return g;
  g.sets = (rep + hb - 1) / hb;
  g.nh = (rep + g.sets - 1) / g.sets;
  if (g.nh > (g.pk > 4 ? 1 : 2) || bwd_mma_smem(g) > 227 * 1024) g.nh = 0;
  return g;
}

// the build for (P, N): P past 64 keeps one head's dx_j in registers
using BwdMmaKernel = decltype(&ssd_bwd_mma<2, 4, 2>);
BwdMmaKernel bwd_mma_kernel(int P, int N) {
  if (P > 64) return N > 64 ? ssd_bwd_mma<4, 8, 1> : ssd_bwd_mma<2, 8, 1>;
  return N > 64 ? ssd_bwd_mma<4, 4, 2> : ssd_bwd_mma<2, 4, 2>;
}

int launch_bwd_mma(const float* a, const void* x, const float* dt,
                   const void* b, const void* c, const void* dy,
                   const float* states, const float* ds_final, void* dx,
                   float* ddt, float* da, float* db_part, float* dc_part,
                   int bh, int L, int P, int N, int Q, int rep, int hb,
                   cudaStream_t stream) {
  const BwdGeom g = bwd_geom(P, N, Q, rep, hb);
  if (g.nh == 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdMmaKernel kern = bwd_mma_kernel(P, N);
  const size_t smem = bwd_mma_smem(g);
  cudaError_t e = lm::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<bh / rep * g.sets, kBwdThreads, smem, stream>>>(
      a, static_cast<const bf16*>(x), dt, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const bf16*>(dy), states,
      ds_final, static_cast<bf16*>(dx), ddt, da, db_part, dc_part, L, P, N,
      Q, rep, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (bh,) float32; x (bh, L, P); dt (bh, L) float32; b, c (bh / rep, L, N);
// y (bh, L, P); s_final (bh, N, P) float32; x, b, c, y all float32
// (is_bf16 = 0) or all bfloat16; states null, or (bh, L / Q - 1, N, P)
// float32 for the state before each chunk but the first. Needs L % Q == 0,
// bh % rep == 0, 1 <= P, N <= 128; in bfloat16 also P and N multiples of
// 8, x, b and c 16-byte aligned, and Q within shared memory
// (fwd_wgmma_smem).
extern "C" int ssd_scan_launch(int is_bf16, const void* a, const void* x,
                               const void* dt, const void* b, const void* c,
                               void* y, void* s_final, void* states, int bh,
                               int L, int P, int N, int Q, int rep,
                               void* stream) {
  if (bh < 1 || L < 1 || Q < 1 || L % Q || rep < 1 || bh % rep || P < 1 ||
      P > 128 || N < 1 || N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dtf = static_cast<const float*>(dt);
  float* sf = static_cast<float*>(s_final);
  float* st = static_cast<float*>(states);
  if (is_bf16)
    return N > 64 ? launch_fwd_wgmma<2>(af, x, dtf, b, c, y, sf, st, bh, L,
                                         P, N, Q, rep, s)
                  : launch_fwd_wgmma<1>(af, x, dtf, b, c, y, sf, st, bh, L,
                                         P, N, Q, rep, s);
  return launch<float>(af, x, dtf, b, c, y, sf, st, bh, L, P, N, Q, rep, s);
}

// The backward of ssd_scan_launch at the same a, x, dt, b, c (and Q, rep):
// dy (bh, L, P) in x's type; states (bh, L / Q - 1, N, P) float32 from the
// forward (null when L == Q); ds_final (bh, N, P) float32 or null (zero).
// Writes dx (bh, L, P) in x's type, ddt (bh, L) and da (bh,) float32, and
// dB, dC as float32 partial sums (bh / rep * sets, L, N), one a block of
// hb heads: float32, hb divides rep and sets = rep / hb; bfloat16, 1 <= hb
// <= rep and sets = ceil(rep / hb) (the last block of a group may run
// fewer). The caller sums each group's `sets` partials.
extern "C" int ssd_scan_bwd_launch(int is_bf16, const void* a, const void* x,
                                   const void* dt, const void* b,
                                   const void* c, const void* dy,
                                   const void* states, const void* ds_final,
                                   void* dx, void* ddt, void* da,
                                   void* db_part, void* dc_part, int bh,
                                   int L, int P, int N, int Q, int rep,
                                   int hb, void* stream) {
  if (bh < 1 || L < 1 || Q < 1 || L % Q || rep < 1 || bh % rep || P < 1 ||
      P > 128 || N < 1 || N > 128 || hb < 1 || hb > rep ||
      (!is_bf16 && rep % hb) || (L > Q && states == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dtf = static_cast<const float*>(dt);
  const float* st = static_cast<const float*>(states);
  const float* dsf = static_cast<const float*>(ds_final);
  float* ddtf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(da);
  float* dbp = static_cast<float*>(db_part);
  float* dcp = static_cast<float*>(dc_part);
  if (is_bf16)
    return launch_bwd_mma(af, x, dtf, b, c, dy, st, dsf, dx, ddtf, daf, dbp,
                          dcp, bh, L, P, N, Q, rep, hb, s);
  return launch_bwd<float>(af, x, dtf, b, c, dy, st, dsf, dx, ddtf, daf, dbp,
                           dcp, bh, L, P, N, Q, rep, hb, s);
}

// The bfloat16 backward's launch at (P, N, Q, rep, hb), into out[0..5]:
// shared memory bytes, resident blocks an SM, registers a thread, local
// (spilled) bytes a thread, heads a block, blocks a group. Launches
// nothing; cudaErrorInvalidValue where the kernel takes no such launch.
extern "C" int ssd_scan_bwd_mma_info(int P, int N, int Q, int rep, int hb,
                                     void* out) {
  const BwdGeom g = bwd_geom(P, N, Q, rep, hb);
  if (P < 1 || P > 128 || N < 1 || N > 128 || Q < 1 || g.nh == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdMmaKernel kern = bwd_mma_kernel(P, N);
  const size_t smem = bwd_mma_smem(g);
  cudaError_t e = lm::allow_smem(kern, smem);
  cudaFuncAttributes at{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, kern);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      kBwdThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* o = static_cast<int*>(out);
  o[0] = static_cast<int>(smem);
  o[1] = blocks;
  o[2] = at.numRegs;
  o[3] = static_cast<int>(at.localSizeBytes);
  o[4] = g.nh;
  o[5] = g.sets;
  return 0;
}
