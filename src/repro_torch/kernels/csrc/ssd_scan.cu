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
// Backward (ssd_bwd_wgmma for bfloat16, ssd_bwd for float32). It replaces
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
// dB and dC are summed over a group's heads (the gradient of the
// reference's jnp.repeat of B and C) without float atomics, and every sum
// runs in a fixed order, so two launches give the same bits. The
// inter-chunk products are skipped at chunk 0 (its state is zero and the
// initial state's gradient is no output).
//
// bfloat16 (ssd_bwd_wgmma<NB, PB, HB>, the training path's): Hopper's
// wgmma and TMA, no mma.sync. A block of two warpgroups (256 threads) runs
// HB <= 2 heads of one group, warpgroup h head h (P past 64: one head,
// each warpgroup one 64-column box of P for dx, the state terms and C
// S_c; warpgroup 0 forms W and dG and writes W^T to shared memory for
// warpgroup 1's box); ceil(rep / HB) blocks a group, the last with the
// rest. Tiles of 64 rows in 64-column boxes with the 128-byte swizzle
// come by TMA through 3-D head maps that zero-fill
// past L and the row width: B_j and the heads' x_j for a column tile, and
// a ring of two slots for the rest, thread 0 requesting each after the
// block barrier that frees it. Per chunk:
//   - each head's cumsum, times log2 e (every exponential an ex2);
//   - the column walk, per 64-row tile j: u = B_j dS (wgmma, dS's hi and
//     lo bfloat16 copies as transposed B) into the dx_j accumulator, dw_j
//     = u . x_j, dx_j = w_j u; then per tile pair (j, i >= j), C_i and the
//     heads' dy_i in the ring: G^T = B_j C_i^T ONCE for the block's heads
//     (warpgroup 0, to shared memory as float32), per head dW^T = x_j
//     dy_i^T, then in float32 registers L, W, dG and the row (over i,
//     into shared rows a pair) and column (over j; four warps in order)
//     sums, a k16 step at a time, each step's W packed to bfloat16 as the
//     A fragments of dx_j += W^T dy_i at once; the block's heads' dG
//     summed in float32 (head 0, then head 1), rounded ONCE to a bfloat16
//     [j][i] tile, copied to the chunk's scratch (dg_buf) for the group
//     passes;
//   - the dB pass, per 64-row tile j, warpgroup c owning N's box c: the
//     heads' state terms K-stacked into one accumulator (rb(w_j x_j)
//     rb(dS)^T, A from registers), then dG_ij^T C_i over i >= j (the
//     scratch's tile K-major), the tile's float32 sum over the block's
//     heads out through a staging tile in 16-byte stores;
//   - the row walk (chunks > 0), two passes over the 64-row tiles i (so
//     V and the dS sums never share registers): V = C_i S_c (S_c's hi and
//     lo copies) into dcum_i += exp(cum_i) dy_i . V; then the chunk
//     before's dS = exp(cum_Q) dS + (exp(cum_i) C_i)^T dy_i (A from
//     registers: ldmatrix.trans of C_i's tile, times exp(cum_i), hi + lo;
//     float32 in registers, out through shared memory to ds_buf and the
//     hi and lo copies);
//   - the cumsum's backward, a warp a head (fixed order);
//   - the dC pass, per 64-row tile i as the dB pass: rb(exp(cum_i) dy_i)
//     rb(S_c)^T (chunks > 0), then dG_ij B_j over j <= i (the tile as a
//     transposed A).
// A block writes its tiles of dB and dC (its heads' sums) once: bfloat16
// where the block holds the group's heads, else float32 into its partial,
// which a second kernel (ssd_bwd_sum_parts) sums over a group's blocks in
// order and rounds (the partials stay in device memory: summing a tile over
// a cluster of a group's blocks through distributed shared memory instead
// measured slower at every cluster size, the blocks held in lockstep; and a
// tile's sum by the block that writes its last partial, counted by an
// integer atomic, took twice the time: the late block stays the last, and
// its sums run one after another). The roundings the plain version lacks,
// each at most one bfloat16 step of its value: W for W^T dy; the block's
// summed dG for dG B and dG^T C; w_j x_j and dS for dB's state term;
// exp(cum_i) dy_i and S_c for dC's. The products that reach ddt and da,
// float32 outputs held to the float32 tolerance, take their float32 operand
// as two bfloat16 terms hi + lo (about 2^-16 of its value): dS for B dS, S_c
// for C S_c, exp(cum_i) C_i for (exp(cum_i) C_i)^T dy. The
// wrapper zero-pads x, dy, B and C to a multiple of 8 columns (TMA's
// 16-byte row strides) and slices dx, dB and dC back; P, N <= 128; Q up to
// what shared memory holds (bwd_wgmma_smem: 4,544 at P 64, N 128; 6,592
// at P = N = 64; 1,024 at P = N = 128), two heads a block up to 768 at P
// 64, N 128. Registers: 251-255 a thread in the six builds, no spill
// (ptxas's serialising of wgmma beside divergent code is avoided by a
// warp-uniform warpgroup index, a shuffle; cold values a phase derives
// are recomputed from an empty asm's copy, opaque(), not held).
//
// What bounds it. At Mamba2-1.3B's training shape (BH 512, L 512, P 64,
// N 128, Q 256, rep 64; chip_smoke.py::ssd_bwd_bound) the least work is
// 2.2e10 operations (C B^T, dG B and dG^T C once a group, not a head;
// 0.0222 ms at the bfloat16 peak) against 140 MB of traffic (0.0419 ms
// at 3.35 TB/s): bytes bound it. At Zamba2-7B's (BH 896, N 64, rep 112)
// 0.0631 ms, bytes (operations 0.0269). This design forms the group's
// products once a block of two heads, on whole 64 x 64 tiles, and runs
// the split operands' second products; it reads C, B, x and dy again in
// its passes (from L2), and writes and reads the summed dG tiles (20 MB
// at Mamba2's shape) and the blocks' partials of dB and dC (134 MB at
// Mamba2's, 117 MB at Zamba2's).
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
// ssd_bwd_wgmma<NB, PB>: see the header. N in NB and P in PB 64-column
// boxes (1: up to 64, 2: up to 128). A block of two warpgroups runs `nh`
// (at most hmax <= 2) heads of one group, warpgroup h head h's chains;
// the group's products, formed once for the block, are split between
// the warpgroups.
constexpr int kBwdThreads = 256;
constexpr uint32_t kF32Tile = kTile * kTile * 4;  // 64 x 64 float32

// Byte offsets from a block's 1,024-aligned base, hmax heads: each head's
// dS as bfloat16 hi (all heads), then lo ([P box][N rows][64 values of
// P], the 128-byte swizzle TMA writes); a region the column walk (B_j,
// the heads' x_j, G^T and the dG exchange as float32) and the group
// passes (each head's S_c hi, then lo; the float32 staging of a dB or dC
// tile over the lo copies) take in turn; the ring's two slots.
struct BwdLayout {
  uint32_t state;  // one head's dS or S_c, hi or lo
  uint32_t bj, xh, gt, dgx, sc, stage, ring, slot, tiles;
};
__host__ __device__ constexpr BwdLayout bwd_layout(int nb, int pb, int hmax) {
  BwdLayout s{};
  s.state = nb * pb * kBoxBytes;
  const uint32_t u = 2 * hmax * s.state;
  s.bj = u;
  s.xh = s.bj + nb * kBoxBytes;
  s.gt = s.xh + hmax * pb * kBoxBytes;
  s.dgx = s.gt + kF32Tile;
  s.sc = u;
  const uint32_t his = s.sc + hmax * s.state;
  s.stage = s.gt > his ? s.gt : his;  // 64 x 64 nb float32
  uint32_t end = s.dgx + kF32Tile;
  if (s.sc + 2 * hmax * s.state > end) end = s.sc + 2 * hmax * s.state;
  if (s.stage + nb * kF32Tile > end) end = s.stage + nb * kF32Tile;
  s.ring = end;
  // a slot: C_i and the heads' dy_i; the heads' x_j or dy_i; C_i or B_j
  // and a summed dG tile
  const uint32_t cdy = (nb + hmax * pb) * kBoxBytes, gdg = (nb + 1) * kBoxBytes;
  s.slot = cdy > gdg ? cdy : gdg;
  s.tiles = s.ring + 2 * s.slot;
  return s;
}
// The whole: alignment, the tiles, then float32 rows of the chunk (per
// head log2 e times the cumsum and dt; per row of the sums, one a head or
// two for a split head, d(cum), w_j dw_j and ddt but the cumsum's share),
// per head the column sums of four warps, the dot's eight warp partials
// and da over the chunks (two floats), and three mbarriers.
size_t bwd_wgmma_smem(int nb, int pb, int hmax, int q) {
  const size_t qp = (q + kTile - 1) / kTile * kTile;
  const int hr = pb == 2 ? 2 : hmax;
  return 1024 + bwd_layout(nb, pb, hmax).tiles +
         4 * ((2 * hmax + 3 * hr) * qp + 266 * static_cast<size_t>(hmax)) +
         3 * 8;
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
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// The sum over the four lanes of an accumulator row (t = lane % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// The sum over the eight rows g = lane / 4 of an accumulator column.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
// byte offset of (row r, column c) in a swizzled tile of 64-column boxes
// `box` bytes apart
__device__ __forceinline__ uint32_t swz(int r, int c, uint32_t box) {
  return (c >> 6) * box + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}
// v through an empty asm: what derives from the copy cannot be hoisted
// above it, so a phase inside the chunk loop recomputes its own values
// instead of the compiler holding them (in registers) through the others
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}
template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

template <int NB, int PB, int HB>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_wgmma(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_dy,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c,
                  const float* __restrict__ a, const float* __restrict__ dt,
                  const float* __restrict__ states,
                  const float* __restrict__ ds_final,
                  float* __restrict__ ds_buf, bf16* __restrict__ dg_buf,
                  bf16* __restrict__ dx, float* __restrict__ ddt,
                  float* __restrict__ da, float* __restrict__ part,
                  bf16* __restrict__ out, int L, int P, int N, int Pr,
                  int Nr, int Q, int rep, int sets) {
  // P past one box (PB 2, one head a block): both warpgroups run the
  // block's head, warpgroup c the dx, state and V products of P's box c,
  // each with its own row of the per-row sums; else warpgroup c runs head c
  constexpr bool kSplit = PB == 2;
  static_assert(!kSplit || HB == 1, "P past 64 takes one head a block");
  constexpr int HR = kSplit ? 2 : HB;      // rows of the per-row sums
  constexpr int KN = 4 * NB, KP = 4 * PB;  // k-steps of 16 over N, P
  constexpr BwdLayout lay = bwd_layout(NB, PB, HB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = lm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sb = smem_raw + (base - raw);
  auto at = [&](uint32_t addr) { return sb + (addr - base); };
  const int qp = (Q + kTile - 1) / kTile * kTile, nt = qp / kTile;
  float* cum = reinterpret_cast<float*>(sb + lay.tiles);  // [HB][qp]
  float* dts = cum + HB * qp;                             // [HB][qp]
  float* dcum = dts + HB * qp;                            // [HR][qp]
  float* wdw = dcum + HR * qp;                            // [HR][qp]
  float* dd = wdw + HR * qp;  // [HR][qp] ddt but the cumsum's share
  float* colsum = dd + HR * qp;                           // [HB][4][64]
  float* red = colsum + HB * 4 * kTile;                   // [HB][8]
  float* dacc = red + 8 * HB;  // [HB][2] each head's da over the chunks
  const uint32_t bar_bx = lm::smem_u32(red + 10 * HB);
  const uint32_t bar_ring = bar_bx + 8;  // [2]

  const int gb = blockIdx.x / sets, set = blockIdx.x % sets;
  const int nh = min(HB, rep - set * HB);
  const int bh0 = gb * rep + set * HB;
  const int nc = L / Q, npairs = nt * (nt + 1) / 2;
  const int tid = threadIdx.x, tw = tid % 128;
  // warp-uniform to the compiler (a shuffle), so the warpgroups' branches
  // around wgmma are not divergent paths
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = tw / 32, lane = tid % 32, g4 = lane >> 2, t4 = lane & 3;
  const int jr = 16 * warp + g4;  // this thread's rows of a tile: jr, jr + 8
  const bool mine = kSplit || wg < nh;  // this warpgroup runs a head
  const int h = kSplit ? 0 : wg, bh = bh0 + h;
  const int ps = kSplit ? wg : 0;   // the P box of its dx, state and V
  const int hr = kSplit ? wg : h;   // its row of the per-row sums
  // the intra-chunk sums, the same in both warpgroups of a split head: one
  // warpgroup's count
  const bool sums = !kSplit || wg == 0;
  const uint32_t hi = lm::desc_hi_sw128(1024);
  auto ds_hi = [&](int k) { return base + k * lay.state; };
  auto ds_lo = [&](int k) { return base + (HB + k) * lay.state; };
  auto sc_hi = [&](int k) { return base + lay.sc + k * lay.state; };
  auto sc_lo = [&](int k) { return base + lay.sc + (HB + k) * lay.state; };
  auto slot_at = [&](int r) { return base + lay.ring + (r & 1) * lay.slot; };
  auto fence_async = [] {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // ---- the loads, all requested by thread 0, each after the block
  // barrier that frees its buffer. Column tile j's B_j and the heads' x_j
  // on bar_bx; ring step r in slot r % 2 (phase r / 2 of its barrier).
  // (thread 0's own copies of the block's group, first head and heads,
  // and of the maps' addresses: nothing of them held by the others)
  auto producer = [&](int& gq, int& bq, int& nq) {
    const int blk = opaque(static_cast<int>(blockIdx.x));
    gq = blk / sets;
    bq = gq * rep + blk % sets * HB;
    nq = min(HB, rep - blk % sets * HB);
  };
  auto request_bx = [&](int c0, int j) {
    int gq, bq, nq;
    producer(gq, bq, nq);
    fence_async();
    lm::mbar_expect_tx(bar_bx, (NB + nq * PB) * kBoxBytes);
    for (int b = 0; b < NB; ++b)
      lm::tma_load_3d(base + lay.bj + b * kBoxBytes, opaque(&map_b), bar_bx,
                      b * kTile, c0 + j * kTile, gq);
    for (int k = 0; k < nq; ++k)
      for (int p = 0; p < PB; ++p)
        lm::tma_load_3d(base + lay.xh + (k * PB + p) * kBoxBytes,
                        opaque(&map_x), bar_bx, p * kTile, c0 + j * kTile,
                        bq + k);
  };
  // ring step r: the 64-row tiles named (>= 0), each into the slot's next
  // boxes in this order: C's, the heads' dy, the heads' x, B's
  auto request_ring = [&](int r, int c0, int c_t, int dy_t, int x_t,
                          int b_t) {
    int gq, bq, nq;
    producer(gq, bq, nq);
    const uint32_t slot = slot_at(r), bar = bar_ring + 8 * (r & 1);
    const int boxes = (c_t >= 0 ? NB : 0) + (dy_t >= 0 ? nq * PB : 0) +
                      (x_t >= 0 ? nq * PB : 0) + (b_t >= 0 ? NB : 0);
    fence_async();
    lm::mbar_expect_tx(bar, boxes * kBoxBytes);
    uint32_t at_box = slot;
    if (c_t >= 0)
      for (int b = 0; b < NB; ++b, at_box += kBoxBytes)
        lm::tma_load_3d(at_box, opaque(&map_c), bar, b * kTile,
                        c0 + c_t * kTile, gq);
    if (dy_t >= 0)
      for (int k = 0; k < nq; ++k)
        for (int p = 0; p < PB; ++p, at_box += kBoxBytes)
          lm::tma_load_3d(at_box, opaque(&map_dy), bar, p * kTile,
                          c0 + dy_t * kTile, bq + k);
    if (x_t >= 0)
      for (int k = 0; k < nq; ++k)
        for (int p = 0; p < PB; ++p, at_box += kBoxBytes)
          lm::tma_load_3d(at_box, opaque(&map_x), bar, p * kTile,
                          c0 + x_t * kTile, bq + k);
    if (b_t >= 0)
      for (int b = 0; b < NB; ++b, at_box += kBoxBytes)
        lm::tma_load_3d(at_box, opaque(&map_b), bar, b * kTile,
                        c0 + b_t * kTile, gq);
  };
  int rk = 0, nbx = 0;  // ring steps and column tiles consumed
  auto ring_wait = [&]() {
    lm::mbar_wait(bar_ring + 8 * (rk & 1), (rk >> 1) & 1);
    return slot_at(rk);
  };

  // a float32 (N, P) state (true widths; null reads as zero) into
  // bfloat16 hi and lo copies, by all threads; returns this thread's share
  // of its dot with `other` (same shape, null: zero)
  auto load_state = [&](uint32_t to_hi, uint32_t to_lo, const float* src,
                        const float* other) {
    float dot = 0.f;
    for (int idx = tid; idx < NB * kTile * PB * 32; idx += kBwdThreads) {
      const int n = idx / (PB * 32), p = idx % (PB * 32) * 2;
      float v0 = 0.f, v1 = 0.f;
      if (src != nullptr && n < N) {
        const size_t o = static_cast<size_t>(n) * P + p;
        if (p < P) v0 = src[o];
        if (p + 1 < P) v1 = src[o + 1];
        if (other != nullptr) {
          if (p < P) dot = fmaf(v0, other[o], dot);
          if (p + 1 < P) dot = fmaf(v1, other[o + 1], dot);
        }
      }
      uint32_t h2, l2;
      split_bf16x2(v0, v1, h2, l2);
      const uint32_t off = swz(n, p, NB * kBoxBytes);
      *reinterpret_cast<uint32_t*>(at(to_hi + off)) = h2;
      *reinterpret_cast<uint32_t*>(at(to_lo + off)) = l2;
    }
    return dot;
  };

  // A finished 64-row tile of dB (which 0) or dC (1), rows c0 + r0.. of
  // the group, the block's sum over its heads: each warpgroup that holds
  // n-slices of it stages them (float32, [64][64 NB]), then the block
  // writes it in 16-byte stores: bfloat16 where the block holds all the
  // group's heads, else float32 into the block's partial, which
  // ssd_bwd_sum_parts sums over the group's blocks in order.
  auto stage = [&](int nb, const float (&v)[32]) {
    float* st = reinterpret_cast<float*>(at(base + lay.stage));
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(st + (jr + 8 * hh) * (kTile * NB) +
                                   kTile * nb + 8 * nn + 2 * t4) =
            make_float2(v[4 * nn + 2 * hh], v[4 * nn + 2 * hh + 1]);
  };
  auto emit = [&](int which, int c0, int r0) {
    __syncthreads();
    constexpr int w4 = kTile * NB / 4;  // float4 a row
    const int blk = opaque(static_cast<int>(blockIdx.x));
    const int grp = blk / sets, groups = gridDim.x / sets;
    const float4* st = reinterpret_cast<const float4*>(at(base + lay.stage));
    for (int e = tid; e < kTile * w4; e += kBwdThreads) {
      const int r = e / w4, col = e % w4 * 4, row = r0 + r;
      if (row >= Q || col >= Nr) continue;
      const float4 s = st[e];
      const size_t at_row = static_cast<size_t>(c0 + row) * Nr + col;
      if (sets == 1) {
        bf16* o = out + (static_cast<size_t>(which) * groups + grp) * L * Nr +
                  at_row;
        *reinterpret_cast<uint2*>(o) =
            make_uint2(lm::pack_bf16x2(s.x, s.y), lm::pack_bf16x2(s.z, s.w));
      } else {
        float* o = part + (static_cast<size_t>(which) * gridDim.x + blk) * L *
                              Nr + at_row;
        *reinterpret_cast<float4*>(o) = s;
      }
    }
    __syncthreads();
  };

  if (tid == 0) {
    lm::mbar_init(bar_bx, 1);
    lm::mbar_init(bar_ring, 1);
    lm::mbar_init(bar_ring + 8, 1);
    lm::mbar_fence_init();
  }
  // dS of the last chunk: d(s_final), or zero
  for (int k = 0; k < nh; ++k)
    load_state(ds_hi(k), ds_lo(k),
               ds_final != nullptr
                   ? ds_final + static_cast<size_t>(bh0 + k) * N * P
                   : nullptr,
               nullptr);
  fence_async();
  if (tid < HB) dacc[2 * tid] = 0.f;

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int c0 = ci * Q;
    __syncthreads();  // the last chunk's reads are done
    // ---- log2 e times the cumsum of dt a, a warp a head
    if (tid < 32 * nh) {
      const int k = tid / 32;
      const float av = a[bh0 + k];
      const float* dth = dt + static_cast<size_t>(bh0 + k) * L + c0;
      float carry = 0.f;
      for (int t0 = 0; t0 < qp; t0 += 32) {
        const int t = t0 + lane;
        const float d = t < Q ? dth[t] : 0.f;
        float v = d * av;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float nb = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += nb;
        }
        v += carry;
        cum[k * qp + t] = t < Q ? v * kLog2e : 0.f;
        dts[k * qp + t] = d;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    for (int t = tid; t < HR * qp; t += kBwdThreads) dcum[t] = wdw[t] = 0.f;
    __syncthreads();
    const float* cu = cum + h * qp;  // read only where `mine`
    const float cq = mine ? cu[Q - 1] : 0.f;

    // ---- the column walk: per 64-row tile j, the state terms, then the
    // pairs (j, i >= j)
    for (int j = 0; j < nt; ++j) {
      const int j0 = j * kTile, npair = nt - j;
      if (tid == 0) {
        request_bx(c0, j);
        for (int k = 0; k < min(2, npair); ++k)
          request_ring(rk + k, c0, j + k, j + k, -1, -1);
      }
      float dxa[32];  // dx_j, this warpgroup's box of P
      lm::mbar_wait(bar_bx, nbx & 1);
      ++nbx;
      const uint32_t bj_lo = lm::desc_lo(base + lay.bj, 16);
      const uint32_t xh = base + lay.xh + h * PB * kBoxBytes;
      if (mine) {
        float wj[2], ej[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jj = j0 + jr + 8 * hh;
          const bool ok = jj < Q;
          ej[hh] = ok ? ex2(cq - cu[jj]) : 0.f;
          wj[hh] = ok ? ej[hh] * dts[h * qp + jj] : 0.f;
        }
        // u = B_j dS (dS as hi + lo: dw_j feeds ddt and da) into dx_j
        zero(dxa);
        lm::fence_regs(dxa);
        lm::wgmma_fence();
        const uint32_t sh =
            lm::desc_lo(ds_hi(h) + ps * NB * kBoxBytes, kBoxBytes);
        const uint32_t sl =
            lm::desc_lo(ds_lo(h) + ps * NB * kBoxBytes, kBoxBytes);
        static_for<KN>([&](auto s) {
          constexpr int kk = decltype(s)::value;
          lm::wgmma_m64n64k16_ss_tb<(kk / 4 * kBoxBytes + kk % 4 * 32) / 16,
                                    kk * 2048 / 16>(dxa, bj_lo, sh, hi,
                                                    kk > 0);
        });
        static_for<KN>([&](auto s) {
          constexpr int kk = decltype(s)::value;
          lm::wgmma_m64n64k16_ss_tb<(kk / 4 * kBoxBytes + kk % 4 * 32) / 16,
                                    kk * 2048 / 16>(dxa, bj_lo, sl, hi, 1);
        });
        lm::wgmma_commit();
        lm::wgmma_wait<0>();
        lm::fence_regs(dxa);
        // dw_j = u_j . x_j (this lane's share of this warpgroup's box;
        // its quad's sum for w_j dw_j); the row sums' state shares; dx_j =
        // w_j u_j
        float dwp[2] = {0.f, 0.f};
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 xv = bf2(*reinterpret_cast<const uint32_t*>(at(
                xh + swz(jr + 8 * hh, 64 * ps + 8 * nn + 2 * t4,
                         kBoxBytes))));
            dwp[hh] = fmaf(dxa[4 * nn + 2 * hh], xv.x, dwp[hh]);
            dwp[hh] = fmaf(dxa[4 * nn + 2 * hh + 1], xv.y, dwp[hh]);
          }
        // this warpgroup's row of the sums: ddt_j's state share (the
        // first write of the tile's rows), dcum_j's, w_j dw_j
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int jj = j0 + jr + 8 * hh;
          const float dw = quad_sum(dwp[hh]);
          if (t4 == 0 && jj < Q) {
            dd[hr * qp + jj] = ej[hh] * dw;
            dcum[hr * qp + jj] -= wj[hh] * dw;
            wdw[hr * qp + jj] = wj[hh] * dw;
          }
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) dxa[e] *= wj[(e >> 1) & 1];
      }

      // the pairs (j, i), i from the diagonal down, C_i and the heads'
      // dy_i in the ring
      for (int k = 0; k < npair; ++k, ++rk) {
        const int i = j + k, i0 = i * kTile;
        const uint32_t slot = ring_wait();
        const uint32_t dy_t = slot + (NB + h * PB) * kBoxBytes;
        float dw[32];       // dW^T, then dG
        uint32_t pa[1][4];  // W^T in bfloat16: a k16 step's A fragments
        float4* gts = reinterpret_cast<float4*>(at(base + lay.gt));
        float4* dgx = reinterpret_cast<float4*>(at(base + lay.dgx));
        if (mine) {
          lm::fence_regs(dw);
          lm::wgmma_fence();
          if (wg == 0) {  // G^T = B_j C_i^T, once for the block
            float gt[32];
            lm::fence_regs(gt);
            const uint32_t c_lo = lm::desc_lo(slot, 16);
            static_for<KN>([&](auto s) {
              constexpr int kk = decltype(s)::value;
              constexpr int off = (kk / 4 * kBoxBytes + kk % 4 * 32) / 16;
              lm::wgmma_m64n64k16_ss<off, off>(gt, bj_lo, c_lo, hi, kk > 0);
            });
            lm::wgmma_commit();
            lm::wgmma_wait<0>();
            lm::fence_regs(gt);
#pragma unroll
            for (int n = 0; n < 8; ++n)
              gts[n * 128 + tw] = make_float4(gt[4 * n], gt[4 * n + 1],
                                              gt[4 * n + 2], gt[4 * n + 3]);
            lm::wgmma_fence();
          }
          if (sums) {  // dW^T = x_j dy_i^T
            const uint32_t x_lo = lm::desc_lo(xh, 16);
            const uint32_t d_lo = lm::desc_lo(dy_t, 16);
            static_for<KP>([&](auto s) {
              constexpr int kk = decltype(s)::value;
              constexpr int off = (kk / 4 * kBoxBytes + kk % 4 * 32) / 16;
              lm::wgmma_m64n64k16_ss<off, off>(dw, x_lo, d_lo, hi, kk > 0);
            });
            lm::wgmma_commit();
            lm::wgmma_wait<0>();
            lm::fence_regs(dw);
          }
        }
        __syncthreads();  // G^T in shared memory
        // W (and dG, the sums) where a warpgroup runs a head, or by
        // warpgroup 0 alone for a split head, which also writes W^T to the
        // exchange's tile for warpgroup 1's box of dx
        if (mine && sums) {
          // L = 2^(cum_i - cum_j) (i >= j only, both in the chunk), W = G
          // L dt_j, dG = dW L dt_j, the row sums over i (ddt_j: dW G L;
          // dcum_j: - dW W) and the column sums over j (dcum_i: dW W); G^T
          // four values at a time. A k16 step (two n8 tiles) at a time: its
          // W rounded to bfloat16 as W^T's A fragments goes to dx_j += W^T
          // dy_i at once, the next step's W computed while it runs; the
          // pair's row sums then added to the rows' shared ones
          float cj[2], dtj[2], rs_ddt[2] = {0.f, 0.f}, rs_dcum[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int jj = j0 + jr + 8 * hh;
            cj[hh] = jj < Q ? cu[jj] : 0.f;
            dtj[hh] = jj < Q ? dts[h * qp + jj] : 0.f;
          }
          const uint32_t db = lm::desc_lo(dy_t + ps * kBoxBytes, kBoxBytes);
          static_for<4>([&](auto s) {
            constexpr int kk = decltype(s)::value;
            float wv[8];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int nn = 2 * kk + h2;
              const int ib = i0 + 8 * nn + 2 * t4;
              const float2 ci2 = *reinterpret_cast<const float2*>(cu + ib);
              const float4 g = gts[nn * 128 + tw];
              const float gv[4] = {g.x, g.y, g.z, g.w};
              float cs2[2] = {0.f, 0.f};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int hh = e >> 1, ii = ib + (e & 1);
                const bool ok = ii < Q && j0 + jr + 8 * hh <= ii;
                const float l =
                    ok ? ex2((e & 1 ? ci2.y : ci2.x) - cj[hh]) : 0.f;
                const float gl = gv[e] * l, d = dw[4 * nn + e];
                const float w = gl * dtj[hh], ww = d * w;
                wv[4 * h2 + e] = w;
                rs_ddt[hh] = fmaf(d, gl, rs_ddt[hh]);
                rs_dcum[hh] -= ww;
                cs2[e & 1] += ww;
                dw[4 * nn + e] = d * l * dtj[hh];
              }
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1) {
                const float v = col_sum(cs2[e1]);
                if (g4 == 0)
                  colsum[(h * 4 + warp) * kTile + 8 * nn + 2 * t4 + e1] = v;
              }
              if (kSplit) {  // W^T's [j][i] tile in bfloat16
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                  *reinterpret_cast<uint32_t*>(
                      at(base + lay.dgx +
                         swz(jr + 8 * hh, 8 * nn + 2 * t4, kBoxBytes))) =
                      lm::pack_bf16x2(wv[4 * h2 + 2 * hh],
                                      wv[4 * h2 + 2 * hh + 1]);
              }
            }
            if (kk > 0) {  // the previous step has read its fragments
              lm::wgmma_wait<0>();
              lm::fence_regs(pa);
            }
            lm::fence_regs(dxa);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              pa[0][q] = lm::pack_bf16x2(wv[2 * q], wv[2 * q + 1]);
            lm::fence_regs(pa);
            lm::wgmma_fence();
            lm::wgmma_m64n64k16_rs_tb<kk * 2048 / 16>(dxa, pa[0], db, hi);
            lm::wgmma_commit();
          });
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float s1 = quad_sum(rs_ddt[hh]), s2 = quad_sum(rs_dcum[hh]);
            const int jj = j0 + jr + 8 * hh;
            if (t4 == 0 && jj < Q) {
              dd[hr * qp + jj] += s1;
              dcum[hr * qp + jj] += s2;
            }
          }
          if (!kSplit && wg == 1) {  // head 1's dG to the exchange
#pragma unroll
            for (int n = 0; n < 8; ++n)
              dgx[n * 128 + tw] = make_float4(dw[4 * n], dw[4 * n + 1],
                                              dw[4 * n + 2], dw[4 * n + 3]);
          }
          if (kSplit) fence_async();  // W^T's writes before wgmma's reads
        }
        __syncthreads();  // the column sums, the exchange, a split W^T
        if (kSplit && wg == 1) {
          // dx_j += W^T dy_i over box 1 of P, W^T K-major from shared memory
          lm::fence_regs(dxa);
          lm::wgmma_fence();
          const uint32_t w_lo = lm::desc_lo(base + lay.dgx, 16);
          const uint32_t db = lm::desc_lo(dy_t + kBoxBytes, kBoxBytes);
          static_for<4>([&](auto s) {
            constexpr int kk = decltype(s)::value;
            lm::wgmma_m64n64k16_ss_tb<kk * 32 / 16, kk * 2048 / 16>(
                dxa, w_lo, db, hi, 1);
          });
          lm::wgmma_commit();
        }
        if (tid < nh * kTile) {  // dcum_i: the four warps' sums in order
          const int k2 = tid / kTile, col = tid % kTile, ii = i0 + col;
          const float* cs4 = colsum + k2 * 4 * kTile + col;
          if (ii < Q)
            dcum[k2 * qp + ii] += ((cs4[0] + cs4[kTile]) + cs4[2 * kTile]) +
                                  cs4[3 * kTile];
        }
        if (wg == 0) {
          // the block's heads' dG summed in float32 (head 0, then head 1),
          // rounded once into dG^T's [j][i] tile (the 128-byte swizzle the
          // group passes' wgmma read) over G^T's, then copied out to the
          // chunk's copy in 16-byte stores
          if (nh > 1) {
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const float4 v = dgx[n * 128 + tw];
              dw[4 * n] += v.x;
              dw[4 * n + 1] += v.y;
              dw[4 * n + 2] += v.z;
              dw[4 * n + 3] += v.w;
            }
          }
          unsigned char* dgs = at(base + lay.gt);
#pragma unroll
          for (int nn = 0; nn < 8; ++nn)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<uint32_t*>(
                  dgs + swz(jr + 8 * hh, 8 * nn + 2 * t4, kBoxBytes)) =
                  lm::pack_bf16x2(dw[4 * nn + 2 * hh],
                                  dw[4 * nn + 2 * hh + 1]);
          lm::bar_sync(1, 128);  // warpgroup 0's writes
          uint4* dst = reinterpret_cast<uint4*>(
              dg_buf + (static_cast<size_t>(blockIdx.x) * npairs +
                        i * (i + 1) / 2 + j) * kTile * kTile);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[tw + 128 * q] =
                reinterpret_cast<const uint4*>(dgs)[tw + 128 * q];
        }
        if (mine) {
          lm::wgmma_wait<0>();
          lm::fence_regs(dxa);
          lm::fence_regs(pa);
        }
        __syncthreads();  // the slot, G^T and the exchange are free
        if (tid == 0 && k + 2 < npair)
          request_ring(rk + 2, c0, i + 2, i + 2, -1, -1);
      }

      // dx_j (this warpgroup's box of P)
      if (mine) {
        bf16* dxh = dx + (static_cast<size_t>(bh) * L + c0) * Pr;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int p = 64 * ps + 8 * nn + 2 * t4;  // Pr % 8 == 0
          if (p >= Pr) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int jj = j0 + jr + 8 * hh;
            if (jj < Q)
              *reinterpret_cast<uint32_t*>(dxh + static_cast<size_t>(jj) * Pr +
                                           p) =
                  lm::pack_bf16x2(dxa[4 * nn + 2 * hh],
                                  dxa[4 * nn + 2 * hh + 1]);
          }
        }
      }
      __syncthreads();  // B_j and the heads' x_j are free
    }

    // ---- a group pass, dB (kC false) or dC (true): per 64-row tile t of
    // the chunk, float32 over the block's heads, warpgroup c owning N's
    // box c. First the state terms summed over the heads, K-stacked with
    // A from registers (dB_j: rb(w_j x_j) rb(dS)^T; dC_i, chunks > 0:
    // rb(2^cum_i dy_i) rb(S_c)^T, the hi copies K-major), then the summed
    // dG's products from the column walk's copies (dB_j += dG_ij^T C_i
    // over i >= j, dG^T's tile K-major; dC_i += dG_ij B_j over j <= i, the
    // tile as a transposed A), then the block's partial (emit). A pair's dG
    // tile reaches its slot through this thread's registers a step ahead.
    uint4 dgr[2];
    auto group_pass = [&](auto is_c) {
      constexpr bool kC = decltype(is_c)::value;
      const int extra = (!kC || ci > 0) ? 1 : 0;
      const int tq = opaque(tid), lq = tq % 32, wq = tq / 32 % 4;
      const int jq = 16 * wq + (lq >> 2);  // this thread's rows, jq (+ 8)
      const bf16* dgq = dg_buf + static_cast<size_t>(opaque(
                                     static_cast<int>(blockIdx.x))) *
                                     npairs * kTile * kTile;
      auto count = [&](int t) { return extra + (kC ? t + 1 : nt - t); };
      int nsteps = 0;
      for (int t = 0; t < nt; ++t) nsteps += count(t);
      // step s: tile t and p < 0 (the heads' step) or the pair (i, j) =
      // (t + p, t) for dB, (t, p) for dC
      auto step_of = [&](int s, int& t, int& p) {
        t = 0;
        while (s >= count(t)) {
          s -= count(t);
          ++t;
        }
        p = s - extra;
      };
      const int r0 = rk;
      auto request = [&](int s) {
        int t, p;
        step_of(s, t, p);
        if (p < 0)
          request_ring(r0 + s, c0, -1, kC ? t : -1, kC ? -1 : t, -1);
        else if (kC)
          request_ring(r0 + s, c0, -1, -1, -1, p);
        else
          request_ring(r0 + s, c0, t + p, -1, -1, -1);
      };
      auto dg_at = [&](int s) -> const uint4* {
        if (s >= nsteps) return nullptr;
        int t, p;
        step_of(s, t, p);
        if (p < 0) return nullptr;
        const int i = kC ? t : t + p, jj = kC ? p : t;
        return reinterpret_cast<const uint4*>(
            dgq + static_cast<size_t>(i * (i + 1) / 2 + jj) * kTile * kTile);
      };
      auto dg_fetch = [&](int s) {
        const uint4* src = dg_at(s);
        if (src != nullptr) {
          dgr[0] = src[tq];
          dgr[1] = src[tq + kBwdThreads];
        }
      };
      auto dg_put = [&](int s) {
        if (dg_at(s) != nullptr) {
          uint4* dst = reinterpret_cast<uint4*>(
              at(slot_at(r0 + s) + NB * kBoxBytes));
          dst[tq] = dgr[0];
          dst[tq + kBwdThreads] = dgr[1];
        }
      };
      if (tq == 0) {
        request(0);
        if (nsteps > 1) request(1);
      }
      dg_fetch(0);
      dg_put(0);
      dg_fetch(1);
      fence_async();
      __syncthreads();
      for (int t = 0, s = 0; t < nt; ++t) {
        const int t0 = t * kTile;
        float acc[32];
        zero(acc);
        for (int p = -extra; p < count(t) - extra; ++p, ++s, ++rk) {
          const uint32_t slot = ring_wait();
          if (wg < NB) {
            if (p < 0) {
              for (int k = 0; k < nh; ++k) {
                float sr[2];  // the row scale of head k at rows t0 + jq (+ 8)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const int rr = t0 + jq + 8 * hh;
                  const float* ck = cum + k * qp;
                  sr[hh] = rr >= Q ? 0.f
                           : kC    ? ex2(ck[rr])
                                   : ex2(ck[Q - 1] - ck[rr]) * dts[k * qp + rr];
                }
                const uint32_t tk = slot + k * PB * kBoxBytes;
                const uint32_t sk =
                    lm::desc_lo((kC ? sc_hi(k) : ds_hi(k)) + wg * kBoxBytes,
                                16);
                static_for<PB>([&](auto bs) {  // a 64-column box of P at a time
                  constexpr int pb = decltype(bs)::value;
                  uint32_t af[4][4];
#pragma unroll
                  for (int kk = 0; kk < 4; ++kk) {
                    const int r = 16 * wq + (lq & 7) + 8 * ((lq >> 3) & 1);
                    lm::ldmatrix_x4(
                        af[kk], tk + swz(r, 64 * pb + 16 * kk + 8 * (lq >> 4),
                                         kBoxBytes));
#pragma unroll
                    for (int q = 0; q < 4; ++q) {  // a0, a2: row g; a1, a3: + 8
                      const float2 v = bf2(af[kk][q]);
                      af[kk][q] =
                          lm::pack_bf16x2(v.x * sr[q & 1], v.y * sr[q & 1]);
                    }
                  }
                  lm::fence_regs(af);
                  lm::fence_regs(acc);
                  lm::wgmma_fence();
                  static_for<4>([&](auto st) {
                    constexpr int kk = decltype(st)::value;
                    lm::wgmma_m64n64k16_rs<(pb * NB * kBoxBytes + kk * 32) /
                                           16>(acc, af[kk], sk, hi);
                  });
                  lm::wgmma_commit();
                  lm::wgmma_wait<0>();
                  lm::fence_regs(af);
                  lm::fence_regs(acc);
                });
              }
            } else {
              lm::fence_regs(acc);
              lm::wgmma_fence();
              const uint32_t g_lo =
                  lm::desc_lo(slot + NB * kBoxBytes, kC ? kBoxBytes : 16);
              const uint32_t o_lo =
                  lm::desc_lo(slot + wg * kBoxBytes, kBoxBytes);
              static_for<4>([&](auto st) {
                constexpr int kk = decltype(st)::value;
                if constexpr (kC)
                  lm::wgmma_m64n64k16_ss_ta_tb<kk * 2048 / 16, kk * 2048 / 16>(
                      acc, g_lo, o_lo, hi, 1);
                else
                  lm::wgmma_m64n64k16_ss_tb<kk * 32 / 16, kk * 2048 / 16>(
                      acc, g_lo, o_lo, hi, 1);
              });
              lm::wgmma_commit();
              lm::wgmma_wait<0>();
              lm::fence_regs(acc);
            }
          }
          dg_put(s + 1);  // its slot held step s - 1, done
          dg_fetch(s + 2);
          fence_async();
          __syncthreads();  // slot s is free; slot s + 1 has its dG
          if (tq == 0 && s + 2 < nsteps) request(s + 2);
        }
        if (wg < NB) stage(wg, acc);
        emit(kC ? 1 : 0, c0, t0);
      }
    };
    group_pass(std::integral_constant<bool, false>());

    // ---- the row walk (not at chunk 0: its entry state is zero and the
    // initial state's gradient is no output), two passes over the 64-row
    // tiles i: dcum_i += 2^cum_i dy_i . (C_i S_c) with S_c as hi + lo;
    // then dS <- 2^cum_Q dS + (2^cum_i C_i)^T dy_i with 2^cum_i C_i as
    // hi + lo
    // dS before the update (this chunk's): d(s_final) at the last chunk
    // (null: zero), after it the float32 copy the update writes
    auto ds_old = [&](int k) -> const float* {
      const size_t o = static_cast<size_t>(bh0 + k) * N * P;
      return ci < nc - 1 ? ds_buf + o
                         : (ds_final != nullptr ? ds_final + o : nullptr);
    };
    if (ci > 0) {
      // S_c as hi and lo, and <S_c, dS> (each warp's share, a head's)
      for (int k = 0; k < nh; ++k) {
        float dot = load_state(
            sc_hi(k), sc_lo(k),
            states + (static_cast<size_t>(bh0 + k) * (nc - 1) + ci - 1) * N *
                         P,
            ds_old(k));
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) red[k * 8 + tid / 32] = dot;
      }
      // the chunk's (2^cum_i C_i)^T dy_i, float32, this warpgroup's box of P
      float dsa[NB][32];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) zero(dsa[nb]);
      fence_async();
      // this walk's own copies of the thread's indices (see opaque)
      const int lr = opaque(lane), wr = opaque(warp);
      const int jrr = 16 * wr + (lr >> 2), t4r = lr & 3;
      const int hq = opaque(h), psq = opaque(ps), hrq = opaque(hr);
      const float* cuq = cum + hq * qp;
      // two passes over the row tiles (C_i and the heads' dy_i in the
      // ring each time), so that V and the dS sums never share registers
      for (int pass = 0; pass < 2; ++pass) {
      __syncthreads();  // every slot is free
      if (tid == 0)
        for (int k = 0; k < min(2, nt); ++k)
          request_ring(rk + k, c0, k, k, -1, -1);
      for (int i = 0; i < nt; ++i, ++rk) {
        const int i0 = i * kTile;
        const uint32_t slot = ring_wait();
        if (mine && pass == 0) {
          const uint32_t c_lo = lm::desc_lo(slot, 16);
          const uint32_t dy_t = slot + (NB + hq * PB) * kBoxBytes;
          // V = C_i S_c (S_c as hi + lo) over this warpgroup's box of P,
          // and this lane's share of dy_i . V
          float rd[2] = {0.f, 0.f}, v[32];
          zero(v);
          lm::fence_regs(v);
          lm::wgmma_fence();
          const uint32_t sh =
              lm::desc_lo(sc_hi(hq) + psq * NB * kBoxBytes, kBoxBytes);
          const uint32_t sl =
              lm::desc_lo(sc_lo(hq) + psq * NB * kBoxBytes, kBoxBytes);
          static_for<KN>([&](auto st) {
            constexpr int kk = decltype(st)::value;
            lm::wgmma_m64n64k16_ss_tb<(kk / 4 * kBoxBytes + kk % 4 * 32) / 16,
                                      kk * 2048 / 16>(v, c_lo, sh, hi,
                                                      kk > 0);
          });
          static_for<KN>([&](auto st) {
            constexpr int kk = decltype(st)::value;
            lm::wgmma_m64n64k16_ss_tb<(kk / 4 * kBoxBytes + kk % 4 * 32) / 16,
                                      kk * 2048 / 16>(v, c_lo, sl, hi, 1);
          });
          lm::wgmma_commit();
          lm::wgmma_wait<0>();
          lm::fence_regs(v);
#pragma unroll
          for (int nn = 0; nn < 8; ++nn)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 yv = bf2(*reinterpret_cast<const uint32_t*>(at(
                  dy_t + swz(jrr + 8 * hh, 64 * psq + 8 * nn + 2 * t4r,
                             kBoxBytes))));
              rd[hh] = fmaf(v[4 * nn + 2 * hh], yv.x, rd[hh]);
              rd[hh] = fmaf(v[4 * nn + 2 * hh + 1], yv.y, rd[hh]);
            }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float s = quad_sum(rd[hh]);
            const int ii = i0 + jrr + 8 * hh;
            if (t4r == 0 && ii < Q) dcum[hrq * qp + ii] += ex2(cuq[ii]) * s;
          }
        }
        if (mine && pass == 1) {
          const uint32_t dy_t = slot + (NB + hq * PB) * kBoxBytes;
          // dS += (2^cum_i C_i)^T dy_i, a k-step of 16 rows i and one of
          // N's boxes at a time: ldmatrix.trans of C_i's tile, times
          // 2^cum_i, as hi + lo
          const uint32_t db = lm::desc_lo(dy_t + psq * kBoxBytes, kBoxBytes);
          static_for<4>([&](auto s) {
            constexpr int kk = decltype(s)::value;
            const int r = kk * 16 + ((lr >> 4) & 1) * 8 + (lr & 7);
            const int cb = wr * 2 + ((lr >> 3) & 1);
            const int ik = i0 + kk * 16 + 2 * t4r;
            float ek[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int ii = ik + (q & 1) + 8 * (q >> 1);
              ek[q] = ii < Q ? ex2(cuq[ii]) : 0.f;
            }
            static_for<NB>([&](auto t) {
              constexpr int nb = decltype(t)::value;
              uint32_t ah[1][4], al[1][4];
              lm::ldmatrix_x4_trans(ah[0], slot + nb * kBoxBytes + r * 128 +
                                               ((cb ^ (r & 7)) << 4));
#pragma unroll
              for (int q = 0; q < 4; ++q) {  // a0, a1: rows i 2t..; a2, a3: + 8
                const float2 cv = bf2(ah[0][q]);
                const int e0 = q < 2 ? 0 : 2;
                split_bf16x2(cv.x * ek[e0], cv.y * ek[e0 + 1], ah[0][q],
                             al[0][q]);
              }
              lm::fence_regs(ah);
              lm::fence_regs(al);
              lm::fence_regs(dsa[nb]);
              lm::wgmma_fence();
              lm::wgmma_m64n64k16_rs_tb<kk * 2048 / 16>(dsa[nb], ah[0], db,
                                                        hi);
              lm::wgmma_m64n64k16_rs_tb<kk * 2048 / 16>(dsa[nb], al[0], db,
                                                        hi);
              lm::wgmma_commit();
              lm::wgmma_wait<0>();
              lm::fence_regs(ah);
              lm::fence_regs(al);
              lm::fence_regs(dsa[nb]);
            });
          });
        }
        __syncthreads();  // the slot is free
        if (tid == 0 && i + 2 < nt)
          request_ring(rk + 2, c0, i + 2, i + 2, -1, -1);
      }
      }
      // the chunk before's dS = 2^cum_Q dS + the chunk's sum, a warpgroup
      // at a time through the staging tile ([64 NB rows n][64 p] float32):
      // float32 for its update, bfloat16 hi and lo for its state terms
      float* st = reinterpret_cast<float*>(at(base + lay.stage));
      for (int w = 0; w < (kSplit ? 2 : nh); ++w) {
        if (mine && wg == w) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int nn = 0; nn < 8; ++nn)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<float2*>(
                    st + (64 * nb + jr + 8 * hh) * kTile + 8 * nn + 2 * t4) =
                    make_float2(dsa[nb][4 * nn + 2 * hh],
                                dsa[nb][4 * nn + 2 * hh + 1]);
        }
        __syncthreads();
        const int hw = kSplit ? 0 : w, pw = kSplit ? w : 0;
        const float* src = ds_old(hw);
        float* dst = ds_buf + static_cast<size_t>(bh0 + hw) * N * P;
        const float eq = ex2(cum[hw * qp + Q - 1]);
        for (int idx = tid; idx < NB * kTile * 32; idx += kBwdThreads) {
          const int n = idx / 32, pc = idx % 32 * 2, p = 64 * pw + pc;
          float v0 = st[n * kTile + pc], v1 = st[n * kTile + pc + 1];
          if (n < N) {
            const size_t o = static_cast<size_t>(n) * P + p;
            if (p < P) {
              if (src != nullptr) v0 = fmaf(eq, src[o], v0);
              dst[o] = v0;
            }
            if (p + 1 < P) {
              if (src != nullptr) v1 = fmaf(eq, src[o + 1], v1);
              dst[o + 1] = v1;
            }
          }
          uint32_t h2, l2;
          split_bf16x2(v0, v1, h2, l2);
          const uint32_t off = swz(n, p, NB * kBoxBytes);
          *reinterpret_cast<uint32_t*>(at(ds_hi(hw) + off)) = h2;
          *reinterpret_cast<uint32_t*>(at(ds_lo(hw) + off)) = l2;
        }
        __syncthreads();  // the staging tile is read
      }
      fence_async();
    }

    // ---- the cumsum's backward: d(cum_Q) gains sum_j w_j dw_j and
    // 2^cum_Q <S_c, dS>; d(da)_k = sum_{i >= k} dcum_i; ddt_k += a d(da)_k,
    // da += sum_k dt_k d(da)_k (a warp a head, fixed order)
    __syncthreads();
    if (tid < 32 * nh) {
      const int k = tid / 32, bk = bh0 + k;
      const float av = a[bk];
      // head k's row of the sums, plus the second warpgroup's of a split
      // head
      auto row = [&](const float* r, int t) {
        return kSplit ? r[t] + r[qp + t] : r[k * qp + t];
      };
      float s = 0.f;
      for (int t = lane; t < Q; t += 32) s += row(wdw, t);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      float dot = 0.f;  // <S_c, dS>: the eight warps' shares in order
      for (int w = 0; w < kBwdThreads / 32; ++w) dot += red[k * 8 + w];
      const float tail = s + (ci > 0 ? ex2(cum[k * qp + Q - 1]) * dot : 0.f);
      float carry = 0.f, prt = 0.f;
      for (int t1 = Q; t1 > 0; t1 -= 32) {
        const int t = t1 - 32 + lane;
        float v = t >= 0 ? row(dcum, t) + (t == Q - 1 ? tail : 0.f) : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float nb = __shfl_down_sync(0xffffffffu, v, off);
          if (lane + off < 32) v += nb;
        }
        v += carry;
        carry = __shfl_sync(0xffffffffu, v, 0);
        if (t >= 0) {
          ddt[static_cast<size_t>(bk) * L + c0 + t] = row(dd, t) + av * v;
          prt = fmaf(dts[k * qp + t], v, prt);
        }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        prt += __shfl_xor_sync(0xffffffffu, prt, off);
      if (lane == 0) dacc[2 * k] += prt;
    }
    __syncthreads();  // the cumsum's reads of dcum
    group_pass(std::integral_constant<bool, true>());
  }
  if (tid < nh) da[bh0 + tid] = dacc[2 * tid];
}

// The sum of each group's `parts` float32 partials of dB and dC (2,
// groups * parts, L * Nr), one a block of the group's heads, in order,
// into (2, groups, L * Nr) bfloat16: four values a thread.
__global__ void ssd_bwd_sum_parts(const float* __restrict__ part,
                                  bf16* __restrict__ out, int parts,
                                  long long per_group, long long total) {
  const long long n4 = 2 * total / 4;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       q < n4; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long idx = 4 * q, which = idx / total, r = idx % total;
    const long long grp = r / per_group, e = r % per_group;
    const float* src =
        part + which * total * parts + grp * parts * per_group + e;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < parts; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(src + k * per_group);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<uint2*>(out + idx) =
        make_uint2(lm::pack_bf16x2(s.x, s.y), lm::pack_bf16x2(s.z, s.w));
  }
}

// The bfloat16 backward's heads a block: two where P <= 64 and a group
// has two, and their shared memory holds the chunk, else one; 0 where
// not even one fits.
int bwd_wgmma_heads(int P, int N, int Q, int rep) {
  const int nb = N > 64 ? 2 : 1, pb = P > 64 ? 2 : 1;
  for (int hb = (P <= 64 && rep >= 2) ? 2 : 1; hb >= 1; --hb)
    if (bwd_wgmma_smem(nb, pb, hb, Q) <= 227 * 1024) return hb;
  return 0;
}
using BwdWgmmaKernel = decltype(&ssd_bwd_wgmma<1, 1, 1>);
// the build for N's and P's boxes and the heads a block (two only where P
// fits one box)
BwdWgmmaKernel bwd_wgmma_kernel(int nb, int pb, int hb) {
  if (pb == 2) return nb == 2 ? ssd_bwd_wgmma<2, 2, 1> : ssd_bwd_wgmma<1, 2, 1>;
  if (nb == 2) return hb == 2 ? ssd_bwd_wgmma<2, 1, 2> : ssd_bwd_wgmma<2, 1, 1>;
  return hb == 2 ? ssd_bwd_wgmma<1, 1, 2> : ssd_bwd_wgmma<1, 1, 1>;
}

// x, dy (bh, L, Pr), b, c (bh / rep, L, Nr) bfloat16, Pr and Nr multiples
// of 8 (the wrapper zero-pads to them), 16-byte aligned; states, ds_final
// and ds_buf at the true (N, P); see ssd_scan_bwd_wgmma_launch
int launch_bwd_wgmma(const float* a, const void* x, const float* dt,
                     const void* b, const void* c, const void* dy,
                     const float* states, const float* ds_final,
                     float* ds_buf, void* dg_buf, void* dx, float* ddt,
                     float* da, float* part, void* out, int bh, int L, int P,
                     int N, int Pr, int Nr, int Q, int rep, int hb,
                     cudaStream_t stream) {
  const int nb = Nr > 64 ? 2 : 1, pb = Pr > 64 ? 2 : 1;
  const int sets = (rep + hb - 1) / hb, groups = bh / rep;
  const size_t smem = bwd_wgmma_smem(nb, pb, hb, Q);
  if (Pr % 8 || Nr % 8 || Pr < P || Nr < N || hb < 1 || hb > 2 ||
      (hb > 1 && pb > 1) || smem > 227 * 1024 ||
      (L > Q && ds_buf == nullptr) || (sets > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_dy, map_b, map_c;
  if (!lm::make_head_map(&map_x, x, Pr, L, bh, kTile) ||
      !lm::make_head_map(&map_dy, dy, Pr, L, bh, kTile) ||
      !lm::make_head_map(&map_b, b, Nr, L, groups, kTile) ||
      !lm::make_head_map(&map_c, c, Nr, L, groups, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdWgmmaKernel kern = bwd_wgmma_kernel(nb, pb, hb);
  cudaError_t e = lm::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<groups * sets, kBwdThreads, smem, stream>>>(
      map_x, map_dy, map_b, map_c, a, dt, states, ds_final, ds_buf,
      static_cast<bf16*>(dg_buf), static_cast<bf16*>(dx), ddt, da, part,
      static_cast<bf16*>(out), L, P, N, Pr, Nr, Q, rep, sets);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sets > 1) {
    const long long per_group = static_cast<long long>(L) * Nr;
    const long long total = per_group * groups;
    const int blocks =
        static_cast<int>(std::min<long long>((2 * total / 4 + 255) / 256,
                                             4096));
    ssd_bwd_sum_parts<<<blocks, 256, 0, stream>>>(
        part, static_cast<bf16*>(out), sets, per_group, total);
  }
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

// The float32 backward of ssd_scan_launch at the same a, x, dt, b, c (and
// Q, rep): dy (bh, L, P); states (bh, L / Q - 1, N, P) float32 from the
// forward (null when L == Q); ds_final (bh, N, P) float32 or null (zero).
// Writes dx (bh, L, P), ddt (bh, L) and da (bh,), and dB, dC as partial
// sums (bh / rep * sets, L, N), one a block of hb heads (hb divides rep,
// sets = rep / hb): the caller sums each group's `sets` partials. (The
// bfloat16 backward is ssd_scan_bwd_wgmma_launch.)
extern "C" int ssd_scan_bwd_launch(const void* a, const void* x,
                                   const void* dt, const void* b,
                                   const void* c, const void* dy,
                                   const void* states, const void* ds_final,
                                   void* dx, void* ddt, void* da,
                                   void* db_part, void* dc_part, int bh,
                                   int L, int P, int N, int Q, int rep,
                                   int hb, void* stream) {
  if (bh < 1 || L < 1 || Q < 1 || L % Q || rep < 1 || bh % rep || P < 1 ||
      P > 128 || N < 1 || N > 128 || hb < 1 || hb > rep || rep % hb ||
      (L > Q && states == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<float>(
      static_cast<const float*>(a), x, static_cast<const float*>(dt), b, c,
      dy, static_cast<const float*>(states),
      static_cast<const float*>(ds_final), dx, static_cast<float*>(ddt),
      static_cast<float*>(da), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), bh, L, P, N, Q, rep, hb,
      static_cast<cudaStream_t>(stream));
}

// The bfloat16 backward (ssd_bwd_wgmma) at the forward's a, x, dt, b, c
// (and Q, rep): x, dy (bh, L, Pr) and b, c (bh / rep, L, Nr) bfloat16, Pr
// and Nr P and N rounded up to multiples of 8 (zero-padded: TMA's 16-byte
// row strides); states (bh, L / Q - 1, N, P) float32 from the forward
// (null when L == Q) and ds_final (bh, N, P) float32 or null (zero), at
// the true P, N. hb heads a block (1 or 2; 1 where P > 64), sets =
// ceil(rep / hb) blocks a group. Scratch: ds_buf (bh, N, P) float32 (null
// when L == Q); dg_buf (bh / rep * sets, T (T + 1) / 2, 64, 64) bfloat16, T
// the chunk's 64-row tiles; part (2, bh / rep * sets, L, Nr) float32 where
// sets > 1, else null. Writes dx (bh, L, Pr) bfloat16, ddt (bh, L) and da
// (bh,) float32, and out (2, bh / rep, L, Nr) bfloat16: dB, then dC.
extern "C" int ssd_scan_bwd_wgmma_launch(
    const void* a, const void* x, const void* dt, const void* b,
    const void* c, const void* dy, const void* states, const void* ds_final,
    void* ds_buf, void* dg_buf, void* dx, void* ddt, void* da, void* part,
    void* out, int bh, int L, int P, int N, int Pr, int Nr, int Q, int rep,
    int hb, void* stream) {
  if (bh < 1 || L < 1 || Q < 1 || L % Q || rep < 1 || bh % rep || P < 1 ||
      N < 1 || Pr > 128 || Nr > 128 || hb > rep ||
      (L > Q && states == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_wgmma(
      static_cast<const float*>(a), x, static_cast<const float*>(dt), b, c,
      dy, static_cast<const float*>(states),
      static_cast<const float*>(ds_final), static_cast<float*>(ds_buf),
      dg_buf, dx, static_cast<float*>(ddt), static_cast<float*>(da),
      static_cast<float*>(part), out, bh, L, P, N, Pr, Nr, Q, rep, hb,
      static_cast<cudaStream_t>(stream));
}

// The bfloat16 backward's launch at (P, N, Q, rep), into out[0..5]: shared
// memory bytes, resident blocks an SM, registers a thread, local
// (spilled) bytes a thread, heads a block, blocks a group. Launches
// nothing; cudaErrorInvalidValue where the kernel takes no such launch.
extern "C" int ssd_scan_bwd_wgmma_info(int P, int N, int Q, int rep,
                                       void* out) {
  if (P < 1 || P > 128 || N < 1 || N > 128 || Q < 1 || rep < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hb = bwd_wgmma_heads(P, N, Q, rep);
  if (hb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = N > 64 ? 2 : 1, pb = P > 64 ? 2 : 1;
  const BwdWgmmaKernel kern = bwd_wgmma_kernel(nb, pb, hb);
  const size_t smem = bwd_wgmma_smem(nb, pb, hb, Q);
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
  o[4] = hb;
  o[5] = (rep + hb - 1) / hb;
  return 0;
}
