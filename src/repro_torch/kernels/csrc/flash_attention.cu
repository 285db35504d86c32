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
// Every build walks 64-key tiles up to the largest key limit of its
// block's query rows (the causal triangle above it is never read) and
// leave masked keys out of the softmax, which gives what the TPU
// kernel's exp(-1e30 - m) gives: every row has key 0 in its first tile.
//
// Sliding window (Gemma3's local layers; causal, tq == tk). The
// reference's windowed chunked attention reads, for query tile qi, the
// KV tiles from max(qi - window / tk, 0) on, under the mask qpos - kpos <
// window; that tile bound drops keys inside the window when window % tk
// > 1, so it is part of the function. Each row gets a lower key limit
// beside its upper one:
//   klo = max(qpos - window + 1, max(qpos / tq - window / tk, 0) tk)
// (key_lower), at most qpos, so no row's softmax is empty, and like klim
// not decreasing with the row. Every pass starts its key walk at the
// 64-key tile holding its first row's klo and masks only the tiles that
// cross either limit; the dK/dV passes walk exactly the query tiles from
// the first whose last row's klim passes the block's first key to the
// last whose first row's klo is below its last.
//
// Head dims 1 to 256. Every bfloat16 D runs flash_fwd_wgmma, at the
// build of 64, 128, 192 or 256 columns that holds it, whose input
// contract is a row width Dr that is a multiple of 8 (TMA takes 16-byte
// row strides) and 16-byte aligned bases: the wrapper zero-pads q, k and
// v to Dr and slices o back, launching at the true D's scale D^-1/2
// (exact: zero columns add nothing to q k^T and give zero output
// columns); TMA zero-fills the columns from Dr to the build's width, a
// 64-column box wider than a row of Dr < 64 too (the smoke configs' D
// 12-20). No bfloat16 forward falls back to another kernel or to the
// plain version: a failed build or launch raises.
//
// What bounds it. At the main path's shapes (BH = 8 x 32 = 256, L = 512,
// D = 112, bfloat16, causal) it must read q, k, v and write o, 117 MB,
// or 0.035 ms at 3.35 TB/s; the causal triangle's two products are
// 1.5e10 operations, 0.015 ms at the bfloat16 tensor-core rate. So bytes
// bound it. At long L operations do: LLaVA-NeXT-34B's first layer (BH
// 448, L 2,048, D 128, causal) 0.49 ms (bytes 0.28), Qwen2-MoE's (BH
// 128, L 4,096, D 128) 0.56 ms, Whisper's encoder (BH 384, L 1,500, D
// 64, non-causal) 0.22 ms (bytes 0.09); past D 128 at Gemma3-12B's serve
// shape (BH 8 x 16 = 128, L 4,096, D 256, tile 1,024) 0.49 ms for a
// local layer's window of 1,024 (4.8e11 operations; the bytes 0.32 ms),
// 1.11 ms for a global layer's causal triangle; at DeepSeek-V3's first
// MLA layer (BH 8 x 128 = 1,024, L 4,096, D 192, causal) 6.67 ms (bytes
// 1.92). A second floor at D <= 128: the exponentials. The SFU's ex2
// gives 16 results a clock an SM, about 3.9e12 a second on the card, so
// Whisper's 8.6e8 scores take at least 0.22 ms of it (as much as its
// products) and LLaVA's 9.4e8 0.24 ms (half its products'); only overlap
// with the products (the other warpgroup's, and the warpgroup's own P v)
// keeps the two floors from adding.
//
// bfloat16 (flash_fwd_wgmma<64 | 128 | 192 | 256>): FlashAttention on
// Hopper's wgmma and TMA. A block owns 128 query rows of a head, two
// warpgroups of 64; the grid walks each head's query blocks heaviest
// first, heads outermost, so the blocks in flight share a few heads' k
// and v in L2. Thread 0 brings q once (128 x D) and the first 64-key
// tiles of k and v, each in 64-column boxes with the 128-byte swizzle,
// through 3-D tensor maps (Dr, L, BH) that zero-fill past each head's L
// (a next head's rows could hold anything; a zero v row times P = 0 is
// 0). k and v have rings of their own, 2 slots at D <= 128 and D 256 (64
// + 2 x 64 KB) and 3 at D 192 (48 + 3 x 48 KB), each slot's tile
// completing on a full mbarrier; each warpgroup's leader counts its
// release of a slot in shared memory, and the second to release it
// requests the tile two (or three) on: k's slot after S, v's after P v,
// so a load is in flight for more than a tile's products. Per 64-key
// tile a warpgroup issues S = q k^T (D / 16 wgmma m64n64k16, q and k
// K-major from shared memory, S float32 in 32 registers a thread) beside
// P v of the tile before (4 wgmma m64nDk16, P's bfloat16 A fragments in
// registers, v as transposed B, O float32 in D / 2 registers); the
// softmax of the tile (the mask on crossing tiles, quad shuffles, the
// SFU's exp2 of the scaled float32 S, never of bfloat16 q: D^-1/2 is not
// a power of two; the denominator from float32 P, maxima and sums as
// trees) runs while P v computes, then O takes the correction and P is
// packed for the next product. Rounding P to bfloat16 for P v is the
// only rounding the plain version lacks: one bfloat16 step at most.
// Past D 128 the two warpgroups take turns to issue (named barriers), so
// one's softmax runs under the other's products; at D <= 128, where a
// tile's products are shorter beside the same softmax, the turns
// measured slower (3-5% at D 128) and each warpgroup issues at will. A
// descriptor's k-step offset is an immediate in the wgmma's PTX, so
// descriptors take no registers; ptxas keeps the warpgroups at about 215
// (D 256), 184 (D 192), 146 (D 128) and 108 (D 64) registers with no
// spill. 256
// threads, not a warp-specialised producer: ptxas gives a wgmma kernel's
// registers over whole warpgroups, and a third warpgroup (or a ninth
// warp) held every thread to 168 and spilled at D 256 even under
// setmaxnreg 24 / 240; at D <= 128 the slot's second releaser already
// keeps the loads ahead (loading k and v once, wrongly, saves under a
// tenth). Both warpgroups walk every tile from the one holding the
// block's first row's lower key limit to its last row's upper one: a
// tile outside a row's limits is masked, and skipping it per warpgroup
// measured no gain. At D <= 128 a 128-key tile (S in 64 registers a
// thread, one row reduction a 128 keys) measured slower, the deepest
// rings far slower at D 64 (a block's prologue then requests 13 tiles of
// k and of v), and two blocks an SM or three warpgroups a block no
// faster. What holds it under its bound, largest first: the softmax
// between a warpgroup's products (a fifth of the time at D 128); the
// products themselves, P v, then S at N = 64 (which reads as many bytes
// of q as of k from shared memory); k and v read once per 128 rows
// through L2, and TMA's writes beside the products' reads
// (scripts/flash_wgmma_ablate.py, PERF.md).
//
// The bfloat16 kernel writes each row's log-sum-exp of its scaled
// scores, m + log(den), when given an lse pointer (training; serving
// passes null); the backward reads it.
//
// float32 (flash_fwd): on the CUDA cores, as first ported. The float32
// tolerance (1e-4) rules out bfloat16 or TF32 products, and no main path
// runs it. One block of 256 threads per (head, 64 query rows) keeps q,
// scaled, k^T, v and P as float32 tiles in shared memory, forms the 64 x
// 64 score tile in registers (a 4 x 4 micro-tile per thread), runs the
// online softmax four threads a row and adds P v to a 4 x D/16 output
// micro-tile (CM = 8 columns a thread to D 128, 16 to D 256: 214 KB of
// shared memory at D 256). Ragged L and D are zero-padded in shared
// memory and masked.
// Backward (no TPU kernel: the reference trains through jnp attention
// and autodiff, so this is the gradient of src/repro/kernels/
// flash_attention.py:61's function, its key bound included). Given q, k,
// v, o, dO and the forward's lse it recomputes P = exp(scale q k^T - lse)
// tile by tile under the forward's key limits, and forms D = rowsum(dO o),
// dV = P^T dO, dS = P (dO v^T - D), dQ = scale dS k, dK = scale dS^T q.
// One pass over blocks of query rows forms dQ (and writes D), then one
// over blocks of keys dK and dV, over exactly the query tiles whose key
// limit reaches them: no atomics, the gradients deterministic. Outputs in
// q's type.
//
// What bounds it. At Qwen2-1.5B's training shape (BH 96, L 512, D 128,
// causal, bfloat16) it must read q, k, v, o, dO and lse and write dq, dk,
// dv, about 101 MB or 0.030 ms at 3.35 TB/s; its five causal products are
// about 1.6e10 operations, 0.016 ms at the bfloat16 tensor-core rate. So
// bytes bound it. At Whisper's encoder (BH 384, L 1,500, D 64,
// non-causal) operations do: 0.56 ms for the five products (the bytes
// 0.18). The two passes recompute S and dP, seven products of the five,
// and each takes the exponential of every score again: at D <= 128 the
// exponentials (the SFU's 16 a clock an SM; Whisper's 1.7e9, 0.45 ms)
// and the elementwise work around them rival the products.
//
// bfloat16 (flash_bwd_dq_wgmma<64 | 128 | 192 | 256>, then
// flash_bwd_dkdv_wgmma<64 | 128 | 192 | 256>): Hopper's wgmma and TMA at
// the build that holds the head dim, under the forward's input contract
// (the wrapper zero-pads q, k, v, o and dO to Dr, a multiple of 8,
// launches at the true D's scale and slices the gradients back: zero
// columns add nothing to q k^T or dO v^T and get zero gradients). Both
// passes run 256 threads, two warpgroups and no producer warp (as
// flash_fwd_wgmma: a third warpgroup caps every thread at 168 registers),
// tiles of 64 rows in 64-column boxes with the 128-byte swizzle through
// 3-D tensor maps (Dr, L, BH) that zero-fill past each head's L, and
// rings whose slot the second warpgroup to release it refills. The grid
// runs heads outermost, so the blocks in flight share a few heads' tiles
// in L2, or, where every head's k and v fit in L2 together (40 MB),
// heads fastest, so the heaviest blocks of every head run first. P =
// exp2 of the scaled float32 S by the SFU's ex2.approx (exp2f measured
// 2-7% slower); the mask only on tiles that cross a limit; rows and keys
// past L get P = 0. The scale is applied to the float32 S inside exp2
// and to dQ and dK in the epilogue, never to bfloat16 q (D^-1/2 is not a
// power of two). Rounding P to bfloat16 before P^T dO and dS before dS k
// and dS^T q are the two roundings the plain version lacks: one bfloat16
// step each at most.
//   The dQ pass: q and dO come once by TMA, and D = rowsum(dO o) from
// plain 16-byte loads while they land; k and v in rings of 64-key tiles
// (v 2 slots at D <= 128 and D 256, 3 at D 192; k, held a tile longer,
// one more) from the one holding the block's first row's lower key limit
// to its last row's upper one. At D <= 128 a block owns 128 query rows
// and warpgroup c rows 64 c..: S = q k^T and dP = dO v^T (wgmma
// m64n64k16, both from shared memory), P and dS = P (dP - D) in float32
// registers, dS rounded into the A fragments of dQ += dS k (m64nDk16, k
// as transposed B), issued beside the next tile's S and dP; each
// warpgroup keeps the one 64 x D float32 sum of its rows, and nothing
// crosses between them. Past 128 the sums would not fit beside S and dP:
// a block owns 64 rows, warpgroup c takes keys 32 c.. of every tile
// (m64n32k16) into a sum of its own (128 or 96 registers a thread), and
// the two are added once at the end, through the free k ring, in a fixed
// order (no product starts inside a swizzle atom: D 192's column halves
// would, at column 96). The pass also writes each row's lse log2 e, D
// and key limits into the scratch in 64-row chunks for the dK/dV pass.
//   The dK/dV pass: k and v come once by TMA, q and dO in a ring of
// 64-query tiles (4 slots at D <= 128, 2 at D 256, 3 at D 192) over
// exactly the query tiles some row of which reads a key of the block,
// heaviest (causal: first keys) first; each slot also takes its queries'
// lse log2 e, D and key limits in four 256-byte bulk copies on the same
// barrier (read per query from global memory, or its limits recomputed
// with integer divisions, they cost more than the tile's products). At D
// <= 128 a block owns 128 keys and warpgroup c keys 64 c.. and runs the
// whole chain: S^T = k q^T and dP^T = v dO^T (m64n64k16 from shared
// memory), P^T and dS^T = P^T (dP^T - D) in float32 registers, rounded
// into the A fragments of dV += P^T dO and dK += dS^T q (m64nDk16, dO and
// q as transposed B), issued beside the next tile's S^T and dP^T; dK and
// dV take 2 x D / 2 registers beside S^T's and dP^T's 64 (254 a thread at
// D 128, no spill), and nothing crosses between the warpgroups. Past 128
// a block owns 64 keys and the warpgroups split by role. Warpgroup 0: S^T,
// P^T under the limits, written as float32 to shared memory in its
// register order (16 KB), then dV += P^T dO. Warpgroup 1: dP^T beside
// S^T; after P^T lands (named barriers: P^T written, P^T read), dS^T and
// dK += dS^T q. Shared memory: 211.5 KB at D 256, 212.5 KB at D 192.
//   At D <= 128 both warpgroups walk every tile of the block (a row's or
// key's scores outside its limits are masked: skipping the tiles outside
// a warpgroup's own limits measured slower); one whose rows or keys all
// lie past L (its q and dO, or k and v, not loaded) waits for each tile
// and releases it unread. There a dK/dV slot is held from its tile's S^T
// to the next tile's dK and dV, so 2 slots left a refill no time to land
// (Whisper's backward 2.48 ms, 2.21 with 4). The wide builds' designs
// measured slower at D <= 128 (the role split 2-12%, the key split
// 5-19%); turns between the warpgroups' issues no faster, and two blocks
// an SM at D 64 spill.
//   What holds the kernels under their bound (PERF.md,
// scripts/flash_bwd_ablate.py): at D <= 128 the elementwise work between
// a warpgroup's products (exponentials, masks, dS; the conversions to
// bfloat16 cost 1%), about a quarter of Whisper's time; the loads'
// latency (an eighth of Whisper's dK/dV pass with q and dO loaded once);
// past 128 each warpgroup's chain of product, exponentials or dS, and
// product with no other work beside it (the dK/dV pass's warpgroup 1
// waits for P^T), the dQ pass's N = 32 products, and q and dO (k and v)
// read once per 64 keys (query rows) through L2.
//
// float32 (flash_bwd_dq, flash_bwd_dkdv): float32 tiles and sums on the
// CUDA cores, as first ported; the float32 tolerance (1e-4) rules out
// bfloat16 or TF32 products. Past D = 128 the tiles walk D in chunks of
// 128 columns (see kChunk).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "lm_mma.cuh"
#include "lm_tiles.cuh"

namespace {

constexpr int kRows = 64;  // query rows per block
constexpr int kKeys = 64;  // keys per tile

// the TPU kernel's key limit of query row qp (0 past the last row)
__device__ __forceinline__ int key_limit(int qp, int L, int causal, int tq,
                                         int tk) {
  if (qp >= L) return 0;
  if (!causal) return L;
  const int up = min(max((qp / tq + 1) * tq / tk, 1), L / tk);
  return min(qp + 1, up * tk);
}

// the lower key limit of query row qp under a sliding window (0 without
// one): the window's own, qp - window + 1, and the reference's chunk
// bound, which reads KV tiles from max(qp / tq - window / tk, 0) on (tq
// == tk). Like key_limit it does not decrease with the row, and it is at
// most qp, so every row keeps its own key.
__device__ __forceinline__ int key_lower(int qp, int window, int tq, int tk) {
  if (window <= 0) return 0;
  return max(qp - window + 1, max(qp / tq - window / tk, 0) * tk);
}

size_t smem_bytes(int dd) {
  return sizeof(float) * (static_cast<size_t>(kRows) * (dd + 1)  // Qs
                          + static_cast<size_t>(dd) * kKeys      // Ks^T
                          + static_cast<size_t>(kKeys) * dd      // Vs
                          + kRows * (kKeys + 1)                  // Ps
                          + 3 * kRows)                           // m, l, c
         + sizeof(int) * 2 * kRows;                              // klo, klim
}

// CM: the output columns a thread owns, 16 apart (8 for D <= 128, 16 for
// D <= 256)
template <typename T, int CM>
__global__ void __launch_bounds__(lm::kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int L, int D, int dd, int causal,
              int tq, int tk, int window, float scale) {
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
  int* klo = klim + kRows;

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
    klim[tid] = key_limit(qp, L, causal, tq, tk);
    klo[tid] = key_lower(qp, window, tq, tk);
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  __syncthreads();
  // neither key limit decreases with the row: the block's last row has the
  // largest upper one, its first row the smallest lower one
  const int kend = klim[min(kRows, L - q0) - 1];
  const int kbeg = klo[0] / kKeys * kKeys;
  const int cm = dd / 16;

  float acc[4][CM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kKeys) {
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
        Ps[r * lp + c] =
            k0 + c < klim[r] && k0 + c >= klo[r] ? s[i][j] : -INFINITY;
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
      for (int j = 0; j < CM; ++j) acc[i][j] *= c;
    }
    lm::mm_acc<4, CM>(acc, Ps, lp, Vs, dd, kKeys, 4, cm, ty, tx);
    __syncthreads();
  }

  if (lse != nullptr && tid < kRows && q0 + tid < L)
    lse[static_cast<size_t>(bh) * L + q0 + tid] =
        mrow[tid] + logf(fmaxf(lrow[tid], 1e-30f));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= L) continue;
    const float den = fmaxf(lrow[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      const int d = tx + 16 * j;
      if (j < cm && d < D)
        o[base + static_cast<size_t>(q0 + r) * D + d] =
            lm::from_f32<T>(acc[i][j] / den);
    }
  }
}

// ---------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU's approximation (lm_mma.cuh; subnormal results flush to
// 0: a P so far below the row's largest, 1, adds nothing to its sums),
// and the compile-time loop that keeps k-step offsets immediate
using lm::ex2;
using lm::static_for;

// d (64 x D float32 over the warpgroup) += A (64 x 16, registers) B (16 x
// D, N-major in shared memory: transposed B) at the build's width
template <int D, int OB>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint32_t b_lo, uint32_t hi) {
  if constexpr (D == 256)
    lm::wgmma_m64n256k16_rs_tb<OB>(d, a, b_lo, hi);
  else if constexpr (D == 192)
    lm::wgmma_m64n192k16_rs_tb<OB>(d, a, b_lo, hi);
  else if constexpr (D == 128)
    lm::wgmma_m64n128k16_rs_tb<OB>(d, a, b_lo, hi);
  else
    lm::wgmma_m64n64k16_rs_tb<OB>(d, a, b_lo, hi);
}

// flash_fwd_wgmma<D> (D 64, 128, 192, 256): 128 query rows a block, two
// warpgroups of 64. q (128 x D, once) and 64-key tiles of k and v (two
// rings of kStages) come by TMA in 64-column boxes with the 128-byte
// swizzle, each tile completing on its slot's mbarrier; the warpgroup
// that frees a slot second requests the tile kStages on into it. Each
// warpgroup runs S = q k^T (wgmma m64n64k16, both operands from shared
// memory) and O += P v (wgmma m64nDk16, P from registers, v transposed
// B). See the header.
constexpr int kWgRows = 128;     // query rows a block
// Two warpgroups and no producer warp: ptxas gives a wgmma kernel's
// threads 65,536 registers over whole warpgroups, so a third (a
// producer warpgroup, or one producer warp) caps them at 168, and at D
// 256 it spilled there even with the producer's setmaxnreg 24 and the
// consumers' 240. At 256 threads the 64 x D float32 sums, S and P take
// about 215 registers (D 256) and 184 (D 192), no spill. At D <= 128 a
// third warpgroup fits under 168 but measured no faster (at D 64,
// slower).
constexpr int kWgThreads = 256;
constexpr int kBox = 64;         // columns a TMA box: 128 bytes

template <int D>
struct WgmmaTiles {
  static constexpr int kBoxes = D / kBox;
  static constexpr uint32_t kQBox = kWgRows * kBox * 2;      // 16 KB
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kKvBox = kKeys * kBox * 2;       // 8 KB
  static constexpr uint32_t kTileBytes = kBoxes * kKvBox;    // k or v
  // 2 at D <= 128 (the deepest that fit, 13 slots at D 64 and 6 at 128,
  // measured no faster at D 128 and far slower at D 64: a block's
  // prologue requests every slot); above, as deep as 227 KB allows: 2 at
  // D 256, 3 at D 192
  static constexpr int kStages =
      D <= 128 ? 2
               : (227 * 1024 - 1024 - kQBytes - 256) / (2 * kTileBytes);
  // q's barrier, each slot's full barrier and its count of releases
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages) +
      4 * 2 * kStages;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    bf16* __restrict__ o, float* __restrict__ lse, int L,
                    int Dr, int causal, int tq, int tk, int window,
                    float scale_log2) {
  using T = WgmmaTiles<D>;
  constexpr int S = T::kStages, NB = T::kBoxes, NO = D / 2, KS = D / 16;
  static_assert(D % kBox == 0, "no such build");
  static_assert(S >= 2 && T::kSmem <= 227 * 1024, "the ring does not fit");
  // the turns between the warpgroups (past D 128; see below)
  constexpr bool kTurns = D > 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the tiles to it
  const uint32_t qs = (lm::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + T::kQBytes;        // [S][NB][64 keys][64]
  const uint32_t vs = ks + S * T::kTileBytes;  // [S][NB][64 keys][64]
  const uint32_t q_full = vs + S * T::kTileBytes;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * S;
  int* k_done = reinterpret_cast<int*>(
      smem_raw + (v_full + 8 * S - lm::smem_u32(smem_raw)));  // [S]
  int* v_done = k_done + S;                                 // [S]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows;  // heaviest first
  // neither key limit decreases with the row: the block's last row has
  // the largest upper one, its first row the smallest lower one
  const int kend = key_limit(min(q0 + kWgRows, L) - 1, L, causal, tq, tk);
  const int kbeg = key_lower(q0, window, tq, tk) / kKeys * kKeys;
  const int n_tiles = (kend - kbeg + kKeys - 1) / kKeys;
  // tile j of k or v into its slot; rows and keys past L (and columns
  // past Dr) come zero-filled, never the next head's
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                  int j) {
    const int s = j % S;
    // after both warpgroups' wgmma reads of the slot (their waits, then
    // the release counts) and before TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    lm::mbar_expect_tx(full + 8 * s, T::kTileBytes);
    for (int b = 0; b < NB; ++b)
      lm::tma_load_3d(ring + s * T::kTileBytes + b * T::kKvBox, map,
                      full + 8 * s, b * kBox, kbeg + j * kKeys, bh);
  };
  if (threadIdx.x == 0) {
    lm::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      lm::mbar_init(k_full + 8 * s, 1);
      lm::mbar_init(v_full + 8 * s, 1);
      k_done[s] = v_done[s] = 0;
    }
    lm::mbar_fence_init();
    lm::mbar_expect_tx(q_full, T::kQBytes);
    for (int b = 0; b < NB; ++b)
      lm::tma_load_3d(qs + b * T::kQBox, &map_q, q_full, b * kBox, q0, bh);
    for (int j = 0; j < min(S, n_tiles); ++j) {
      load(&map_k, ks, k_full, j);
      load(&map_v, vs, v_full, j);
    }
  }
  __syncthreads();

  const int c = threadIdx.x / 128;  // this warpgroup's rows: q0 + 64 c..
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row = q0 + 64 * c + warp * 16 + g;  // this thread's: row, + 8
  const int lim_lo = key_limit(row, L, causal, tq, tk);
  const int lim_hi = key_limit(row + 8, L, causal, tq, tk);
  const int lo_lo = key_lower(row, window, tq, tk);
  const int lo_hi = key_lower(row + 8, window, tq, tk);
  const bool leader = threadIdx.x % 128 == 0;
  // the warpgroup is done with tile j of k or v: its leader counts the
  // release, and the second of a slot's two (an odd count before it)
  // requests tile j + S into the slot (no slot is refilled under a
  // transfer in flight: both waited for the tile)
  auto release_k = [&](int j) {
    if (leader && (atomicAdd(&k_done[j % S], 1) & 1) && j + S < n_tiles)
      load(&map_k, ks, k_full, j + S);
  };
  auto release_v = [&](int j) {
    if (leader && (atomicAdd(&v_done[j % S], 1) & 1) && j + S < n_tiles)
      load(&map_v, vs, v_full, j + S);
  };

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float sc[32];       // S, then P in float32: d[4 n + e], 8 n8 tiles
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  uint32_t pa[4][4];  // P in bfloat16, the A fragments of 4 k16 steps
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float c_lo = 0.f, c_hi = 0.f;
  // descriptors: q's 64 rows of this warpgroup in each box (K-major), k's
  // tile (K-major, its 64 rows of keys as B's N), v's tile (N-major: LBO
  // steps a 64-column box, SBO 8 keys); a k-step's offset is immediate
  const uint32_t hi = lm::desc_hi_sw128(1024);
  const uint32_t q_lo = lm::desc_lo(qs + c * 64 * 128, 16);
  auto issue_s = [&](int j) {  // S = q k^T, D / 16 k-steps
    const uint32_t k_lo = lm::desc_lo(ks + j % S * T::kTileBytes, 16);
    static_for<KS>([&](auto step) {  // 32 bytes a k-step within a box
      constexpr int kk = decltype(step)::value;
      lm::wgmma_m64n64k16_ss<(kk / 4 * T::kQBox + kk % 4 * 32) / 16,
                             (kk / 4 * T::kKvBox + kk % 4 * 32) / 16>(
          sc, q_lo, k_lo, hi, kk > 0);
    });
    lm::wgmma_commit();
  };
  auto issue_pv = [&](int j) {  // O += P v, 4 k-steps of 16 keys
    const uint32_t v_lo = lm::desc_lo(vs + j % S * T::kTileBytes, T::kKvBox);
    static_for<4>([&](auto step) {  // 16 rows of 128 bytes a k-step
      constexpr int kk = decltype(step)::value;
      wgmma_rs_tb<D, kk * 2048 / 16>(acc, pa[kk], v_lo, hi);
    });
    lm::wgmma_commit();
  };
  // the mask (only on a tile that crosses a row's limit), the running max
  // and the corrections c; S becomes float32 P against the new max, and
  // the denominators take its sums (maxima and sums as trees: short
  // dependence chains between the products)
  auto softmax = [&](int j) {
    const int k0 = kbeg + j * kKeys;
    if (k0 + kKeys > lim_lo || k0 < lo_hi) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * n + 2 * t4 + e;
          if (key >= lim_lo || key < lo_lo) sc[4 * n + e] = -INFINITY;
          if (key >= lim_hi || key < lo_hi) sc[4 * n + 2 + e] = -INFINITY;
        }
    }
    float t_lo[8], t_hi[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      t_lo[n] = fmaxf(sc[4 * n], sc[4 * n + 1]);
      t_hi[n] = fmaxf(sc[4 * n + 2], sc[4 * n + 3]);
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) {
        t_lo[n] = fmaxf(t_lo[n], t_lo[n + w]);
        t_hi[n] = fmaxf(t_hi[n], t_hi[n + w]);
      }
    float mx_lo = fmaxf(m_lo, t_lo[0]), mx_hi = fmaxf(m_hi, t_hi[0]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // exponent bases; a row with no key yet (past L) keeps 0
    const float b_lo = mx_lo == -INFINITY ? 0.f : mx_lo * scale_log2;
    const float b_hi = mx_hi == -INFINITY ? 0.f : mx_hi * scale_log2;
    c_lo = ex2(m_lo * scale_log2 - b_lo);
    c_hi = ex2(m_hi * scale_log2 - b_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale_log2, -b_lo));
        sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], scale_log2, -b_hi));
      }
      t_lo[n] = sc[4 * n] + sc[4 * n + 1];
      t_hi[n] = sc[4 * n + 2] + sc[4 * n + 3];
    }
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) {
        t_lo[n] += t_lo[n + w];
        t_hi[n] += t_hi[n + w];
      }
    l_lo = fmaf(l_lo, c_lo, t_lo[0]);
    l_hi = fmaf(l_hi, c_hi, t_hi[0]);
  };
  auto pack = [&]() {  // k16 step kk: the n8 tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        pa[kk][h] = lm::pack_bf16x2(sc[8 * kk + 2 * h],
                                    sc[8 * kk + 2 * h + 1]);
  };

  // Both warpgroups walk every tile of the block (a row's keys outside
  // its limits are masked; rows past L write nothing). Past D 128 they
  // take turns to issue their products (named barriers 1 and 2, the
  // first warpgroup first): one's softmax runs under the other's
  // products; at D <= 128, whose products are shorter beside the same
  // softmax, the turns measured slower and they issue at will. Within a
  // warpgroup, S of tile j is issued beside P v of tile j - 1, and the
  // softmax of tile j runs under the latter.
  const int mine = 1 + c, other = 2 - c;
  if (kTurns && c == 1) lm::bar_arrive(other, 256);
  lm::mbar_wait(q_full, 0);
  lm::mbar_wait(k_full, 0);
  if (kTurns) lm::bar_sync(mine, 256);
  lm::wgmma_fence();
  issue_s(0);
  if (kTurns) lm::bar_arrive(other, 256);
  lm::wgmma_wait<0>();
  lm::fence_regs(sc);
  release_k(0);
  softmax(0);  // O is 0: nothing to correct
  pack();
  for (int j = 1; j < n_tiles; ++j) {
    const int sp = (j - 1) % S;
    lm::mbar_wait(k_full + 8 * (j % S), (j / S) & 1);
    lm::mbar_wait(v_full + 8 * sp, ((j - 1) / S) & 1);
    lm::fence_regs(acc);
    lm::fence_regs(sc);
    lm::fence_regs(pa);
    if (kTurns) lm::bar_sync(mine, 256);
    lm::wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    if (kTurns) lm::bar_arrive(other, 256);
    lm::wgmma_wait<1>();  // S of tile j
    lm::fence_regs(sc);
    release_k(j);
    softmax(j);
    lm::wgmma_wait<0>();  // P v of tile j - 1
    lm::fence_regs(acc);
    lm::fence_regs(pa);
    release_v(j - 1);
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      acc[4 * n] *= c_lo;
      acc[4 * n + 1] *= c_lo;
      acc[4 * n + 2] *= c_hi;
      acc[4 * n + 3] *= c_hi;
    }
    pack();
  }
  const int last = n_tiles - 1, sl = last % S;
  lm::mbar_wait(v_full + 8 * sl, (last / S) & 1);
  lm::fence_regs(acc);
  lm::fence_regs(pa);
  if (kTurns) lm::bar_sync(mine, 256);
  lm::wgmma_fence();
  issue_pv(last);
  if (kTurns && c == 0) lm::bar_arrive(other, 256);  // the second's last turn
  lm::wgmma_wait<0>();
  lm::fence_regs(acc);
  lm::fence_regs(pa);
  release_v(last);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  // log-sum-exp of the scaled scores, natural log: the exponents are base
  // 2 with the base m * scale * log2 e
  if (lse != nullptr && t4 == 0) {
    const size_t row0 = static_cast<size_t>(bh) * L;
    if (row < L)
      lse[row0 + row] = (m_lo * scale_log2 + log2f(den_lo)) * kLn2;
    if (row + 8 < L)
      lse[row0 + row + 8] = (m_hi * scale_log2 + log2f(den_hi)) * kLn2;
  }
  bf16* ob = o + static_cast<size_t>(bh) * L * Dr;
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int d = 8 * n + 2 * t4;  // Dr % 8 == 0: the pair is whole
    if (d >= Dr) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const float den = h ? den_hi : den_lo;
      if (r < L)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r) * Dr +
                                     d) =
            lm::pack_bf16x2(acc[4 * n + 2 * h] / den,
                            acc[4 * n + 2 * h + 1] / den);
    }
  }
}

// Dr: q, k, v and o's row width, a multiple of 8 (TMA's 16-byte row
// strides) and at most D; the wrapper zero-pads a head dim to it
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int bh, int L, int Dr, int causal, int tq,
                 int tk, int window, float scale, cudaStream_t stream) {
  if (Dr % 8 || Dr > D || bh > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v;
  using T = WgmmaTiles<D>;
  if (!lm::make_head_map(&map_q, q, Dr, L, bh, kWgRows) ||
      !lm::make_head_map(&map_k, k, Dr, L, bh, kKeys) ||
      !lm::make_head_map(&map_v, v, Dr, L, bh, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = lm::allow_smem(flash_fwd_wgmma<D>, T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((L + kWgRows - 1) / kWgRows, bh);
  flash_fwd_wgmma<D><<<grid, kWgThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), lse, L, Dr, causal, tq,
      tk, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// every bfloat16 head dim runs flash_fwd_wgmma: the wrapper's row width
// Dr (1-256, a multiple of 8) at the build of 64, 128, 192 or 256
// columns that holds it, TMA zero-filling the rest
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int L, int D, int causal, int tq, int tk,
                int window, float scale, cudaStream_t s) {
#define FWD_WGMMA(DW)                                                     \
  return launch_wgmma<DW>(q, k, v, o, lse, bh, L, D, causal, tq, tk,     \
                          window, scale, s)
  if (D <= 64) FWD_WGMMA(64);
  if (D <= 128) FWD_WGMMA(128);
  if (D <= 192) FWD_WGMMA(192);
  FWD_WGMMA(256);
#undef FWD_WGMMA
}

// ---------------------------------------------------------------- f32
template <int CM>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int L, int D, int causal, int tq,
                   int tk, int window, float scale, cudaStream_t stream) {
  const int dd = (D + 15) / 16 * 16;
  const size_t smem = smem_bytes(dd);  // 214 KB at D = 256
  cudaError_t e = lm::allow_smem(flash_fwd<float, CM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (L + kRows - 1) / kRows);
  flash_fwd<float, CM><<<grid, lm::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, L, D, dd,
      causal, tq, tk, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int L, int D, int causal, int tq, int tk,
               int window, float scale, cudaStream_t s) {
  if (D <= 128)
    return launch_fwd_f32<8>(q, k, v, o, lse, bh, L, D, causal, tq, tk,
                             window, scale, s);
  return launch_fwd_f32<16>(q, k, v, o, lse, bh, L, D, causal, tq, tk,
                            window, scale, s);
}

// ---------------------------------------------------------------- backward
// float32: flash_bwd_dq and flash_bwd_dkdv on the CUDA cores. Blocks of
// 256 threads as a 16 x 16 grid (ty, tx);
// a thread owns the score elements (ty + 16 i, tx + 16 j), i, j < 4, and
// the output elements (ty + 16 i, tx + 16 j), j < dd / 16. Tiles are
// float32 in shared memory in rows of dd + 1 (odd: a warp's column reads
// fall in distinct banks).
constexpr int kTile = 64;        // query rows or keys a block, keys a tile
constexpr int kPad = kTile + 1;  // the score tiles' row stride

// acc[i][j] += sum_k A[(ty + 16 i) a_r + k a_k] B[k b_k + (tx + 16 j) b_n]
// over k < kdim, for j < cm.
template <int RM, int CM>
__device__ __forceinline__ void mm_strided(float (&acc)[RM][CM],
                                           const float* A, int a_r, int a_k,
                                           const float* B, int b_k, int b_n,
                                           int kdim, int cm, int ty, int tx) {
  for (int kk = 0; kk < kdim; ++kk) {
    float a[RM], b[CM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty + 16 * i) * a_r + kk * a_k];
#pragma unroll
    for (int j = 0; j < CM; ++j)
      b[j] = j < cm ? B[kk * b_k + (tx + 16 * j) * b_n] : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

constexpr int kChunk = 128;       // D columns a float32 tile holds

// rows [r0, r0 + 64) and columns [c0, c0 + wc) of a (L, D) matrix into a
// float32 [64][ld] tile, zeros past L and D
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int r0, int L, int D, int c0,
                                          int wc) {
  for (int idx = threadIdx.x; idx < kTile * wc; idx += lm::kThreads) {
    const int r = idx / wc, d = idx % wc;
    dst[r * ld + d] =
        r0 + r < L && c0 + d < D
            ? lm::to_f32(src[static_cast<size_t>(r0 + r) * D + c0 + d])
            : 0.f;
  }
}

// four [64][dc + 1] operand tiles, the score tiles, lse, D and the key
// limits (dc = min(dd, kChunk): 166 KB for the dK/dV pass at D >= 128)
size_t bwd_smem_bytes(int dc, int score_tiles) {
  return sizeof(float) * (4 * static_cast<size_t>(kTile) * (dc + 1) +
                          static_cast<size_t>(score_tiles) * kTile * kPad +
                          2 * kTile) +
         sizeof(int) * 2 * kTile;
}

// Past D = 128 the operand tiles of a float32 backward block do not fit
// in shared memory whole, so both passes walk D in chunks of kChunk
// columns: the scores S and dP sum over every chunk, in the column order
// of a single walk (the same float32 sums), and block z of the grid's
// third dimension forms only the output columns of chunk z (recomputing
// S and dP, which every chunk needs). With D <= 128 there is one chunk,
// loaded once.

// dQ of 64 query rows (the columns of chunk blockIdx.z): walks the KV
// tiles between the block's smallest lower and largest upper key limit;
// block z = 0 also writes D = rowsum(dO o) of its rows for flash_bwd_dkdv.
template <typename T>
__global__ void __launch_bounds__(lm::kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, float* __restrict__ dsum, int L, int D,
                 int dd, int causal, int tq, int tk, int window,
                 float scale) {
  extern __shared__ __align__(16) float sm[];
  const int dc = min(dd, kChunk), ld = dc + 1, nch = (dd + dc - 1) / dc;
  float* Qs = sm;               // [kTile][ld]
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ss = Vs + kTile * ld;  // dS, [kTile][kPad]
  float* lse_s = Ss + kTile * kPad;
  float* D_s = lse_s + kTile;
  int* klim = reinterpret_cast<int*>(D_s + kTile);
  int* klo = klim + kTile;

  const int bh = blockIdx.x, z = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t row0 = static_cast<size_t>(bh) * L;
  auto width = [&](int c) { return min(dd - c * dc, dc); };

  if (nch == 1) {
    load_tile(Qs, ld, q + base, q0, L, D, 0, dc);
    load_tile(dOs, ld, dout + base, q0, L, D, 0, dc);
  }
  {  // D = rowsum(dO o), four threads a row
    const int r = tid >> 2, part = tid & 3, qp = q0 + r;
    float acc = 0.f;
    if (qp < L)
      for (int d = part; d < D; d += 4) {
        const size_t off = base + static_cast<size_t>(qp) * D + d;
        acc = fmaf(lm::to_f32(dout[off]), lm::to_f32(o[off]), acc);
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      D_s[r] = acc;
      if (qp < L && z == 0) dsum[row0 + qp] = acc;
    }
  }
  if (tid < kTile) {
    const int qp = q0 + tid;
    klim[tid] = key_limit(qp, L, causal, tq, tk);
    klo[tid] = key_lower(qp, window, tq, tk);
    lse_s[tid] = qp < L ? lse[row0 + qp] : 0.f;
  }
  __syncthreads();
  const int kend = klim[min(kTile, L - q0) - 1];
  const int kbeg = klo[0] / kTile * kTile;
  const int cm = width(z) / 16;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kTile) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int wc = width(c);
      if (nch > 1) {
        load_tile(Qs, ld, q + base, q0, L, D, c * dc, wc);
        load_tile(dOs, ld, dout + base, q0, L, D, c * dc, wc);
      }
      load_tile(Ks, ld, k + base, k0, L, D, c * dc, wc);
      load_tile(Vs, ld, v + base, k0, L, D, c * dc, wc);
      __syncthreads();
      mm_strided<4, 4>(s, Qs, ld, 1, Ks, 1, ld, wc, 4, ty, tx);   // q k^T
      mm_strided<4, 4>(dp, dOs, ld, 1, Vs, 1, ld, wc, 4, ty, tx); // dO v^T
      if (c + 1 < nch) __syncthreads();  // the chunk's tiles are refilled
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = k0 + c < klim[r] && k0 + c >= klo[r]
                            ? expf(fmaf(s[i][j], scale, -lse_s[r]))
                            : 0.f;
        Ss[r * kPad + c] = p * (dp[i][j] - D_s[r]);
      }
    __syncthreads();
    if (z != nch - 1) {  // Ks holds the last chunk: reload chunk z
      load_tile(Ks, ld, k + base, k0, L, D, z * dc, width(z));
      __syncthreads();
    }
    mm_strided<4, 8>(acc, Ss, kPad, 1, Ks, ld, 1, kTile, cm, ty, tx);
    __syncthreads();  // Ks, Vs and Ss are refilled next
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = z * dc + tx + 16 * j;
      if (j < cm && d < D)
        dq[base + static_cast<size_t>(q0 + r) * D + d] =
            lm::from_f32<T>(acc[i][j] * scale);
    }
  }
}

// dK and dV of 64 keys (the columns of chunk blockIdx.z): walks exactly
// the query tiles some row of which reads one of these keys (neither key
// limit decreases with the row, so the tiles from the first whose last
// row's upper limit passes k0 to the last whose first row's lower limit
// is below k0 + 64).
template <typename T>
__global__ void __launch_bounds__(lm::kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, T* __restrict__ dk,
                   T* __restrict__ dv, int L, int D, int dd, int causal,
                   int tq, int tk, int window, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int dc = min(dd, kChunk), ld = dc + 1, nch = (dd + dc - 1) / dc;
  float* Ks = sm;               // [kTile][ld]: this block's keys
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;  // a query tile
  float* dOs = Qs + kTile * ld;
  float* Ps = dOs + kTile * ld;  // P^T, [kTile keys][kPad]
  float* Ss = Ps + kTile * kPad;  // dS^T
  float* lse_s = Ss + kTile * kPad;
  float* D_s = lse_s + kTile;
  int* klim = reinterpret_cast<int*>(D_s + kTile);
  int* klo = klim + kTile;

  const int bh = blockIdx.x, k0 = blockIdx.y * kTile, z = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const size_t row0 = static_cast<size_t>(bh) * L;
  auto width = [&](int c) { return min(dd - c * dc, dc); };
  const int cm = width(z) / 16;

  if (nch == 1) {
    load_tile(Ks, ld, k + base, k0, L, D, 0, dc);
    load_tile(Vs, ld, v + base, k0, L, D, 0, dc);
  }
  const int n_qt = (L + kTile - 1) / kTile;
  int first = 0, last = n_qt - 1;
  while (first < n_qt &&
         key_limit(min((first + 1) * kTile, L) - 1, L, causal, tq, tk) <= k0)
    ++first;
  while (last >= first &&
         key_lower(last * kTile, window, tq, tk) >= k0 + kTile)
    --last;

  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int t = first; t <= last; ++t) {
    const int i0 = t * kTile;
    if (tid < kTile) {
      const int qp = i0 + tid;
      klim[tid] = key_limit(qp, L, causal, tq, tk);
      klo[tid] = key_lower(qp, window, tq, tk);
      lse_s[tid] = qp < L ? lse[row0 + qp] : 0.f;
      D_s[tid] = qp < L ? dsum[row0 + qp] : 0.f;
    }
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int wc = width(c);
      if (nch > 1) {
        load_tile(Ks, ld, k + base, k0, L, D, c * dc, wc);
        load_tile(Vs, ld, v + base, k0, L, D, c * dc, wc);
      }
      load_tile(Qs, ld, q + base, i0, L, D, c * dc, wc);
      load_tile(dOs, ld, dout + base, i0, L, D, c * dc, wc);
      __syncthreads();
      mm_strided<4, 4>(s, Ks, ld, 1, Qs, 1, ld, wc, 4, ty, tx);   // k q^T
      mm_strided<4, 4>(dp, Vs, ld, 1, dOs, 1, ld, wc, 4, ty, tx); // v dO^T
      if (c + 1 < nch) __syncthreads();  // the chunk's tiles are refilled
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = ty + 16 * a, i = tx + 16 * b;
        const float p = k0 + j < klim[i] && k0 + j >= klo[i]
                            ? expf(fmaf(s[a][b], scale, -lse_s[i]))
                            : 0.f;
        Ps[j * kPad + i] = p;
        Ss[j * kPad + i] = p * (dp[a][b] - D_s[i]);
      }
    __syncthreads();
    if (z != nch - 1) {  // Qs, dOs hold the last chunk: reload chunk z
      load_tile(Qs, ld, q + base, i0, L, D, z * dc, width(z));
      load_tile(dOs, ld, dout + base, i0, L, D, z * dc, width(z));
      __syncthreads();
    }
    mm_strided<4, 8>(acc_v, Ps, kPad, 1, dOs, ld, 1, kTile, cm, ty, tx);
    mm_strided<4, 8>(acc_k, Ss, kPad, 1, Qs, ld, 1, kTile, cm, ty, tx);
    __syncthreads();  // the query tile and the score tiles are refilled next
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = ty + 16 * a;
    if (k0 + j >= L) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = z * dc + tx + 16 * c;
      if (c < cm && d < D) {
        const size_t off = base + static_cast<size_t>(k0 + j) * D + d;
        dk[off] = lm::from_f32<T>(acc_k[a][c] * scale);
        dv[off] = lm::from_f32<T>(acc_v[a][c]);
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* dsum, int bh, int L, int D, int causal,
               int tq, int tk, int window, float scale,
               cudaStream_t stream) {
  const int dd = (D + 15) / 16 * 16, dc = dd < kChunk ? dd : kChunk;
  const size_t smem_dq = bwd_smem_bytes(dc, 1);
  const size_t smem_dkdv = bwd_smem_bytes(dc, 2);
  cudaError_t e = lm::allow_smem(flash_bwd_dq<T>, smem_dq);
  if (e == cudaSuccess) e = lm::allow_smem(flash_bwd_dkdv<T>, smem_dkdv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (L + kTile - 1) / kTile, (dd + dc - 1) / dc);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq<T><<<grid, lm::kThreads, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq),
      dsum, L, D, dd, causal, tq, tk, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv<T><<<grid, lm::kThreads, smem_dkdv, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      L, D, dd, causal, tq, tk, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- backward, bf16
// flash_bwd_dq_wgmma<D> then flash_bwd_dkdv_wgmma<D> (D 64, 128, 192,
// 256): Hopper's wgmma and TMA, two warpgroups a block, 64-row tiles in
// 64-column boxes with the 128-byte swizzle through the forward's 3-D
// head maps. See the header.
constexpr float kLog2e = 1.4426950408889634f;
// k and v of every head (bytes) up to which the grid runs heads fastest
constexpr double kHeadsFastBytes = 40.0 * (1 << 20);

template <int D>
struct BwdTiles {
  // At D <= 128 each warpgroup owns 64 of a block's 128 query rows (dQ)
  // or keys (dK/dV) and runs the whole chain on them. Past 128 the sums
  // do not fit beside S and dP: a block owns 64, and its dQ pass's
  // warpgroups split each tile's keys, its dK/dV pass's the roles.
  static constexpr bool kNarrow = D <= 128;
  static constexpr int kDqRows = kNarrow ? 128 : 64;  // query rows a block
  static constexpr int kKvKeys = kNarrow ? 128 : 64;  // keys a block
  static constexpr int kBoxes = D / kBox;
  static constexpr uint32_t kBoxBytes = kRows * kBox * 2;      // 8 KB
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;   // 64 x D
  static constexpr uint32_t kQBytes = kDqRows / 64 * kTileBytes;  // q, dO
  static constexpr uint32_t kKBytes = kKvKeys / 64 * kTileBytes;  // k, v
  // P^T, which the role split hands between its warpgroups
  static constexpr uint32_t kPBytes = kKvKeys == 64 ? kRows * kKeys * 4 : 0;
  // each query's lse log2 e, D and its two key limits
  static constexpr uint32_t kColBytes = 4 * kRows * 4;
  static constexpr size_t kBars = 1024;  // barriers, counts, D of the rows
  static constexpr size_t kMax = 227 * 1024 - 1024 - kBars;
  // dQ: q and dO once, v in a ring of kDqV slots (2 at D <= 128 and D
  // 256, 3 at D 192) and k, held a tile longer (dS k runs beside the next
  // tile's S), in one of kDqK (one more)
  static constexpr int kDqV =
      kNarrow ? 2 : (kMax - 2 * kQBytes) / (2 * kTileBytes);
  static constexpr int kDqK =
      kNarrow ? kDqV + 1
              : (kMax - 2 * kQBytes - kDqV * kTileBytes) / kTileBytes;
  static constexpr size_t kDqSmem =
      1024 + 2 * kQBytes + (kDqK + kDqV) * kTileBytes + kBars;
  // dK/dV: k and v once, q, dO and the queries' lse, D and key limits in
  // a ring of kKvStages (4 at D <= 128, 2 at D 256, 3 at D 192). At D <=
  // 128 a slot is held from its tile's S^T to the next tile's dK and dV:
  // with 2 its refill had no time to land (Whisper's backward 2.48 ms,
  // 2.21 with 4; scripts/flash_bwd_ablate.py)
  static constexpr int kKvStages =
      kNarrow ? 4
              : (kMax - 2 * kKBytes - kPBytes) /
                    (2 * kTileBytes + kColBytes);
  static constexpr size_t kKvSmem = 1024 + 2 * kKBytes +
                                    kKvStages * (2 * kTileBytes + kColBytes) +
                                    kPBytes + kBars;
};

// k-step kk (16 columns of D) of a K-major 64 x D tile in 64-column boxes:
// its offset in 16-byte units, an immediate of the wgmma
template <int D, int KK>
__host__ __device__ constexpr int kstep_offset() {
  return (KK / 4 * BwdTiles<D>::kBoxBytes + KK % 4 * 32) / 16;
}

// dQ of a block's query rows, and D = rowsum(dO o) of them for the dK/dV
// pass. At D <= 128 the block owns 128 rows and warpgroup c rows 64 c..,
// over every key of each 64-key tile the block reaches: S = q k^T and dP =
// dO v^T (wgmma m64n64k16, both operands from shared memory). Past 128
// the block owns 64 rows and warpgroup c keys 32 c.. of every tile
// (m64n32k16), each with a sum of its own, the two added once at the end
// in a fixed order. Either way P and dS are float32 registers, dS rounded
// to bfloat16 as the A fragments of dQ += dS k (m64nDk16, k as
// transposed B).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       float* __restrict__ cols, int L, int Dr, int causal,
                       int tq, int tk, int window, int heads_fast,
                       float scale_log2, float scale) {
  using T = BwdTiles<D>;
  constexpr bool kN = T::kDqRows == 128;  // a warpgroup's own rows
  constexpr int R = T::kDqRows, SK = T::kDqK, SV = T::kDqV;
  constexpr int NB = T::kBoxes, NO = D / 2, KS = D / 16;
  // a warpgroup's keys of a tile, S's (and dP's) registers, dS's k-steps
  constexpr int KW = kN ? kKeys : kKeys / 2, NS = KW / 2, NK = KW / 16;
  static_assert(SV >= 2 && SK > SV && T::kDqSmem <= 227 * 1024,
                "the rings do not fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = lm::smem_u32(smem_raw);
  const uint32_t qs = (base + 1023u) & ~1023u;  // [R / 64][NB][64][64]
  const uint32_t dos = qs + T::kQBytes;
  const uint32_t ks = dos + T::kQBytes;           // [SK][NB][64 keys][64]
  const uint32_t vs = ks + SK * T::kTileBytes;    // [SV][NB][64 keys][64]
  const uint32_t q_full = vs + SV * T::kTileBytes;  // q and dO
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * SK;
  int* k_done = reinterpret_cast<int*>(smem_raw + (v_full + 8 * SV - base));
  int* v_done = k_done + SK;
  float* Ds = reinterpret_cast<float*>(v_done + SV);  // [R]

  const int bh = heads_fast ? blockIdx.x : blockIdx.y;
  const int blk = heads_fast ? blockIdx.y : blockIdx.x;
  const int n_blk = heads_fast ? gridDim.y : gridDim.x;
  const int q0 = (n_blk - 1 - blk) * R;  // heaviest first
  const size_t row0 = static_cast<size_t>(bh) * L;
  // neither key limit decreases with the row: the block's last row has
  // the largest upper one, its first row the smallest lower one
  const int kend = key_limit(min(q0 + R, L) - 1, L, causal, tq, tk);
  const int kbeg = key_lower(q0, window, tq, tk) / kKeys * kKeys;
  const int n_tiles = (kend - kbeg + kKeys - 1) / kKeys;  // at least 1
  // tile j of k or v into its slot of a ring of S; keys past L (and
  // columns past Dr) come zero-filled, never the next head's
  auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                  int S, int j) {
    const int s = j % S;
    // after both warpgroups' wgmma reads of the slot, before TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    lm::mbar_expect_tx(full + 8 * s, T::kTileBytes);
    for (int b = 0; b < NB; ++b)
      lm::tma_load_3d(ring + s * T::kTileBytes + b * T::kBoxBytes, map,
                      full + 8 * s, b * kBox, kbeg + j * kKeys, bh);
  };
  if (threadIdx.x == 0) {
    lm::mbar_init(q_full, 1);
    for (int s = 0; s < SK; ++s) {
      lm::mbar_init(k_full + 8 * s, 1);
      k_done[s] = 0;
    }
    for (int s = 0; s < SV; ++s) {
      lm::mbar_init(v_full + 8 * s, 1);
      v_done[s] = 0;
    }
    lm::mbar_fence_init();
    // the 64-row tiles of q and dO that hold a row below L
    const int halves = R == kRows ? 1 : (min(R, L - q0) + kRows - 1) / kRows;
    lm::mbar_expect_tx(q_full, 2 * halves * T::kTileBytes);
    for (int h = 0; h < halves; ++h)
      for (int b = 0; b < NB; ++b) {
        const uint32_t at = h * T::kTileBytes + b * T::kBoxBytes;
        lm::tma_load_3d(qs + at, &map_q, q_full, b * kBox, q0 + h * kRows,
                        bh);
        lm::tma_load_3d(dos + at, &map_do, q_full, b * kBox, q0 + h * kRows,
                        bh);
      }
    for (int j = 0; j < min(SK, n_tiles); ++j)
      load(&map_k, ks, k_full, SK, j);
    for (int j = 0; j < min(SV, n_tiles); ++j)
      load(&map_v, vs, v_full, SV, j);
  }
  const int c = threadIdx.x / 128;  // rows 64 c.. (D <= 128), or keys 32 c..
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = (kN ? 64 * c : 0) + warp * 16 + g;  // rows r_lo, + 8
  const int row = q0 + r_lo;
  // lse of a row past L is undefined: read as 0, its P masked to 0 (read
  // here, used after D's loop)
  const float lse_lo = row < L ? lse[row0 + row] : 0.f;
  const float lse_hi = row + 8 < L ? lse[row0 + row + 8] : 0.f;
  {  // D = rowsum(dO o) while the tiles land: 256 / R threads a row,
     // 16-byte loads (Dr % 8 == 0, 16-byte aligned rows), 0 past L
    constexpr int TPR = kWgThreads / R;
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR, qp = q0 + r;
    float acc = 0.f;
    if (qp < L) {
      const uint4* a = reinterpret_cast<const uint4*>(dout + (row0 + qp) * Dr);
      const uint4* b = reinterpret_cast<const uint4*>(o + (row0 + qp) * Dr);
      for (int i = part; i < Dr / 8; i += TPR) {
        const uint4 x = a[i], y = b[i];
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 u = __bfloat1622float2(xp[e]);
          const float2 w = __bfloat1622float2(yp[e]);
          acc = fmaf(u.y, w.y, fmaf(u.x, w.x, acc));
        }
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) Ds[r] = acc;
  }
  __syncthreads();

  const int lim_lo = key_limit(row, L, causal, tq, tk);
  const int lim_hi = key_limit(row + 8, L, causal, tq, tk);
  const int lo_lo = key_lower(row, window, tq, tk);
  const int lo_hi = key_lower(row + 8, window, tq, tk);
  const float ls_lo = lse_lo * kLog2e, ls_hi = lse_hi * kLog2e;
  const float D_lo = Ds[r_lo], D_hi = Ds[r_lo + 8];
  // the rows' lse log2 e, D and key limits for the dK/dV pass, in 64-row
  // chunks ([BH][4][Lp], Lp = L rounded up to 64; lse and D 0 past L, and
  // the upper limit 0), which it brings in bulk copies
  const int lp = (L + kRows - 1) / kRows * kRows;
  if ((kN || c == 0) && t4 == 0 && row < lp) {  // row + 8 too: lp % 16 == 0
    float* cb = cols + 4 * static_cast<size_t>(bh) * lp + row;
    cb[0] = ls_lo;
    cb[8] = ls_hi;
    cb[lp] = D_lo;
    cb[lp + 8] = D_hi;
    cb[2 * lp] = __int_as_float(lim_lo);
    cb[2 * lp + 8] = __int_as_float(lim_hi);
    cb[3 * lp] = __int_as_float(lo_lo);
    cb[3 * lp + 8] = __int_as_float(lo_hi);
  }
  const bool leader = threadIdx.x % 128 == 0;
  // the warpgroup is done with tile j of k or v: the second of a slot's
  // two releases requests the tile a ring on into it
  auto release_k = [&](int j) {
    if (leader && (atomicAdd(&k_done[j % SK], 1) & 1) && j + SK < n_tiles)
      load(&map_k, ks, k_full, SK, j + SK);
  };
  auto release_v = [&](int j) {
    if (leader && (atomicAdd(&v_done[j % SV], 1) & 1) && j + SV < n_tiles)
      load(&map_v, vs, v_full, SV, j + SV);
  };
  float acc[NO];  // dQ (of this warpgroup's keys past D 128), float32
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float s[NS], dp[NS];  // S, then dS; dP: d[4 n + e], KW / 8 n8 tiles
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
  uint32_t da[NK][4];  // dS in bfloat16, the A fragments of NK k16 steps
  const uint32_t hi = lm::desc_hi_sw128(1024);
  const uint32_t q_lo = lm::desc_lo(qs + (kN ? c * T::kTileBytes : 0), 16);
  const uint32_t do_lo = lm::desc_lo(dos + (kN ? c * T::kTileBytes : 0), 16);
  const uint32_t kc = kN ? 0 : c * 32 * 128;  // this warpgroup's keys
  auto issue_sdp = [&](int j) {  // S = q k^T, dP = dO v^T: D / 16 k-steps
    const uint32_t k_lo = lm::desc_lo(ks + j % SK * T::kTileBytes + kc, 16);
    const uint32_t v_lo = lm::desc_lo(vs + j % SV * T::kTileBytes + kc, 16);
    static_for<KS>([&](auto step) {
      constexpr int kk = decltype(step)::value;
      constexpr int o16 = kstep_offset<D, kk>();
      if constexpr (kN)
        lm::wgmma_m64n64k16_ss<o16, o16>(s, q_lo, k_lo, hi, kk > 0);
      else
        lm::wgmma_m64n32k16_ss<o16, o16>(s, q_lo, k_lo, hi, kk > 0);
    });
    static_for<KS>([&](auto step) {
      constexpr int kk = decltype(step)::value;
      constexpr int o16 = kstep_offset<D, kk>();
      if constexpr (kN)
        lm::wgmma_m64n64k16_ss<o16, o16>(dp, do_lo, v_lo, hi, kk > 0);
      else
        lm::wgmma_m64n32k16_ss<o16, o16>(dp, do_lo, v_lo, hi, kk > 0);
    });
    lm::wgmma_commit();
  };
  auto issue_dq = [&](int j) {  // dQ += dS k, NK k-steps of 16 keys
    const uint32_t k_lo =
        lm::desc_lo(ks + j % SK * T::kTileBytes + kc, T::kBoxBytes);
    static_for<NK>([&](auto step) {
      constexpr int kk = decltype(step)::value;
      wgmma_rs_tb<D, kk * 2048 / 16>(acc, da[kk], k_lo, hi);
    });
    lm::wgmma_commit();
  };
  // P = exp2(S scale log2 e - lse log2 e) in float32, masked outside each
  // row's key limits (only where the keys cross one), then dS = P (dP -
  // D) in place of S
  auto grads = [&](int j) {
    const int kb = kbeg + j * kKeys + (kN ? 0 : 32 * c);
    const bool cross = kb + KW > lim_lo || kb < lo_hi;
#pragma unroll
    for (int n = 0; n < KW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p_lo = ex2(fmaf(s[4 * n + e], scale_log2, -ls_lo));
        float p_hi = ex2(fmaf(s[4 * n + 2 + e], scale_log2, -ls_hi));
        if (cross) {
          const int key = kb + 8 * n + 2 * t4 + e;
          if (key >= lim_lo || key < lo_lo) p_lo = 0.f;
          if (key >= lim_hi || key < lo_hi) p_hi = 0.f;
        }
        s[4 * n + e] = p_lo * (dp[4 * n + e] - D_lo);
        s[4 * n + 2 + e] = p_hi * (dp[4 * n + 2 + e] - D_hi);
      }
  };
  auto pack = [&]() {  // k16 step kk: the n8 tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        da[kk][h] = lm::pack_bf16x2(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
  };

  // S and dP of tile j are issued beside dQ of tile j - 1, and P and dS
  // of tile j run under the latter. Both warpgroups walk every tile of the
  // block (a row's keys outside its limits are masked; skipping a tile
  // outside a warpgroup's rows' limits measured slower), but at D <= 128
  // one whose rows all lie past L, its q and dO not loaded, waits for each
  // tile (a slot's barrier phases are read in order) and releases it
  // unread.
  if (kN && q0 + 64 * c >= L) {
    for (int j = 0; j < n_tiles; ++j) {
      lm::mbar_wait(k_full + 8 * (j % SK), (j / SK) & 1);
      lm::mbar_wait(v_full + 8 * (j % SV), (j / SV) & 1);
      release_k(j);
      release_v(j);
    }
  } else {
    lm::mbar_wait(q_full, 0);
    lm::mbar_wait(k_full, 0);
    lm::mbar_wait(v_full, 0);
    lm::wgmma_fence();
    issue_sdp(0);
    lm::wgmma_wait<0>();
    lm::fence_regs(s);
    lm::fence_regs(dp);
    release_v(0);
    grads(0);
    pack();
    for (int j = 1; j < n_tiles; ++j) {
      lm::mbar_wait(k_full + 8 * (j % SK), (j / SK) & 1);
      lm::mbar_wait(v_full + 8 * (j % SV), (j / SV) & 1);
      lm::fence_regs(acc);
      lm::fence_regs(s);
      lm::fence_regs(dp);
      lm::fence_regs(da);
      lm::wgmma_fence();
      issue_sdp(j);
      issue_dq(j - 1);
      lm::wgmma_wait<1>();  // S and dP of tile j
      lm::fence_regs(s);
      lm::fence_regs(dp);
      release_v(j);
      grads(j);
      lm::wgmma_wait<0>();  // dQ of tile j - 1
      lm::fence_regs(acc);
      lm::fence_regs(da);
      release_k(j - 1);
      pack();
    }
    lm::fence_regs(acc);
    lm::fence_regs(da);
    lm::wgmma_fence();
    issue_dq(n_tiles - 1);
    lm::wgmma_wait<0>();
    lm::fence_regs(acc);
    lm::fence_regs(da);
    release_k(n_tiles - 1);
  }

  if constexpr (!kN) {
    // dQ = dQ_0 + dQ_1: warpgroup 1's sum through k's ring, free once
    // both warpgroups' products are done, in its register order
    __syncthreads();
    float4* red = reinterpret_cast<float4*>(smem_raw + (ks - base));
    const int tw = threadIdx.x % 128;
    if (c == 1) {
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
        red[n * 128 + tw] = make_float4(acc[4 * n], acc[4 * n + 1],
                                        acc[4 * n + 2], acc[4 * n + 3]);
    }
    __syncthreads();
    if (c == 1) return;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const float4 x = red[n * 128 + tw];
      acc[4 * n] += x.x;
      acc[4 * n + 1] += x.y;
      acc[4 * n + 2] += x.z;
      acc[4 * n + 3] += x.w;
    }
  }
  bf16* dqb = dq + row0 * Dr;
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int d = 8 * n + 2 * t4;  // Dr % 8 == 0: the pair is whole
    if (d >= Dr) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < L)
        *reinterpret_cast<uint32_t*>(dqb +
                                     static_cast<size_t>(row + 8 * h) * Dr +
                                     d) =
            lm::pack_bf16x2(acc[4 * n + 2 * h] * scale,
                            acc[4 * n + 2 * h + 1] * scale);
  }
}

// named barriers of flash_bwd_dkdv_wgmma's role split: P^T written, read
constexpr int kPFull = 1, kPEmpty = 2;

// dK and dV of a block's keys over exactly the 64-query tiles some row of
// which reads one of them (q, dO and the queries' lse, D and key limits in
// a ring). At D <= 128 the block owns 128 keys and warpgroup c keys 64
// c.., each walking every tile of the block: S^T = k q^T and dP^T = v dO^T
// (m64n64k16 from shared memory), P^T and dS^T = P^T (dP^T - D) in
// float32 registers, rounded into the A fragments of dV += P^T dO and dK
// += dS^T q (m64nDk16, dO and q as transposed B). Past 128 the block owns
// 64 keys and the warpgroups split by role: warpgroup 0 forms S^T, P^T
// (float32, to shared memory for warpgroup 1) and dV += P^T dO;
// warpgroup 1 forms dP^T beside S^T, then dS^T and dK += dS^T q.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ cols,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                         int Dr, int causal, int tq, int tk, int window,
                         int heads_fast, float scale_log2, float scale) {
  using T = BwdTiles<D>;
  constexpr bool kN = T::kKvKeys == 128;  // a warpgroup's own keys
  constexpr int KB = T::kKvKeys, S = T::kKvStages, NB = T::kBoxes;
  constexpr int NO = D / 2, KS = D / 16;
  static_assert(S >= 2 && T::kKvSmem <= 227 * 1024, "the ring does not fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = lm::smem_u32(smem_raw);
  const uint32_t ks = (base + 1023u) & ~1023u;  // [KB / 64][NB][64][64]
  const uint32_t vs = ks + T::kKBytes;
  const uint32_t qs = vs + T::kKBytes;          // [S][NB][64 queries][64]
  const uint32_t dos = qs + S * T::kTileBytes;  // [S][NB][64 queries][64]
  const uint32_t ps = dos + S * T::kTileBytes;  // P^T, float32 (past 128)
  const uint32_t cs = ps + T::kPBytes;  // [S][lse log2 e, D, limits][64]
  const uint32_t kv_full = cs + S * T::kColBytes, full = kv_full + 8;
  int* done = reinterpret_cast<int*>(smem_raw + (full + 8 * S - base));
  const float* C_s = reinterpret_cast<const float*>(smem_raw + (cs - base));

  const int bh = heads_fast ? blockIdx.x : blockIdx.y;
  const int k0 = (heads_fast ? blockIdx.y : blockIdx.x) * KB;  // heavy first
  const size_t row0 = static_cast<size_t>(bh) * L;
  const int lp = (L + kRows - 1) / kRows * kRows;  // cols' rows a head
  const float* colb = cols + 4 * static_cast<size_t>(bh) * lp;
  // neither key limit decreases with the row: the tiles from the first
  // whose last row's upper limit passes k0 to the last whose first row's
  // lower limit is below k0 + KB
  const int n_qt = (L + kRows - 1) / kRows;
  int first = 0, last = n_qt - 1;
  while (first < n_qt &&
         key_limit(min((first + 1) * kRows, L) - 1, L, causal, tq, tk) <= k0)
    ++first;
  while (last >= first && key_lower(last * kRows, window, tq, tk) >= k0 + KB)
    --last;
  const int n_tiles = last - first + 1;  // 0: dK and dV are zero
  // query tile j into its slot: q and dO (rows past L zero-filled), and
  // the 64 queries' lse log2 e, D and key limits in four 256-byte bulk
  // copies (as the dQ pass wrote them: past L, 0 and no key)
  auto load = [&](int j) {
    const int s = j % S, i0 = (first + j) * kRows;
    // after both warpgroups' reads of the slot (wgmma's, and the threads'
    // of lse, D and the limits), before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    lm::mbar_expect_tx(full + 8 * s, 2 * T::kTileBytes + T::kColBytes);
    for (int b = 0; b < NB; ++b) {
      const uint32_t at = s * T::kTileBytes + b * T::kBoxBytes;
      lm::tma_load_3d(qs + at, &map_q, full + 8 * s, b * kBox, i0, bh);
      lm::tma_load_3d(dos + at, &map_do, full + 8 * s, b * kBox, i0, bh);
    }
    for (int h = 0; h < 4; ++h)
      lm::bulk_load(cs + s * T::kColBytes + h * kRows * 4,
                    colb + h * lp + i0, kRows * 4, full + 8 * s);
  };
  if (threadIdx.x == 0) {
    lm::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      lm::mbar_init(full + 8 * s, 1);
      done[s] = 0;
    }
    lm::mbar_fence_init();
    if (n_tiles > 0) {
      // the 64-key tiles of k and v that hold a key below L
      const int halves =
          KB == kKeys ? 1 : (min(KB, L - k0) + kKeys - 1) / kKeys;
      lm::mbar_expect_tx(kv_full, 2 * halves * T::kTileBytes);
      for (int h = 0; h < halves; ++h)
        for (int b = 0; b < NB; ++b) {
          const uint32_t at = h * T::kTileBytes + b * T::kBoxBytes;
          lm::tma_load_3d(ks + at, &map_k, kv_full, b * kBox,
                          k0 + h * kKeys, bh);
          lm::tma_load_3d(vs + at, &map_v, kv_full, b * kBox,
                          k0 + h * kKeys, bh);
        }
      for (int j = 0; j < min(S, n_tiles); ++j) load(j);
    }
  }
  __syncthreads();

  // warpgroup c: keys 64 c.. and the whole chain (D <= 128), or a role
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3, tw = threadIdx.x % 128;
  const int kw = k0 + (kN ? 64 * c : 0);  // this warpgroup's first key
  const int key = kw + warp * 16 + g;     // this thread's: key, key + 8
  const bool leader = tw == 0;
  // both warpgroups are done with query tile j: the second of the slot's
  // two releases requests tile j + S into it
  auto release = [&](int j) {
    if (leader && (atomicAdd(&done[j % S], 1) & 1) && j + S < n_tiles)
      load(j + S);
  };
  const uint32_t hi = lm::desc_hi_sw128(1024);
  bf16* dkb = dk + row0 * Dr;
  bf16* dvb = dv + row0 * Dr;

  if constexpr (kN) {
    float acc_k[NO], acc_v[NO];  // dK, dV: 64 x D float32
#pragma unroll
    for (int i = 0; i < NO; ++i) acc_k[i] = acc_v[i] = 0.f;
    float sc[32], dp[32];  // S^T then P^T, dP^T then dS^T: d[4 n + e]
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    uint32_t pa[4][4], da[4][4];  // P^T, dS^T: A fragments of 4 k16 steps
    const uint32_t k_lo = lm::desc_lo(ks + c * T::kTileBytes, 16);
    const uint32_t v_lo = lm::desc_lo(vs + c * T::kTileBytes, 16);
    auto issue_t = [&](int j) {  // S^T = k q^T, dP^T = v dO^T
      const uint32_t q_lo = lm::desc_lo(qs + j % S * T::kTileBytes, 16);
      const uint32_t do_lo = lm::desc_lo(dos + j % S * T::kTileBytes, 16);
      static_for<KS>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        constexpr int o16 = kstep_offset<D, kk>();
        lm::wgmma_m64n64k16_ss<o16, o16>(sc, k_lo, q_lo, hi, kk > 0);
      });
      static_for<KS>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        constexpr int o16 = kstep_offset<D, kk>();
        lm::wgmma_m64n64k16_ss<o16, o16>(dp, v_lo, do_lo, hi, kk > 0);
      });
      lm::wgmma_commit();
    };
    auto issue_acc = [&](int j) {  // dV += P^T dO, dK += dS^T q
      const uint32_t do_b =
          lm::desc_lo(dos + j % S * T::kTileBytes, T::kBoxBytes);
      const uint32_t q_b = lm::desc_lo(qs + j % S * T::kTileBytes, T::kBoxBytes);
      static_for<4>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        wgmma_rs_tb<D, kk * 2048 / 16>(acc_v, pa[kk], do_b, hi);
      });
      static_for<4>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        wgmma_rs_tb<D, kk * 2048 / 16>(acc_k, da[kk], q_b, hi);
      });
      lm::wgmma_commit();
    };
    // P^T of tile j in place of S^T, masked only where the tile crosses a
    // limit of these keys (or holds rows past L), and dS^T in place of
    // dP^T; a thread's queries are 8 n + 2 t and 8 n + 2 t + 1, pair 4 n
    // + t of the slot's lse log2 e, D and limits
    auto grads = [&](int j) {
      const int i0 = (first + j) * kRows;
      const float2* cv =
          reinterpret_cast<const float2*>(C_s + (j % S) * 4 * kRows);
      const int2* lim = reinterpret_cast<const int2*>(cv + kRows);
      const int2* lo = reinterpret_cast<const int2*>(cv + 3 * kRows / 2);
      const bool cross = i0 + kRows > L ||
                         key_limit(i0, L, causal, tq, tk) < kw + 64 ||
                         key_lower(i0 + kRows - 1, window, tq, tk) > kw;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 ls = cv[4 * n + t4], dd = cv[kRows / 2 + 4 * n + t4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = e ? ls.y : ls.x, de = e ? dd.y : dd.x;
          float p_lo = ex2(fmaf(sc[4 * n + e], scale_log2, -l2));
          float p_hi = ex2(fmaf(sc[4 * n + 2 + e], scale_log2, -l2));
          if (cross) {
            const int2 up = lim[4 * n + t4], dn = lo[4 * n + t4];
            const int u = e ? up.y : up.x, w = e ? dn.y : dn.x;
            if (key >= u || key < w) p_lo = 0.f;
            if (key + 8 >= u || key + 8 < w) p_hi = 0.f;
          }
          sc[4 * n + e] = p_lo;
          sc[4 * n + 2 + e] = p_hi;
          dp[4 * n + e] = p_lo * (dp[4 * n + e] - de);
          dp[4 * n + 2 + e] = p_hi * (dp[4 * n + 2 + e] - de);
        }
      }
    };
    auto pack = [&]() {  // k16 step kk: the n8 tiles 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          pa[kk][h] = lm::pack_bf16x2(sc[8 * kk + 2 * h],
                                      sc[8 * kk + 2 * h + 1]);
          da[kk][h] = lm::pack_bf16x2(dp[8 * kk + 2 * h],
                                      dp[8 * kk + 2 * h + 1]);
        }
    };

    // S^T and dP^T of tile j are issued beside dV and dK of tile j - 1,
    // and P^T and dS^T of tile j run under the latter. Both warpgroups
    // walk every tile of the block (a query's keys outside its limits are
    // masked; skipping a tile outside a warpgroup's keys' limits measured
    // slower), but one whose keys all lie past L, its k and v not loaded,
    // waits for each tile (a slot's barrier phases are read in order) and
    // releases it unread.
    if (kw >= L) {
      for (int j = 0; j < n_tiles; ++j) {
        lm::mbar_wait(full + 8 * (j % S), (j / S) & 1);
        release(j);
      }
    } else if (n_tiles > 0) {
      lm::mbar_wait(kv_full, 0);
      lm::mbar_wait(full, 0);
      lm::wgmma_fence();
      issue_t(0);
      lm::wgmma_wait<0>();
      lm::fence_regs(sc);
      lm::fence_regs(dp);
      grads(0);
      pack();
      for (int j = 1; j < n_tiles; ++j) {
        lm::mbar_wait(full + 8 * (j % S), (j / S) & 1);
        lm::fence_regs(acc_k);
        lm::fence_regs(acc_v);
        lm::fence_regs(sc);
        lm::fence_regs(dp);
        lm::fence_regs(pa);
        lm::fence_regs(da);
        lm::wgmma_fence();
        issue_t(j);
        issue_acc(j - 1);
        lm::wgmma_wait<1>();  // S^T and dP^T of tile j
        lm::fence_regs(sc);
        lm::fence_regs(dp);
        grads(j);
        lm::wgmma_wait<0>();  // dV and dK of tile j - 1
        lm::fence_regs(acc_k);
        lm::fence_regs(acc_v);
        lm::fence_regs(pa);
        lm::fence_regs(da);
        release(j - 1);
        pack();
      }
      lm::fence_regs(acc_k);
      lm::fence_regs(acc_v);
      lm::fence_regs(pa);
      lm::fence_regs(da);
      lm::wgmma_fence();
      issue_acc(n_tiles - 1);
      lm::wgmma_wait<0>();
      lm::fence_regs(acc_k);
      lm::fence_regs(acc_v);
      lm::fence_regs(pa);
      lm::fence_regs(da);
      release(n_tiles - 1);
    }

#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int d = 8 * n + 2 * t4;  // Dr % 8 == 0: the pair is whole
      if (d >= Dr) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = key + 8 * h;
        if (r >= L) continue;
        const size_t at = static_cast<size_t>(r) * Dr + d;
        *reinterpret_cast<uint32_t*>(dkb + at) = lm::pack_bf16x2(
            acc_k[4 * n + 2 * h] * scale, acc_k[4 * n + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + at) = lm::pack_bf16x2(
            acc_v[4 * n + 2 * h], acc_v[4 * n + 2 * h + 1]);
      }
    }
  } else {
    float4* P_s = reinterpret_cast<float4*>(smem_raw + (ps - base));
    float acc[NO];  // dV (warpgroup 0) or dK (warpgroup 1), 64 x D float32
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float sc[32];  // S^T then P^T, or dP^T then dS^T: d[4 n + e], 8 n8 tiles
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    uint32_t pa[4][4];  // P^T or dS^T in bfloat16, A fragments of 4 k16 steps
    const uint32_t a_lo = lm::desc_lo(c == 0 ? ks : vs, 16);
    // S^T = k q^T or dP^T = v dO^T, D / 16 k-steps
    auto issue_t = [&](int j) {
      const uint32_t b_lo =
          lm::desc_lo((c == 0 ? qs : dos) + j % S * T::kTileBytes, 16);
      static_for<KS>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        constexpr int o16 = kstep_offset<D, kk>();
        lm::wgmma_m64n64k16_ss<o16, o16>(sc, a_lo, b_lo, hi, kk > 0);
      });
      lm::wgmma_commit();
    };
    // dV += P^T dO or dK += dS^T q, 4 k-steps of 16 queries
    auto issue_acc = [&](int j) {
      const uint32_t b_lo = lm::desc_lo(
          (c == 0 ? dos : qs) + j % S * T::kTileBytes, T::kBoxBytes);
      static_for<4>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        wgmma_rs_tb<D, kk * 2048 / 16>(acc, pa[kk], b_lo, hi);
      });
      lm::wgmma_commit();
    };

    if (n_tiles > 0) {
      lm::mbar_wait(kv_full, 0);
      if (c == 1) lm::bar_arrive(kPEmpty, 256);  // P^T's buffer starts free
    }
    for (int j = 0; j < n_tiles; ++j) {
      lm::mbar_wait(full + 8 * (j % S), (j / S) & 1);
      lm::fence_regs(sc);
      lm::wgmma_fence();
      issue_t(j);
      // this tile's queries' lse log2 e, D, upper and lower key limits: a
      // thread's are queries 8 n + 2 t and 8 n + 2 t + 1, pair 4 n + t
      const float2* cv =
          reinterpret_cast<const float2*>(C_s + (j % S) * 4 * kRows);
      lm::wgmma_wait<0>();
      lm::fence_regs(sc);
      if (c == 0) {
        const int2* lim = reinterpret_cast<const int2*>(cv + kRows);
        const int2* lo = reinterpret_cast<const int2*>(cv + 3 * kRows / 2);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 ls = cv[4 * n + t4];
          const int2 up = lim[4 * n + t4], dn = lo[4 * n + t4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float l2 = e ? ls.y : ls.x;
            const int u = e ? up.y : up.x, w = e ? dn.y : dn.x;
            const float p_lo = ex2(fmaf(sc[4 * n + e], scale_log2, -l2));
            const float p_hi = ex2(fmaf(sc[4 * n + 2 + e], scale_log2, -l2));
            sc[4 * n + e] = key < u && key >= w ? p_lo : 0.f;
            sc[4 * n + 2 + e] = key + 8 < u && key + 8 >= w ? p_hi : 0.f;
          }
        }
        lm::bar_sync(kPEmpty, 256);  // warpgroup 1 has read tile j - 1's
#pragma unroll
        for (int n = 0; n < 8; ++n)
          P_s[n * 128 + tw] = make_float4(sc[4 * n], sc[4 * n + 1],
                                          sc[4 * n + 2], sc[4 * n + 3]);
        lm::bar_arrive(kPFull, 256);
      } else {
        lm::bar_sync(kPFull, 256);
        float4 p[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) p[n] = P_s[n * 128 + tw];
        if (j + 1 < n_tiles) lm::bar_arrive(kPEmpty, 256);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 dd = cv[kRows / 2 + 4 * n + t4];
          sc[4 * n] = p[n].x * (sc[4 * n] - dd.x);
          sc[4 * n + 1] = p[n].y * (sc[4 * n + 1] - dd.y);
          sc[4 * n + 2] = p[n].z * (sc[4 * n + 2] - dd.x);
          sc[4 * n + 3] = p[n].w * (sc[4 * n + 3] - dd.y);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k16 step kk: n8 tiles 2 kk, 2 kk + 1
#pragma unroll
        for (int h = 0; h < 4; ++h)
          pa[kk][h] =
              lm::pack_bf16x2(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
      lm::fence_regs(acc);
      lm::fence_regs(pa);
      lm::wgmma_fence();
      issue_acc(j);
      lm::wgmma_wait<0>();
      lm::fence_regs(acc);
      lm::fence_regs(pa);
      release(j);
    }

    bf16* out = c == 0 ? dvb : dkb;
    const float mul = c == 0 ? 1.f : scale;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      const int d = 8 * n + 2 * t4;  // Dr % 8 == 0: the pair is whole
      if (d >= Dr) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = key + 8 * h;
        if (r < L)
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * Dr +
                                       d) =
              lm::pack_bf16x2(acc[4 * n + 2 * h] * mul,
                              acc[4 * n + 2 * h + 1] * mul);
      }
    }
  }
}

// Dr: the row width of q, k, v, o, dO and the gradients, a multiple of 8
// (TMA's 16-byte row strides) and at most D; the wrapper zero-pads a head
// dim to it
template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, float* dsum, int bh, int L,
                     int Dr, int causal, int tq, int tk, int window,
                     float scale, cudaStream_t stream) {
  const void* bases[] = {q, k, v, o, dout, dsum};  // TMA's, 16-byte loads'
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  if (Dr % 8 || Dr > D || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!lm::make_head_map(&map_q, q, Dr, L, bh, kRows) ||
      !lm::make_head_map(&map_k, k, Dr, L, bh, kKeys) ||
      !lm::make_head_map(&map_v, v, Dr, L, bh, kKeys) ||
      !lm::make_head_map(&map_do, dout, Dr, L, bh, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = BwdTiles<D>;
  cudaError_t e = lm::allow_smem(flash_bwd_dq_wgmma<D>, T::kDqSmem);
  if (e == cudaSuccess)
    e = lm::allow_smem(flash_bwd_dkdv_wgmma<D>, T::kKvSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // Heads outermost in the grid: the blocks in flight share a few heads'
  // tiles in L2. Where every head's k and v fit in L2 together (a 50 MB
  // cache), heads fastest instead: the heaviest blocks of every head run
  // first (Qwen2-MoE's training shape, BH 32 x 2,048 x 128, causal: 15%
  // less time; Zamba2's, 59 MB, 12% more; scripts/flash_bwd_ablate.py)
  const int heads_fast =
      4.0 * bh * L * Dr <= kHeadsFastBytes ? 1 : 0;
  const int n_dq = (L + T::kDqRows - 1) / T::kDqRows;
  const int n_kv = (L + T::kKvKeys - 1) / T::kKvKeys;
  const dim3 grid_dq = heads_fast ? dim3(bh, n_dq) : dim3(n_dq, bh);
  const dim3 grid_kv = heads_fast ? dim3(bh, n_kv) : dim3(n_kv, bh);
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dq_wgmma<D><<<grid_dq, kWgThreads, T::kDqSmem, stream>>>(
      map_q, map_k, map_v, map_do, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), dsum, L,
      Dr, causal, tq, tk, window, heads_fast, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_wgmma<D><<<grid_kv, kWgThreads, T::kKvSmem, stream>>>(
      map_q, map_k, map_v, map_do, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, Dr, causal, tq, tk, window, heads_fast,
      scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

// every bfloat16 head dim runs the wgmma pair: the wrapper's row width Dr
// (1-256, a multiple of 8) at the build of 64, 128, 192 or 256 columns
// that holds it, TMA zero-filling the rest
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, float* dsum, int bh, int L,
                    int D, int causal, int tq, int tk, int window,
                    float scale, cudaStream_t s) {
#define BWD_WGMMA(DW)                                                        \
  return launch_bwd_wgmma<DW>(q, k, v, o, dout, lse, dq, dk, dv, dsum, bh, \
                              L, D, causal, tq, tk, window, scale, s)
  if (D <= 64) BWD_WGMMA(64);
  if (D <= 128) BWD_WGMMA(128);
  if (D <= 192) BWD_WGMMA(192);
  BWD_WGMMA(256);
#undef BWD_WGMMA
}

// a window needs causal attention and tq == tk: the reference defines
// the windowed function over one chunk size only
bool bad_shape(int bh, int L, int D, int causal, int tq, int tk,
               int window) {
  return bh < 1 || L < 1 || D < 1 || D > 256 || tq < 1 || tk < 1 ||
         L % tq || L % tk || (L + kRows - 1) / kRows > 65535 || window < 0 ||
         (window > 0 && (!causal || tq != tk));
}

}  // namespace

// q, k, v, o: (bh, L, D) contiguous, float32 (is_bf16 = 0) or bfloat16;
// lse: (bh, L) float32, each row's log-sum-exp written when not null;
// window: 0, or the sliding window's width (causal, tq == tk). Needs
// 1 <= D <= 256, L % tq == 0, L % tk == 0, (L + 63) / 64 <= 65535.
extern "C" int flash_attention_launch(int is_bf16, const void* q,
                                      const void* k, const void* v, void* o,
                                      float* lse, int bh, int L, int D,
                                      int causal, int tq, int tk, int window,
                                      float scale, void* stream) {
  if (bad_shape(bh, L, D, causal, tq, tk, window))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, o, lse, bh, L, D, causal, tq, tk, window,
                       scale, s);
  return launch_f32(q, k, v, o, lse, bh, L, D, causal, tq, tk, window, scale,
                    s);
}

// The backward of flash_attention_launch at output o, its gradient dout
// and the forward's lse (all as there): dq, dk, dv (bh, L, D) in the
// inputs' type; dsum float32 scratch of 4 bh ceil(L / 64) 64 values,
// 16-byte aligned (D = rowsum(dO o): (bh, L) for the float32 kernels;
// for the bfloat16 wgmma pair each head's lse log2 e, D and key limits in
// 64-row chunks). Two kernels, dq (and D) then dk and dv, on `stream`; no
// atomics.
extern "C" int flash_attention_bwd_launch(
    int is_bf16, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* dsum, int bh, int L, int D, int causal, int tq, int tk,
    int window, float scale, void* stream) {
  if (bad_shape(bh, L, D, causal, tq, tk, window))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd_bf16(q, k, v, o, dout, lse, dq, dk, dv, dsum, bh, L, D,
                           causal, tq, tk, window, scale, s);
  return launch_bwd<float>(q, k, v, o, dout, lse, dq, dk, dv, dsum, bh, L, D,
                           causal, tq, tk, window, scale, s);
}
