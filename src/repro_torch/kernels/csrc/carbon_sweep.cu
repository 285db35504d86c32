// sweep_tile on Hopper: the carbon sweep's evaluate-and-reduce kernel, in
// two builds of one body.
//
// Replaces the TPU kernel src/repro/kernels/carbon_sweep.py:408
// (sweep_tile, path="pallas"; its pallas_call is at :344). For a tile of
// Tc scenario cells with N lifetime draws and C candidates (core x
// redundancy) it computes, per (cell, draw), the candidate with the least
// total carbon (first minimum wins) and its total; per cell, the chosen-
// candidate counts and the sum / min / max of the best totals and the
// chosen embodied and operational sums; and across the sweep, the tile's
// contribution to the int32 log10 histogram of best totals and the
// per-embodied-bin Pareto champion, least in (operational kg, cell,
// draw), merged into the running accumulators in place (the counterpart
// of the TPU kernel's input_output_aliases).
//
// The cell pass is templated on where a draw's lifetime comes from:
//   (a) read from life_days[cell, d], the TPU kernel's own contract
//       (carbon_sweep_launch);
//   (b) drawn in the kernel (carbon_sweep_drawn_launch): the cell's key is
//       fold_in(key, cell_idx[cell]), draw d hashes counters 2d and 2d + 1
//       and goes through the cell's inverse-CDF mixture in days
//       (sweep_draws.cuh), so the sweep's uniforms and lifetimes never
//       touch device memory. Optionally it writes the lifetimes it drew
//       (life_out, for checks) and skips best_core, which the sweep never
//       reads.
//
// Design. The TPU kernel walks row tiles in order on one core and carries
// the accumulators from grid step to grid step. Here the cells run in
// parallel in two launches on one stream:
//   pass A, one block per cell, its threads striding over the draws: each
//     draw's totals in the reference's op order (carbon_sweep.cuh, FMA-
//     free whatever the flags), the argmin and the per-draw outputs; the
//     sums, min and max in registers; each thread's chosen-candidate
//     counts and champion draws (least op, then least draw) in its own
//     shared-memory column per candidate, three accesses a draw whatever
//     C is; one shared int atomic a draw for the histogram bin. Then xor
//     butterflies of shuffles within each warp and one cross-warp step in
//     warp order, a fixed order, so a run is bit-identical to any other
//     and to any tile size; the (cell, candidate) champions and their
//     embodied Pareto bin (one log10 each, -1 when the champion is not
//     alive) go to scratch, and the block adds its histogram to the
//     running one with global atomics. The block is 256 threads, fewer
//     when there are fewer draws or when C columns of 256 threads do not
//     fit shared memory (down to one warp: several hundred candidates);
//   pass B, one block per Pareto bin: the least alive champion of the bin
//     under the strict total order (op, cell, draw), merged into the
//     running accumulator by _pareto_merge's rule. The keys of alive
//     champions are distinct, so any reduction order gives the
//     reference's frontier exactly. Its loads go out eight at a time.
// scripts/sweep_layouts.py builds and times variants of this file: other
// block widths, champions in registers, __match_any_sync bin adds, and
// with the champions, the argmin or the bins taken out; PERF.md has the
// numbers.
//
// What bounds it, at the main path's tile (Tc = 1,024, N = 4,096, C = 9,
// float32): build (a) moves 16.8 MB of lifetimes in and 33.6 MB of
// best_total / best_core out, about 0.015 ms at 3.35 TB/s; its 1.5e8
// float32 operations take about 0.002 ms. Build (b) reads no lifetimes
// and, in the sweep, writes best_total only (16.8 MB, 0.005 ms); its
// 8.4e6 threefry hashes of about 80 int32 operations each bound it at
// about 0.04 ms of the card's int32 rate. Both run well above these
// bounds, which count none of the instructions of the NaN-exact argmin,
// the champion columns and the log10 bins.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "carbon_sweep.cuh"
#include "sweep_draws.cuh"


namespace {

constexpr int kMaxBlock = 256;
constexpr int kParetoBlock = 256;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double inf_of<double>() { return CUDART_INF; }

// Everything one launch of pass A reads and writes.
template <typename T>
struct Tile {
  const T* emb;
  const T* kwh;
  const T* inten;
  const T* freq;
  const T* life;              // (a): (Tc, N) lifetimes in days
  const uint8_t* valid;
  const int32_t* cell_idx;
  const int32_t* kind;        // (b): the cells' (Tc, K) component rows,
  const T* p1;                //      (Tc, n_cum) cumulative weights
  const T* p2;
  const T* cum;
  int n_comp, n_cum;
  uint32_t key0, key1;
  T day_s;
  T* life_out;                // (b), optional
  T* best_total;
  int32_t* best_core;         // optional in (b)
  int32_t* counts;
  T* sum_best;
  T* min_best;
  T* max_best;
  T* sum_emb;
  T* sum_op;
  T* ch_op;                   // (Tc, C) champions, pass A -> pass B
  int32_t* ch_draw;
  T* ch_life;
  int32_t* ch_bin;
  int32_t* hist;
  int n_cells, n_draws, n_cand, n_hist, n_par;
  T hist_lo, hist_inv, par_lo, par_inv;
};

// Dynamic shared memory of pass A for a block of `bd` threads: the T
// words (champion ops [C][bd], the cell's candidate rows, its
// distribution rows in (b), one partial a warp), then the int32 words
// (champion draws and counts [C][bd], kinds in (b), one partial a warp,
// the block's bins).
template <typename T>
struct Smem {
  int C, K, Kc, bd;
  __host__ __device__ size_t cols() const {
    return static_cast<size_t>(C) * bd;
  }
  __host__ __device__ size_t n_t() const {
    return cols() + 2 * static_cast<size_t>(C) + 2 * K + Kc +
           (bd / 32) * (5 + static_cast<size_t>(C));
  }
  __host__ __device__ size_t bytes(int n_hist) const {
    return n_t() * sizeof(T) +
           (2 * cols() + K + (bd / 32) * 2 * static_cast<size_t>(C) +
            n_hist) * sizeof(int32_t);
  }
};

// One thread's champion columns: for candidate c, at c * bd + tid, how
// many of the thread's draws chose c and the least (op, draw) of them.
// Columns of different threads are adjacent words, free of bank
// conflicts.
template <typename T>
struct Columns {
  T* op;
  int32_t* dr;
  int32_t* n;
  int bd, tid;
  __device__ __forceinline__ void init(int C) const {
    for (int c = 0; c < C; ++c) {
      op[c * bd + tid] = inf_of<T>();
      dr[c * bd + tid] = csweep::kIMax;
      n[c * bd + tid] = 0;
    }
  }
  __device__ __forceinline__ void take(int32_t c, T bo, int32_t d) const {
    const int k = c * bd + tid;
    ++n[k];
    if (csweep::champion_takes(bo, d, op[k], dr[k])) {
      op[k] = bo;
      dr[k] = d;
    }
  }
  __device__ __forceinline__ void get(int c, T& o, int32_t& d,
                                      int32_t& m) const {
    o = op[c * bd + tid];
    d = dr[c * bd + tid];
    m = n[c * bd + tid];
  }
};

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}

template <typename T, bool kDrawn>
__global__ void __launch_bounds__(kMaxBlock) sweep_cells_kernel(Tile<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.n_cand, N = a.n_draws;
  const int K = kDrawn ? a.n_comp : 0, Kc = kDrawn ? a.n_cum : 0;
  const int bd = blockDim.x;
  const Smem<T> L{C, K, Kc, bd};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t cell = blockIdx.x;

  T* const c_op = reinterpret_cast<T*>(smem);       // [C][bd]
  T* const s_emb = c_op + L.cols();
  T* const s_base = s_emb + C;
  T* const s_p1 = s_base + C;
  T* const s_p2 = s_p1 + K;
  T* const s_cum = s_p2 + K;
  T* const s_part = s_cum + Kc;                     // [warps][5 + C]
  int32_t* const c_dr = reinterpret_cast<int32_t*>(c_op + L.n_t());
  int32_t* const c_cnt = c_dr + L.cols();           // [C][bd]
  int32_t* const s_kind = c_cnt + L.cols();
  int32_t* const s_ipart = s_kind + K;              // [warps][2 C]
  int32_t* const s_hist = s_ipart + (bd / 32) * 2 * C;
  const Columns<T> champs{c_op, c_dr, c_cnt, bd, tid};

  const T inf = inf_of<T>();
  const T in_c = a.inten[cell];
  for (int c = tid; c < C; c += bd) {
    s_emb[c] = a.emb[cell * C + c];
    s_base[c] = csweep::mul(a.kwh[cell * C + c], in_c);
  }
  if (kDrawn) {
    for (int k = tid; k < K; k += bd) {
      s_kind[k] = a.kind[cell * K + k];
      s_p1[k] = a.p1[cell * K + k];
      s_p2[k] = a.p2[cell * K + k];
    }
    for (int k = tid; k < Kc; k += bd) s_cum[k] = a.cum[cell * Kc + k];
  }
  champs.init(C);
  for (int b = tid; b < a.n_hist; b += bd) s_hist[b] = 0;
  __syncthreads();

  const bool ok = a.valid[cell] != 0;
  const T fr = a.freq[cell];
  uint32_t k0 = a.key0, k1 = a.key1;
  if (kDrawn) sdraw::fold_in(k0, k1, static_cast<uint32_t>(a.cell_idx[cell]));
  const int64_t row = cell * N;
  T sum = T(0), se = T(0), so = T(0), mn = inf, mx = -inf;
  for (int d = tid; d < N; d += bd) {
    T life;
    if (kDrawn)
      life = sdraw::draw_life_days(k0, k1, d, s_kind, s_p1, s_p2, s_cum, K,
                                   Kc, a.day_s);
    else
      life = a.life[row + d];
    T bt, bo;
    const int32_t bc =
        csweep::argmin_draw(s_emb, s_base, life, fr, C, &bt, &bo);
    if (kDrawn && a.life_out) a.life_out[row + d] = life;
    a.best_total[row + d] = bt;
    if (a.best_core) a.best_core[row + d] = bc;
    sum = csweep::add(sum, bt);
    se = csweep::add(se, s_emb[bc]);
    so = csweep::add(so, bo);
    mn = csweep::nan_min(mn, bt);
    mx = csweep::nan_max(mx, bt);
    champs.take(bc, bo, d);
    const int32_t bin =
        ok ? csweep::log_bin(bt, a.hist_lo, a.hist_inv, a.n_hist) : -1;
    if (bin >= 0) atomicAdd(&s_hist[bin], 1);
  }
  // xor butterflies: every lane ends with the warp's values, each formed
  // in the same order; lane 0 leaves them for the cross-warp step
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = csweep::add(sum, shfl_xor(sum, o));
    se = csweep::add(se, shfl_xor(se, o));
    so = csweep::add(so, shfl_xor(so, o));
    mn = csweep::nan_min(mn, shfl_xor(mn, o));
    mx = csweep::nan_max(mx, shfl_xor(mx, o));
  }
  T* const p = s_part + warp * (5 + C);
  int32_t* const q = s_ipart + warp * 2 * C;
  if (lane == 0) {
    p[0] = sum;
    p[1] = se;
    p[2] = so;
    p[3] = mn;
    p[4] = mx;
  }
  for (int c = 0; c < C; ++c) {
    T op;
    int32_t dr, n;
    champs.get(c, op, dr, n);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      n += shfl_xor(n, o);
      const T op2 = shfl_xor(op, o);
      const int32_t dr2 = shfl_xor(dr, o);
      if (csweep::champion_takes(op2, dr2, op, dr)) {
        op = op2;
        dr = dr2;
      }
    }
    if (lane == 0) {
      p[5 + c] = op;
      q[c] = n;
      q[C + c] = dr;
    }
  }
  __syncthreads();

  for (int b = tid; b < a.n_hist; b += bd)
    if (s_hist[b]) atomicAdd(&a.hist[b], s_hist[b]);
  if (warp != 0) return;
  // the first warp joins the warps' partials in warp order
  const int n_warps = bd / 32;
  if (lane == 0) {
    T s = s_part[0], e = s_part[1], o = s_part[2], lo = s_part[3],
      hi = s_part[4];
    for (int w = 1; w < n_warps; ++w) {
      const T* pw = s_part + w * (5 + C);
      s = csweep::add(s, pw[0]);
      e = csweep::add(e, pw[1]);
      o = csweep::add(o, pw[2]);
      lo = csweep::nan_min(lo, pw[3]);
      hi = csweep::nan_max(hi, pw[4]);
    }
    a.sum_best[cell] = s;
    a.sum_emb[cell] = e;
    a.sum_op[cell] = o;
    a.min_best[cell] = lo;
    a.max_best[cell] = hi;
  }
  for (int c = lane; c < C; c += 32) {
    T op = s_part[5 + c];
    int32_t n = s_ipart[c], dr = s_ipart[C + c];
    for (int w = 1; w < n_warps; ++w) {
      const T ow = s_part[w * (5 + C) + 5 + c];
      const int32_t dw = s_ipart[w * 2 * C + C + c];
      n += s_ipart[w * 2 * C + c];
      if (csweep::champion_takes(ow, dw, op, dr)) {
        op = ow;
        dr = dw;
      }
    }
    const int64_t i = cell * C + c;
    a.counts[i] = n;
    a.ch_op[i] = op;
    a.ch_draw[i] = dr;
    T life = T(0);
    if (dr != csweep::kIMax) {
      if (kDrawn)
        life = sdraw::draw_life_days(k0, k1, dr, s_kind, s_p1, s_p2, s_cum,
                                     K, Kc, a.day_s);
      else
        life = a.life[row + dr];
    }
    a.ch_life[i] = life;
    a.ch_bin[i] = ok && op < inf ? csweep::log_bin(s_emb[c], a.par_lo,
                                                   a.par_inv, a.n_par)
                                 : -1;
  }
}

// The least of two Pareto keys, carried with the champion's index.
template <typename T>
struct ParKey {
  T op;
  int32_t cell, draw, idx;
};

template <typename T>
__device__ __forceinline__ void par_take(ParKey<T>& k, const ParKey<T>& o) {
  if (csweep::pareto_takes(o.op, o.cell, o.draw, k.op, k.cell, k.draw)) k = o;
}

template <typename T>
__global__ void __launch_bounds__(kParetoBlock) sweep_pareto_kernel(
    const T* __restrict__ emb, const int32_t* __restrict__ cell_idx,
    const T* __restrict__ ch_op, const int32_t* __restrict__ ch_draw,
    const T* __restrict__ ch_life, const int32_t* __restrict__ ch_bin,
    int32_t n_cells, int32_t n_cand, T* __restrict__ par_op,
    T* __restrict__ par_emb, T* __restrict__ par_life,
    int32_t* __restrict__ par_cell, int32_t* __restrict__ par_draw,
    int32_t* __restrict__ par_core) {
  __shared__ ParKey<T> s_key[kParetoBlock / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int bin = blockIdx.x;
  // the empty key (inf, IMAX, IMAX) never comes before an alive champion
  ParKey<T> k{inf_of<T>(), csweep::kIMax, csweep::kIMax, -1};
  const int n = n_cells * n_cand;                   // < 2**31 (launch)
  // kBatch entries a thread are loaded together; an entry of another
  // bin, or not alive (bin -1), is skipped
  constexpr int kBatch = 8;
  for (int i0 = tid; i0 < n; i0 += kBatch * kParetoBlock) {
    int32_t b[kBatch];
    ParKey<T> e[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kParetoBlock;
      const int j = i < n ? i : n - 1;
      b[u] = i < n ? ch_bin[j] : -1;
      e[u] = ParKey<T>{ch_op[j], cell_idx[j / n_cand], ch_draw[j], j};
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (b[u] == bin) par_take(k, e[u]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    par_take(k, ParKey<T>{shfl_xor(k.op, o), shfl_xor(k.cell, o),
                          shfl_xor(k.draw, o), shfl_xor(k.idx, o)});
  if (lane == 0) s_key[tid >> 5] = k;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kParetoBlock / 32; ++w) par_take(k, s_key[w]);
    if (k.idx >= 0 && csweep::pareto_takes(k.op, k.cell, k.draw, par_op[bin],
                                           par_cell[bin], par_draw[bin])) {
      par_op[bin] = k.op;
      par_emb[bin] = emb[k.idx];
      par_life[bin] = ch_life[k.idx];
      par_cell[bin] = k.cell;
      par_draw[bin] = k.draw;
      par_core[bin] = k.idx % n_cand;
    }
  }
}

// Both passes of one tile.
template <typename T, bool kDrawn>
int launch(const Tile<T>& a, const void* emb, const void* cell_idx,
           void* par_op, void* par_emb, void* par_life, void* par_cell,
           void* par_draw, void* par_core, cudaStream_t stream) {
  // a power-of-two block no wider than the draws (at least one warp),
  // halved until the champion columns fit shared memory
  Smem<T> L{a.n_cand, kDrawn ? a.n_comp : 0, kDrawn ? a.n_cum : 0, 32};
  while (L.bd < kMaxBlock && L.bd < a.n_draws) L.bd *= 2;
  while (L.bd > 32 && L.bytes(a.n_hist) > kMaxSmem) L.bd /= 2;
  const size_t smem = L.bytes(a.n_hist);
  if (smem > kMaxSmem ||
      static_cast<int64_t>(a.n_cells) * a.n_cand > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = sweep_cells_kernel<T, kDrawn>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<a.n_cells, L.bd, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_pareto_kernel<T><<<a.n_par, kParetoBlock, 0, stream>>>(
      static_cast<const T*>(emb), static_cast<const int32_t*>(cell_idx),
      a.ch_op, a.ch_draw, a.ch_life, a.ch_bin, a.n_cells, a.n_cand,
      static_cast<T*>(par_op), static_cast<T*>(par_emb),
      static_cast<T*>(par_life), static_cast<int32_t*>(par_cell),
      static_cast<int32_t*>(par_draw), static_cast<int32_t*>(par_core));
  return static_cast<int>(cudaGetLastError());
}

// The fields both builds share.
template <typename T>
Tile<T> tile_of(const void* emb, const void* kwh, const void* inten,
                const void* freq, const void* valid, const void* cell_idx,
                void* best_total, void* best_core, void* counts,
                void* sum_best, void* min_best, void* max_best, void* sum_emb,
                void* sum_op, void* ch_op, void* ch_draw, void* ch_life,
                void* ch_bin, void* hist, int n_cells, int n_draws,
                int n_cand, int n_hist, int n_par, double hist_lo,
                double hist_inv, double par_lo, double par_inv) {
  Tile<T> a{};
  a.emb = static_cast<const T*>(emb);
  a.kwh = static_cast<const T*>(kwh);
  a.inten = static_cast<const T*>(inten);
  a.freq = static_cast<const T*>(freq);
  a.valid = static_cast<const uint8_t*>(valid);
  a.cell_idx = static_cast<const int32_t*>(cell_idx);
  a.best_total = static_cast<T*>(best_total);
  a.best_core = static_cast<int32_t*>(best_core);
  a.counts = static_cast<int32_t*>(counts);
  a.sum_best = static_cast<T*>(sum_best);
  a.min_best = static_cast<T*>(min_best);
  a.max_best = static_cast<T*>(max_best);
  a.sum_emb = static_cast<T*>(sum_emb);
  a.sum_op = static_cast<T*>(sum_op);
  a.ch_op = static_cast<T*>(ch_op);
  a.ch_draw = static_cast<int32_t*>(ch_draw);
  a.ch_life = static_cast<T*>(ch_life);
  a.ch_bin = static_cast<int32_t*>(ch_bin);
  a.hist = static_cast<int32_t*>(hist);
  a.n_cells = n_cells;
  a.n_draws = n_draws;
  a.n_cand = n_cand;
  a.n_hist = n_hist;
  a.n_par = n_par;
  a.hist_lo = static_cast<T>(hist_lo);
  a.hist_inv = static_cast<T>(hist_inv);
  a.par_lo = static_cast<T>(par_lo);
  a.par_inv = static_cast<T>(par_inv);
  return a;
}

bool bad_sizes(int n_cells, int n_draws, int n_cand, int n_hist, int n_par) {
  return n_cells <= 0 || n_draws <= 0 || n_cand <= 0 || n_hist <= 0 ||
         n_par <= 0;
}

}  // namespace

// Plain C entries for ctypes: every pointer is a device pointer, `stream`
// a cudaStream_t, `f64` selects double over float. The bin scalars (and
// day_s) arrive as doubles and are rounded to the tile's type here, as JAX
// rounds a Python float that meets a float32 array. Each returns the first
// CUDA error of its two launches (0 = success).

// Build (a): lifetimes read from `life` (Tc, N), in days.
extern "C" int carbon_sweep_launch(
    int f64, const void* emb, const void* kwh, const void* inten,
    const void* freq, const void* life, const void* valid,
    const void* cell_idx, void* best_total, void* best_core, void* counts,
    void* sum_best, void* min_best, void* max_best, void* sum_emb,
    void* sum_op, void* ch_op, void* ch_draw, void* ch_life, void* ch_bin,
    void* hist, void* par_op, void* par_emb, void* par_life, void* par_cell,
    void* par_draw, void* par_core, int n_cells, int n_draws, int n_cand,
    int n_hist, int n_par, double hist_lo, double hist_inv, double par_lo,
    double par_inv, void* stream) {
  if (bad_sizes(n_cells, n_draws, n_cand, n_hist, n_par) || !best_core)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define CS_ARGS                                                               \
  emb, kwh, inten, freq, valid, cell_idx, best_total, best_core, counts,      \
      sum_best, min_best, max_best, sum_emb, sum_op, ch_op, ch_draw, ch_life, \
      ch_bin, hist, n_cells, n_draws, n_cand, n_hist, n_par, hist_lo,         \
      hist_inv, par_lo, par_inv
#define CS_PAR par_op, par_emb, par_life, par_cell, par_draw, par_core, s
  if (f64) {
    Tile<double> a = tile_of<double>(CS_ARGS);
    a.life = static_cast<const double*>(life);
    return launch<double, false>(a, emb, cell_idx, CS_PAR);
  }
  Tile<float> a = tile_of<float>(CS_ARGS);
  a.life = static_cast<const float*>(life);
  return launch<float, false>(a, emb, cell_idx, CS_PAR);
}

// Build (b): lifetimes drawn in the kernel from the sweep's key (key0,
// key1) and the cells' distribution rows: kind (Tc, n_comp) int32, p1 and
// p2 (Tc, n_comp), cum (Tc, n_cum). `life_out` (Tc, N) and `best_core`
// may be null.
extern "C" int carbon_sweep_drawn_launch(
    int f64, uint32_t key0, uint32_t key1, const void* kind, const void* p1,
    const void* p2, const void* cum, int n_comp, int n_cum, double day_s,
    const void* emb, const void* kwh, const void* inten, const void* freq,
    const void* valid, const void* cell_idx, void* life_out,
    void* best_total, void* best_core, void* counts, void* sum_best,
    void* min_best, void* max_best, void* sum_emb, void* sum_op, void* ch_op,
    void* ch_draw, void* ch_life, void* ch_bin, void* hist, void* par_op,
    void* par_emb, void* par_life, void* par_cell, void* par_draw,
    void* par_core, int n_cells, int n_draws, int n_cand, int n_hist,
    int n_par, double hist_lo, double hist_inv, double par_lo,
    double par_inv, void* stream) {
  if (bad_sizes(n_cells, n_draws, n_cand, n_hist, n_par) || n_comp <= 0 ||
      n_cum <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64) {
    Tile<double> a = tile_of<double>(CS_ARGS);
    a.kind = static_cast<const int32_t*>(kind);
    a.p1 = static_cast<const double*>(p1);
    a.p2 = static_cast<const double*>(p2);
    a.cum = static_cast<const double*>(cum);
    a.n_comp = n_comp;
    a.n_cum = n_cum;
    a.key0 = key0;
    a.key1 = key1;
    a.day_s = day_s;
    a.life_out = static_cast<double*>(life_out);
    return launch<double, true>(a, emb, cell_idx, CS_PAR);
  }
  Tile<float> a = tile_of<float>(CS_ARGS);
  a.kind = static_cast<const int32_t*>(kind);
  a.p1 = static_cast<const float*>(p1);
  a.p2 = static_cast<const float*>(p2);
  a.cum = static_cast<const float*>(cum);
  a.n_comp = n_comp;
  a.n_cum = n_cum;
  a.key0 = key0;
  a.key1 = key1;
  a.day_s = static_cast<float>(day_s);
  a.life_out = static_cast<float*>(life_out);
  return launch<float, true>(a, emb, cell_idx, CS_PAR);
#undef CS_ARGS
#undef CS_PAR
}
