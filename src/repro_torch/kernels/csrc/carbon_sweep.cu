// sweep_tile on Hopper: the carbon sweep's evaluate-and-reduce kernel.
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
// Design. The TPU kernel walks row tiles in order on one core and carries
// the accumulators from grid step to grid step. Here the cells run in
// parallel in two launches on one stream:
//   pass A, one block per cell, threads striding over the draws: each
//     draw's totals in the reference's op order (carbon_sweep.cuh, FMA-free
//     whatever the flags), the argmin, the per-draw outputs, counts and
//     histogram bins in shared-memory int atomics (exact in any order; the
//     block adds its bins to the running histogram with global int atomics
//     when the cell is valid), per-thread sums / min / max and per-
//     candidate champion draws reduced in a fixed tree order (so a run is
//     bit-identical to any other), and the (cell, candidate) champions
//     written to a scratch buffer;
//   pass B, one block per Pareto bin: the least alive champion of the bin
//     (valid cell, op < inf) by a tree reduction under the strict total
//     order (op, cell, draw), merged into the running accumulator by
//     _pareto_merge's rule. A strict total order makes any reduction order
//     give the reference's frontier exactly.
//
// What bounds it: bytes. At the main path's tile (Tc = 1,024, N = 4,096,
// C = 9, float32) it reads 16.8 MB of lifetimes and writes 33.6 MB of
// best_total / best_core, about 50.4 MB or 0.0150 ms at 3.35 TB/s; its
// 1.5e8 float32 operations (two multiplies, one add and one compare per
// candidate and draw) take about 0.002 ms at 67 TFLOP/s. The per-cell
// tree reductions and the shared-memory histogram atomics are its
// overheads above that bound; making them cheaper is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "carbon_sweep.cuh"

namespace {

constexpr int kMaxBlock = 256;
constexpr int kParetoBlock = 256;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ float inf_of<float>() { return CUDART_INF_F; }
template <>
__device__ __forceinline__ double inf_of<double>() { return CUDART_INF; }

template <typename T>
size_t cells_smem(int n_cand, int n_hist, int bd) {
  return sizeof(T) * (2 * static_cast<size_t>(n_cand) + 5 * bd +
                      static_cast<size_t>(n_cand) * bd) +
         sizeof(int32_t) * (static_cast<size_t>(n_cand) * bd + n_cand + n_hist);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlock) sweep_cells_kernel(
    const T* __restrict__ emb, const T* __restrict__ kwh,
    const T* __restrict__ inten, const T* __restrict__ freq,
    const T* __restrict__ life, const uint8_t* __restrict__ valid,
    int32_t n_draws, int32_t n_cand, int32_t n_hist, T hist_lo, T hist_inv,
    T* __restrict__ best_total, int32_t* __restrict__ best_core,
    int32_t* __restrict__ counts, T* __restrict__ sum_best,
    T* __restrict__ min_best, T* __restrict__ max_best,
    T* __restrict__ sum_emb, T* __restrict__ sum_op, T* __restrict__ ch_op,
    int32_t* __restrict__ ch_draw, T* __restrict__ ch_life,
    int32_t* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int C = n_cand;
  const size_t cell = blockIdx.x;
  T* s_emb = reinterpret_cast<T*>(smem);
  T* s_base = s_emb + C;
  T* r_sum = s_base + C;
  T* r_emb = r_sum + bd;
  T* r_op = r_emb + bd;
  T* r_min = r_op + bd;
  T* r_max = r_min + bd;
  T* c_op = r_max + bd;                                  // [C][bd]
  int32_t* c_draw = reinterpret_cast<int32_t*>(c_op + C * bd);  // [C][bd]
  int32_t* s_cnt = c_draw + C * bd;
  int32_t* s_hist = s_cnt + C;

  const T inf = inf_of<T>();
  const T in_c = inten[cell];
  for (int c = tid; c < C; c += bd) {
    s_emb[c] = emb[cell * C + c];
    s_base[c] = csweep::mul(kwh[cell * C + c], in_c);
    s_cnt[c] = 0;
  }
  for (int b = tid; b < n_hist; b += bd) s_hist[b] = 0;
  for (int c = 0; c < C; ++c) {
    c_op[c * bd + tid] = inf;
    c_draw[c * bd + tid] = csweep::kIMax;
  }
  __syncthreads();

  const T fr = freq[cell];
  const bool ok = valid[cell] != 0;
  const T* lrow = life + cell * n_draws;
  T sum = T(0), se = T(0), so = T(0), mn = inf, mx = -inf;
  for (int d = tid; d < n_draws; d += bd) {
    T bt, bo;
    const int32_t bc =
        csweep::argmin_draw(s_emb, s_base, lrow[d], fr, C, &bt, &bo);
    best_total[cell * n_draws + d] = bt;
    best_core[cell * n_draws + d] = bc;
    sum = csweep::add(sum, bt);
    se = csweep::add(se, s_emb[bc]);
    so = csweep::add(so, bo);
    mn = csweep::nan_min(mn, bt);
    mx = csweep::nan_max(mx, bt);
    atomicAdd(&s_cnt[bc], 1);
    if (ok) atomicAdd(&s_hist[csweep::log_bin(bt, hist_lo, hist_inv, n_hist)], 1);
    const int k = bc * bd + tid;
    if (csweep::champion_takes(bo, d, c_op[k], c_draw[k])) {
      c_op[k] = bo;
      c_draw[k] = d;
    }
  }
  r_sum[tid] = sum;
  r_emb[tid] = se;
  r_op[tid] = so;
  r_min[tid] = mn;
  r_max[tid] = mx;
  __syncthreads();
  for (int s = bd / 2; s > 0; s >>= 1) {     // bd is a power of two
    if (tid < s) {
      r_sum[tid] = csweep::add(r_sum[tid], r_sum[tid + s]);
      r_emb[tid] = csweep::add(r_emb[tid], r_emb[tid + s]);
      r_op[tid] = csweep::add(r_op[tid], r_op[tid + s]);
      r_min[tid] = csweep::nan_min(r_min[tid], r_min[tid + s]);
      r_max[tid] = csweep::nan_max(r_max[tid], r_max[tid + s]);
      for (int c = 0; c < C; ++c) {
        const int a = c * bd + tid, b = a + s;
        if (csweep::champion_takes(c_op[b], c_draw[b], c_op[a], c_draw[a])) {
          c_op[a] = c_op[b];
          c_draw[a] = c_draw[b];
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    sum_best[cell] = r_sum[0];
    sum_emb[cell] = r_emb[0];
    sum_op[cell] = r_op[0];
    min_best[cell] = r_min[0];
    max_best[cell] = r_max[0];
  }
  for (int c = tid; c < C; c += bd) {
    counts[cell * C + c] = s_cnt[c];
    const int32_t dr = c_draw[c * bd];
    ch_op[cell * C + c] = c_op[c * bd];
    ch_draw[cell * C + c] = dr;
    ch_life[cell * C + c] = dr == csweep::kIMax ? T(0) : lrow[dr];
  }
  if (ok)
    for (int b = tid; b < n_hist; b += bd)
      if (s_hist[b]) atomicAdd(&hist[b], s_hist[b]);
}

template <typename T>
__global__ void __launch_bounds__(kParetoBlock) sweep_pareto_kernel(
    const T* __restrict__ emb, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ cell_idx, const T* __restrict__ ch_op,
    const int32_t* __restrict__ ch_draw, const T* __restrict__ ch_life,
    int32_t n_cells, int32_t n_cand, int32_t n_par, T par_lo, T par_inv,
    T* __restrict__ par_op, T* __restrict__ par_emb, T* __restrict__ par_life,
    int32_t* __restrict__ par_cell, int32_t* __restrict__ par_draw,
    int32_t* __restrict__ par_core) {
  __shared__ T k_op[kParetoBlock];
  __shared__ int32_t k_cell[kParetoBlock], k_draw[kParetoBlock];
  __shared__ int64_t k_idx[kParetoBlock];
  const int tid = threadIdx.x;
  const int bin = blockIdx.x;
  const T inf = inf_of<T>();
  // the empty key (inf, IMAX, IMAX) never comes before an alive champion
  T bo = inf;
  int32_t bcell = csweep::kIMax, bdraw = csweep::kIMax;
  int64_t bidx = -1;
  const int64_t n = static_cast<int64_t>(n_cells) * n_cand;
  for (int64_t i = tid; i < n; i += kParetoBlock) {
    const int64_t r = i / n_cand;
    const T o = ch_op[i];
    if (!valid[r] || !(o < inf)) continue;            // not alive
    if (csweep::log_bin(emb[i], par_lo, par_inv, n_par) != bin) continue;
    const int32_t cl = cell_idx[r], dr = ch_draw[i];
    if (csweep::pareto_takes(o, cl, dr, bo, bcell, bdraw)) {
      bo = o;
      bcell = cl;
      bdraw = dr;
      bidx = i;
    }
  }
  k_op[tid] = bo;
  k_cell[tid] = bcell;
  k_draw[tid] = bdraw;
  k_idx[tid] = bidx;
  __syncthreads();
  for (int s = kParetoBlock / 2; s > 0; s >>= 1) {
    if (tid < s && csweep::pareto_takes(k_op[tid + s], k_cell[tid + s],
                                        k_draw[tid + s], k_op[tid],
                                        k_cell[tid], k_draw[tid])) {
      k_op[tid] = k_op[tid + s];
      k_cell[tid] = k_cell[tid + s];
      k_draw[tid] = k_draw[tid + s];
      k_idx[tid] = k_idx[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0 && k_idx[0] >= 0 &&
      csweep::pareto_takes(k_op[0], k_cell[0], k_draw[0], par_op[bin],
                           par_cell[bin], par_draw[bin])) {
    const int64_t i = k_idx[0];
    par_op[bin] = k_op[0];
    par_emb[bin] = emb[i];
    par_life[bin] = ch_life[i];
    par_cell[bin] = k_cell[0];
    par_draw[bin] = k_draw[0];
    par_core[bin] = static_cast<int32_t>(i % n_cand);
  }
}

template <typename T>
int launch(const void* emb, const void* kwh, const void* inten,
           const void* freq, const void* life, const void* valid,
           const void* cell_idx, void* best_total, void* best_core,
           void* counts, void* sum_best, void* min_best, void* max_best,
           void* sum_emb, void* sum_op, void* ch_op, void* ch_draw,
           void* ch_life, void* hist, void* par_op, void* par_emb,
           void* par_life, void* par_cell, void* par_draw, void* par_core,
           int n_cells, int n_draws, int n_cand, int n_hist, int n_par,
           double hist_lo, double hist_inv, double par_lo, double par_inv,
           cudaStream_t stream) {
  // a power-of-two block no wider than the draws (at least one warp),
  // halved until the per-candidate champion columns fit shared memory
  int bd = 32;
  while (bd < kMaxBlock && bd < n_draws) bd *= 2;
  size_t smem = cells_smem<T>(n_cand, n_hist, bd);
  while (smem > kMaxSmem && bd > 32) {
    bd /= 2;
    smem = cells_smem<T>(n_cand, n_hist, bd);
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_cells_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const T* e_ = static_cast<const T*>(emb);
  const uint8_t* v_ = static_cast<const uint8_t*>(valid);
  T* co = static_cast<T*>(ch_op);
  int32_t* cd = static_cast<int32_t*>(ch_draw);
  T* cl = static_cast<T*>(ch_life);
  sweep_cells_kernel<T><<<n_cells, bd, smem, stream>>>(
      e_, static_cast<const T*>(kwh), static_cast<const T*>(inten),
      static_cast<const T*>(freq), static_cast<const T*>(life), v_, n_draws,
      n_cand, n_hist, static_cast<T>(hist_lo), static_cast<T>(hist_inv),
      static_cast<T*>(best_total), static_cast<int32_t*>(best_core),
      static_cast<int32_t*>(counts), static_cast<T*>(sum_best),
      static_cast<T*>(min_best), static_cast<T*>(max_best),
      static_cast<T*>(sum_emb), static_cast<T*>(sum_op), co, cd, cl,
      static_cast<int32_t*>(hist));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_pareto_kernel<T><<<n_par, kParetoBlock, 0, stream>>>(
      e_, v_, static_cast<const int32_t*>(cell_idx), co, cd, cl, n_cells,
      n_cand, n_par, static_cast<T>(par_lo), static_cast<T>(par_inv),
      static_cast<T*>(par_op), static_cast<T*>(par_emb),
      static_cast<T*>(par_life), static_cast<int32_t*>(par_cell),
      static_cast<int32_t*>(par_draw), static_cast<int32_t*>(par_core));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes: every pointer is a device pointer, `stream` a
// cudaStream_t, `f64` selects double over float. The four bin scalars
// arrive as doubles and are rounded to the tile's type here, as JAX
// rounds a Python float that meets a float32 array. Returns the first
// CUDA error of the two launches (0 = success).
extern "C" int carbon_sweep_launch(
    int f64, const void* emb, const void* kwh, const void* inten,
    const void* freq, const void* life, const void* valid,
    const void* cell_idx, void* best_total, void* best_core, void* counts,
    void* sum_best, void* min_best, void* max_best, void* sum_emb,
    void* sum_op, void* ch_op, void* ch_draw, void* ch_life, void* hist,
    void* par_op, void* par_emb, void* par_life, void* par_cell,
    void* par_draw, void* par_core, int n_cells, int n_draws, int n_cand,
    int n_hist, int n_par, double hist_lo, double hist_inv, double par_lo,
    double par_inv, void* stream) {
  if (n_cells <= 0 || n_draws <= 0 || n_cand <= 0 || n_hist <= 0 ||
      n_par <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64)
    return launch<double>(emb, kwh, inten, freq, life, valid, cell_idx,
                          best_total, best_core, counts, sum_best, min_best,
                          max_best, sum_emb, sum_op, ch_op, ch_draw, ch_life,
                          hist, par_op, par_emb, par_life, par_cell, par_draw,
                          par_core, n_cells, n_draws, n_cand, n_hist, n_par,
                          hist_lo, hist_inv, par_lo, par_inv, s);
  return launch<float>(emb, kwh, inten, freq, life, valid, cell_idx,
                       best_total, best_core, counts, sum_best, min_best,
                       max_best, sum_emb, sum_op, ch_op, ch_draw, ch_life,
                       hist, par_op, par_emb, par_life, par_cell, par_draw,
                       par_core, n_cells, n_draws, n_cand, n_hist, n_par,
                       hist_lo, hist_inv, par_lo, par_inv, s);
}
