// Per-draw and per-bin arithmetic of the carbon-sweep kernel.
//
// Shared by csrc/carbon_sweep.cu (compiled by nvcc for sm_90a) and by the
// CPU tests, which compile it as plain C++ with g++ -ffp-contract=off and
// hold it against the plain PyTorch version (sweep_tile_plain). Every
// function is __host__ __device__; nothing here touches memory beyond
// its arguments.
//
// Rounding. The reference evaluates `emb + ((kwh * inten) * life) * freq`
// as separate multiplies and one add, each rounded on its own, and blocks
// XLA's FMA contraction with an `abs` (src/repro/kernels/carbon_sweep.py,
// _totals). Here every multiply and add goes through the round-to-nearest
// intrinsics (__fmul_rn/__fadd_rn, __dmul_rn/__dadd_rn), which nvcc never
// contracts into an FMA, whatever -fmad says; on the host the test builds
// with -ffp-contract=off for the same reason.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define CS_HD __host__ __device__ __forceinline__
#else
#define CS_HD inline
#endif

namespace csweep {

constexpr int32_t kIMax = 2147483647;

CS_HD float mul(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
CS_HD double mul(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
CS_HD float add(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
CS_HD double add(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
CS_HD float sub(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
CS_HD double sub(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

CS_HD float log10_(float x) { return log10f(x); }
CS_HD double log10_(double x) { return log10(x); }
CS_HD float floor_(float x) { return floorf(x); }
CS_HD double floor_(double x) { return floor(x); }

template <typename T>
CS_HD bool is_nan(T x) { return x != x; }

// min / max that propagate NaN, as jnp.min / jnp.max do
template <typename T>
CS_HD T nan_min(T a, T b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return b < a ? b : a;
}
template <typename T>
CS_HD T nan_max(T a, T b) {
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return b > a ? b : a;
}

// Operational kg of one candidate for one draw: ((base * life) * freq),
// with base = kwh * inten computed once per cell.
template <typename T>
CS_HD T op_kg(T base, T life, T freq) { return mul(mul(base, life), freq); }

// Total kg: emb + |op|. The |.| is the reference's contraction barrier
// and an identity for op >= 0; it is kept so that any input gives the
// reference's bits.
template <typename T>
CS_HD T total_kg(T emb, T op) { return add(emb, fabs(op)); }

// Whether candidate total t replaces the best so far, bt, in a scan over
// c = 0..C-1: the first minimum wins ties and the first NaN wins over
// numbers (jnp.argmin).
template <typename T>
CS_HD bool argmin_takes(T t, T bt) {
  return t < bt || (is_nan(t) && !is_nan(bt));
}

// The chosen candidate of one draw: argmin over c = 0..C-1 of the totals
// (argmin_takes). Writes the chosen total and operational kg.
template <typename T>
CS_HD int32_t argmin_draw(const T* emb, const T* base, T life, T freq,
                          int n_cand, T* best_total, T* best_op) {
  T op = op_kg(base[0], life, freq);
  T bt = total_kg(emb[0], op);
  T bo = op;
  int32_t bc = 0;
  for (int c = 1; c < n_cand; ++c) {
    const T o = op_kg(base[c], life, freq);
    const T t = total_kg(emb[c], o);
    if (argmin_takes(t, bt)) {
      bt = t;
      bo = o;
      bc = c;
    }
  }
  *best_total = bt;
  *best_op = bo;
  return bc;
}

// floor((log10(x) - lo) * inv) clipped to [0, n_bins). XLA converts the
// floor to int32 with saturation (NaN -> 0) and then clips; converting a
// NaN or an infinity with a cast is undefined in C++, so the clip is done
// in floating point first, which gives the same bins.
template <typename T>
CS_HD int32_t log_bin(T x, T lo, T inv, int n_bins) {
  const T f = floor_(mul(sub(log10_(x), lo), inv));
  if (is_nan(f) || f < T(0)) return 0;
  if (f > T(n_bins - 1)) return n_bins - 1;
  return static_cast<int32_t>(f);
}

// Champion draw of one (cell, candidate): least op, then least draw.
// A NaN op sticks (jnp.min propagates it; such a champion is never alive).
template <typename T>
CS_HD bool champion_takes(T op, int32_t draw, T cur_op, int32_t cur_draw) {
  if (is_nan(cur_op)) return false;
  if (is_nan(op)) return true;
  return op < cur_op || (op == cur_op && draw < cur_draw);
}

// Pareto key order: (op, cell, draw) lexicographic; true when point b
// comes before point a (the reference's _pareto_merge `take_b`).
template <typename T>
CS_HD bool pareto_takes(T b_op, int32_t b_cell, int32_t b_draw, T a_op,
                        int32_t a_cell, int32_t a_draw) {
  return (b_op < a_op) || (b_op == a_op && b_cell < a_cell) ||
         (b_op == a_op && b_cell == a_cell && b_draw < a_draw);
}

}  // namespace csweep
