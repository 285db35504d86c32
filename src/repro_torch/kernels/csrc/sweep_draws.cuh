// The carbon sweep's Monte Carlo lifetime draws, one draw at a time.
//
// Shared by csrc/carbon_sweep.cu (nvcc, sm_90a) and by the CPU tests,
// which compile it as plain C++ with g++ -ffp-contract=off and hold it
// against the port's plain version (kernels/sweep_draws.py: prng.py's
// threefry bits and `lifetimes`) and the reference's `_uniforms` and
// `_lifetimes` (src/repro/core/sweep.py). Every function is
// __host__ __device__ and touches no memory beyond its arguments.
//
// - threefry2x32 (20 rounds, JAX's rotations and key schedule), fold_in
//   and the uniform of one flat counter i = (i >> 32, i & 0xffffffff):
//   float32 keeps the top 23 bits of w0 ^ w1, float64 the 52 bits
//   (w0 << 20) | (w1 >> 12), over an exponent of 1, minus 1. Bit for bit
//   jax.random's.
// - ndtri: Cephes' inverse normal CDF in the form of torch's calc_ndtri
//   (ATen/native/Math.h), its coefficients rounded to the type as torch
//   rounds its `static const T` tables.
// - the inverse-CDF mixture draw in the op order of `_lifetimes`: clamp
//   u0 to [eps, 1 - eps], pick the component with u1 against the
//   cumulative weights, then a point mass `a`, a lognormal
//   exp(a + b * ndtri(u)) or a Weibull a * pow(-log1p(-u), 1 / b), and one
//   true division by the seconds in a day.
//
// Rounding: every multiply, add, subtract and divide goes through the
// round-to-nearest helpers of carbon_sweep.cuh (never contracted into an
// FMA, whatever the flags), so the device build and the host build
// compute the same bits but for exp, log, log1p, pow, sqrt's libraries.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "carbon_sweep.cuh"

namespace sdraw {

using csweep::add;
using csweep::mul;
using csweep::sub;

// lifetime-distribution component kinds (core/sweep.py)
constexpr int32_t kPoint = 0, kLognormal = 1, kWeibull = 2;

CS_HD float div(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
CS_HD double div(double a, double b) {
#if defined(__CUDA_ARCH__)
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}

CS_HD float exp_(float x) { return expf(x); }
CS_HD double exp_(double x) { return exp(x); }
CS_HD float log_(float x) { return logf(x); }
CS_HD double log_(double x) { return log(x); }
CS_HD float log1p_(float x) { return log1pf(x); }
CS_HD double log1p_(double x) { return log1p(x); }
CS_HD float pow_(float x, float y) { return powf(x, y); }
CS_HD double pow_(double x, double y) { return pow(x, y); }
CS_HD float sqrt_(float x) { return sqrtf(x); }
CS_HD double sqrt_(double x) { return sqrt(x); }

CS_HD uint32_t rotl(uint32_t x, int r) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// Four rounds of Threefry-2x32 with rotations r0..r3.
#define SDRAW_ROUNDS(x0, x1, r0, r1, r2, r3) \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;          \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;          \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;          \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under key (k0, k1),
// in place (prng.py::threefry2x32; JAX's threefry_2x32).
CS_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                        uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  SDRAW_ROUNDS(x0, x1, 13, 15, 26, 6)
  x0 += k1;
  x1 += k2 + 1u;
  SDRAW_ROUNDS(x0, x1, 17, 29, 16, 24)
  x0 += k2;
  x1 += k0 + 2u;
  SDRAW_ROUNDS(x0, x1, 13, 15, 26, 6)
  x0 += k0;
  x1 += k1 + 3u;
  SDRAW_ROUNDS(x0, x1, 17, 29, 16, 24)
  x0 += k1;
  x1 += k2 + 4u;
  SDRAW_ROUNDS(x0, x1, 13, 15, 26, 6)
  x0 += k2;
  x1 += k0 + 5u;
}
#undef SDRAW_ROUNDS

// jax.random.fold_in(key, data): the key (k0, k1) becomes the hash of the
// counter (0, data).
CS_HD void fold_in(uint32_t& k0, uint32_t& k1, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

CS_HD float bits_to_float(uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}
CS_HD double bits_to_double(uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __longlong_as_double(static_cast<long long>(b));
#else
  double f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

// jax.random.uniform's value at flat index i of a draw under key (k0, k1).
template <typename T>
CS_HD T uniform(uint32_t k0, uint32_t k1, uint64_t i);
template <>
CS_HD float uniform<float>(uint32_t k0, uint32_t k1, uint64_t i) {
  uint32_t w0 = static_cast<uint32_t>(i >> 32), w1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, w0, w1);
  return bits_to_float(((w0 ^ w1) >> 9) | 0x3F800000u) - 1.0f;
}
template <>
CS_HD double uniform<double>(uint32_t k0, uint32_t k1, uint64_t i) {
  uint32_t w0 = static_cast<uint32_t>(i >> 32), w1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, w0, w1);
  const uint64_t b = (static_cast<uint64_t>(w0) << 20) | (w1 >> 12) |
                     0x3FF0000000000000ull;
  return bits_to_double(b) - 1.0;
}

// Horner's rule as torch's polevl: ((c0 * x + c1) * x + c2) ...
template <typename T, int N>
CS_HD T polevl(T x, const double (&c)[N]) {
  T r = T(c[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) r = add(mul(r, x), T(c[i]));
  return r;
}

// Cephes ndtri as torch's calc_ndtri: the x with Phi(x) = y0.
template <typename T>
CS_HD T ndtri(T y0) {
  // approximation for 0 <= |y - 0.5| <= 3/8
  constexpr double P0[5] = {
      -5.99633501014107895267E1, 9.80010754185999661536E1,
      -5.66762857469070293439E1, 1.39312609387279679503E1,
      -1.23916583867381258016E0};
  constexpr double Q0[9] = {
      1.00000000000000000000E0,  1.95448858338141759834E0,
      4.67627912898881538453E0,  8.63602421390890590575E1,
      -2.25462687854119370527E2, 2.00260212380060660359E2,
      -8.20372256168333339912E1, 1.59056225126211695515E1,
      -1.18331621121330003142E0};
  // z = sqrt(-2 log y) between 2 and 8
  constexpr double P1[9] = {
      4.05544892305962419923E0,  3.15251094599893866154E1,
      5.71628192246421288162E1,  4.40805073893200834700E1,
      1.46849561928858024014E1,  2.18663306850790267539E0,
      -1.40256079171354495875E-1, -3.50424626827848203418E-2,
      -8.57456785154685413611E-4};
  constexpr double Q1[9] = {
      1.00000000000000000000E0,  1.57799883256466749731E1,
      4.53907635128879210584E1,  4.13172038254672030440E1,
      1.50425385692907503408E1,  2.50464946208309415979E0,
      -1.42182922854787788574E-1, -3.80806407691578277194E-2,
      -9.33259480895457427372E-4};
  // z between 8 and 64
  constexpr double P2[9] = {
      3.23774891776946035970E0,  6.91522889068984211695E0,
      3.93881025292474443415E0,  1.33303460815807542389E0,
      2.01485389549179081538E-1, 1.23716634817820021358E-2,
      3.01581553508235416007E-4, 2.65806974686737550832E-6,
      6.23974539184983293730E-9};
  constexpr double Q2[9] = {
      1.00000000000000000000E0,  6.02427039364742014255E0,
      3.67983563856160859403E0,  1.37702099489081330271E0,
      2.16236993594496635890E-1, 1.34204006088543189037E-2,
      3.28014464682127739104E-4, 2.89247864745380683936E-6,
      6.79019408009981274425E-9};
  const T one = T(1), zero = T(0);
  const T exp_m2 = T(0.13533528323661269189);   // exp(-2)
  if (y0 == zero) return -T(INFINITY);
  if (y0 == one) return T(INFINITY);
  if (y0 < zero || y0 > one) return T(NAN);
  bool code = true;
  T y = y0;
  if (y > sub(one, exp_m2)) {
    y = sub(one, y);
    code = false;
  }
  if (y > exp_m2) {
    y = sub(y, T(0.5));
    const T y2 = mul(y, y);
    const T x = add(y, mul(y, div(mul(y2, polevl<T>(y2, P0)),
                                  polevl<T>(y2, Q0))));
    return mul(x, T(2.50662827463100050242E0));    // sqrt(2 pi)
  }
  T x = sqrt_(mul(T(-2.0), log_(y)));
  const T x0 = sub(x, div(log_(x), x));
  const T z = div(one, x);
  const T x1 = x < T(8.0)
                   ? div(mul(z, polevl<T>(z, P1)), polevl<T>(z, Q1))
                   : div(mul(z, polevl<T>(z, P2)), polevl<T>(z, Q2));
  x = sub(x0, x1);
  return code ? -x : x;
}

// The clamp of u0: [eps, 1 - eps], eps 1e-6 in float32 and 1e-12 in
// float64, each bound rounded from the double as JAX and torch round a
// Python float.
template <typename T>
CS_HD double clamp_eps() { return sizeof(T) == 8 ? 1e-12 : 1e-6; }

// One mixture draw in days. `kind`, `p1`, `p2` are the cell's K component
// rows, `cum` its n_cum cumulative weights (core/sweep.py::build_tables);
// (u0, u1) the draw's two uniforms.
template <typename T>
CS_HD T life_days(T u0, T u1, const int32_t* kind, const T* p1, const T* p2,
                  const T* cum, int n_comp, int n_cum, T day_s) {
  const double eps = clamp_eps<T>();
  const T lo = T(eps), hi = T(1.0 - eps);
  const T uc = u0 > hi ? hi : (u0 < lo ? lo : u0);
  int comp = 0;
  for (int j = 0; j < n_cum; ++j) comp += u1 >= cum[j];
  if (comp > n_comp - 1) comp = n_comp - 1;   // never, for build_tables' rows
  const int32_t k = kind[comp];
  const T a = p1[comp], b = p2[comp];
  T life;
  if (k == kPoint) {
    life = a;
  } else if (k == kLognormal) {
    life = exp_(add(a, mul(b, ndtri(uc))));
  } else {
    life = mul(a, pow_(-log1p_(-uc), div(T(1), b)));
  }
  return div(life, day_s);
}

// Draw d of a cell whose key is (k0, k1): u0 from counter 2d, u1 from
// counter 2d + 1, as `_uniforms` lays a (draws, 2) draw out.
template <typename T>
CS_HD T draw_life_days(uint32_t k0, uint32_t k1, int64_t d,
                       const int32_t* kind, const T* p1, const T* p2,
                       const T* cum, int n_comp, int n_cum, T day_s) {
  const uint64_t i = 2 * static_cast<uint64_t>(d);
  return life_days(uniform<T>(k0, k1, i), uniform<T>(k0, k1, i + 1), kind,
                   p1, p2, cum, n_comp, n_cum, day_s);
}

}  // namespace sdraw
