"""The sweep kernel's in-kernel draws (`csrc/sweep_draws.cuh`) on the CPU.

The header is built for the host with g++ -ffp-contract=off (as
`test_torch_sweep_kernel.py` builds `carbon_sweep.cuh`) and held:
- its `fold_in` and uniforms bit for bit against `prng.py` and the
  reference's `_uniforms` (`jax.random`; float64 under x64), at cells 0
  to 2**31 - 1 and at counters past 2 x 4,096;
- its lifetimes within LIFE_ULPS of the reference's `_lifetimes` and of
  the port's plain `sweep_draws.lifetimes` (libm's exp, log1p and pow are
  neither XLA's nor torch's), point masses exactly;
- a sequential model of the drawn tile, written in this file over the
  headers' helpers (draws, argmin, per-cell sums, counts, histogram,
  Pareto merge), which, given its own lifetimes (`life_out`), equals
  `sweep_tile_plain` under `assert_streams_equal`. It is not the
  kernel's pass A or pass B (their shuffles and shared-memory columns
  run on the card only); the `gpu` tests hold the kernel itself against
  `sweep_tile_drawn_plain`.
The plain drawn tile (`sweep_tile_drawn_plain`) equals the CPU sweep's
own tile bit for bit.
"""
import ctypes
import dataclasses
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from repro.core import sweep as rs
from repro_torch import convert, prng
from repro_torch.core import sweep as ps
from repro_torch.kernels import carbon_sweep as pcs
from repro_torch.kernels import sweep_draws as pdraws
from test_sweep import _mixture_spec
from test_torch_sweep import _ref_life_days
from test_torch_sweep_kernel import CSRC

DTYPES = {"f32": np.float32, "f64": np.float64}

SHIM = r"""
#include <limits>
#include <vector>

#include "sweep_draws.cuh"

extern "C" void fold_in_host(uint32_t k0, uint32_t k1, const int32_t* data,
                             int n, uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    uint32_t a = k0, b = k1;
    sdraw::fold_in(a, b, uint32_t(data[i]));
    out[2 * i] = a;
    out[2 * i + 1] = b;
  }
}

// (n, 2 n_draws) uniforms of each cell's key; (n, n_draws) lifetimes in
// days of each cell's rows.
template <typename T>
static void draws_host(uint32_t k0, uint32_t k1, const int32_t* cell, int n,
                       int n_draws, const int32_t* kind, const T* p1,
                       const T* p2, const T* cum, int K, int Kc,
                       double day_s, T* u, T* life) {
  for (int r = 0; r < n; ++r) {
    uint32_t a = k0, b = k1;
    sdraw::fold_in(a, b, uint32_t(cell[r]));
    for (long i = 0; i < 2L * n_draws; ++i)
      u[r * 2L * n_draws + i] = sdraw::uniform<T>(a, b, uint64_t(i));
    for (int d = 0; d < n_draws; ++d)
      life[long(r) * n_draws + d] = sdraw::draw_life_days<T>(
          a, b, d, kind + r * K, p1 + r * K, p2 + r * K, cum + r * Kc, K, Kc,
          T(day_s));
  }
}

// A sequential model of one drawn tile over the headers' helpers (not
// the kernel's passes): per cell the draws, argmin, sums, counts,
// min/max, histogram and champion draws (their lifetimes drawn again),
// then per Pareto bin the least alive champion, merged into the
// accumulators.
template <typename T>
static void tile_drawn_host(
    uint32_t key0, uint32_t key1, const int32_t* kind, const T* p1,
    const T* p2, const T* cum, int K, int Kc, double day_s, const T* emb,
    const T* kwh, const T* inten, const T* freq, const uint8_t* valid,
    const int32_t* cell_idx, T* life_out, T* best_total, int32_t* best_core,
    int32_t* counts, T* sum_best, T* min_best, T* max_best, T* sum_emb,
    T* sum_op, int32_t* hist, T* par_op, T* par_emb, T* par_life,
    int32_t* par_cell, int32_t* par_draw, int32_t* par_core, int n_cells,
    int N, int C, int n_hist, int n_par, double hist_lo, double hist_inv,
    double par_lo, double par_inv) {
  const T inf = std::numeric_limits<T>::infinity();
  const T hlo = T(hist_lo), hinv = T(hist_inv), plo = T(par_lo),
          pinv = T(par_inv), ds = T(day_s);
  std::vector<T> base(C), ch_op(size_t(n_cells) * C), ch_life(ch_op.size());
  std::vector<int32_t> ch_draw(ch_op.size());
  for (int r = 0; r < n_cells; ++r) {
    uint32_t k0 = key0, k1 = key1;
    sdraw::fold_in(k0, k1, uint32_t(cell_idx[r]));
    const int32_t* kr = kind + r * K;
    const T *ar = p1 + r * K, *br = p2 + r * K, *cr = cum + r * Kc;
    for (int c = 0; c < C; ++c) {
      base[c] = csweep::mul(kwh[r * C + c], inten[r]);
      counts[r * C + c] = 0;
      ch_op[r * C + c] = inf;
      ch_draw[r * C + c] = csweep::kIMax;
    }
    T s = T(0), se = T(0), so = T(0), mn = inf, mx = -inf;
    for (int d = 0; d < N; ++d) {
      const T life = sdraw::draw_life_days<T>(k0, k1, d, kr, ar, br, cr, K,
                                              Kc, ds);
      life_out[long(r) * N + d] = life;
      T bt, bo;
      const int32_t bc = csweep::argmin_draw(emb + r * C, base.data(), life,
                                             freq[r], C, &bt, &bo);
      best_total[long(r) * N + d] = bt;
      best_core[long(r) * N + d] = bc;
      s = csweep::add(s, bt);
      se = csweep::add(se, emb[r * C + bc]);
      so = csweep::add(so, bo);
      counts[r * C + bc] += 1;
      mn = csweep::nan_min(mn, bt);
      mx = csweep::nan_max(mx, bt);
      if (valid[r]) hist[csweep::log_bin(bt, hlo, hinv, n_hist)] += 1;
      const int k = r * C + bc;
      if (csweep::champion_takes(bo, d, ch_op[k], ch_draw[k])) {
        ch_op[k] = bo;
        ch_draw[k] = d;
      }
    }
    sum_best[r] = s;
    sum_emb[r] = se;
    sum_op[r] = so;
    min_best[r] = mn;
    max_best[r] = mx;
    for (int c = 0; c < C; ++c) {
      const int32_t dr = ch_draw[r * C + c];
      ch_life[r * C + c] =
          dr == csweep::kIMax
              ? T(0)
              : sdraw::draw_life_days<T>(k0, k1, dr, kr, ar, br, cr, K, Kc,
                                         ds);
    }
  }
  for (int b = 0; b < n_par; ++b) {
    T bo = inf;
    int32_t bcell = csweep::kIMax, bdraw = csweep::kIMax;
    long bidx = -1;
    for (long i = 0; i < long(n_cells) * C; ++i) {
      const long r = i / C;
      if (!valid[r] || !(ch_op[i] < inf)) continue;
      if (csweep::log_bin(emb[i], plo, pinv, n_par) != b) continue;
      if (csweep::pareto_takes(ch_op[i], cell_idx[r], ch_draw[i], bo, bcell,
                               bdraw)) {
        bo = ch_op[i];
        bcell = cell_idx[r];
        bdraw = ch_draw[i];
        bidx = i;
      }
    }
    if (bidx >= 0 && csweep::pareto_takes(bo, bcell, bdraw, par_op[b],
                                          par_cell[b], par_draw[b])) {
      par_op[b] = bo;
      par_emb[b] = emb[bidx];
      par_life[b] = ch_life[bidx];
      par_cell[b] = bcell;
      par_draw[b] = bdraw;
      par_core[b] = int32_t(bidx % C);
    }
  }
}

#define ENTRIES(SUFFIX, T)                                                   \
  extern "C" void draws_##SUFFIX(uint32_t k0, uint32_t k1,                   \
                                 const int32_t* cell, int n, int n_draws,    \
                                 const int32_t* kind, const T* p1,           \
                                 const T* p2, const T* cum, int K, int Kc,   \
                                 double day_s, T* u, T* life) {              \
    draws_host<T>(k0, k1, cell, n, n_draws, kind, p1, p2, cum, K, Kc, day_s, \
                  u, life);                                                  \
  }                                                                          \
  extern "C" void tile_drawn_##SUFFIX(                                       \
      uint32_t k0, uint32_t k1, const int32_t* kind, const T* p1,            \
      const T* p2, const T* cum, int K, int Kc, double day_s, const T* emb,  \
      const T* kwh, const T* inten, const T* freq, const uint8_t* valid,     \
      const int32_t* cell_idx, T* life_out, T* best_total,                   \
      int32_t* best_core, int32_t* counts, T* sum_best, T* min_best,         \
      T* max_best, T* sum_emb, T* sum_op, int32_t* hist, T* par_op,          \
      T* par_emb, T* par_life, int32_t* par_cell, int32_t* par_draw,         \
      int32_t* par_core, int n_cells, int N, int C, int n_hist, int n_par,   \
      double hist_lo, double hist_inv, double par_lo, double par_inv) {      \
    tile_drawn_host<T>(k0, k1, kind, p1, p2, cum, K, Kc, day_s, emb, kwh,    \
                       inten, freq, valid, cell_idx, life_out, best_total,   \
                       best_core, counts, sum_best, min_best, max_best,      \
                       sum_emb, sum_op, hist, par_op, par_emb, par_life,     \
                       par_cell, par_draw, par_core, n_cells, N, C, n_hist,  \
                       n_par, hist_lo, hist_inv, par_lo, par_inv);           \
  }
ENTRIES(f32, float)
ENTRIES(f64, double)
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "sweep_draws.cuh cannot be compiled here")
    d = tmp_path_factory.mktemp("sweep_draws_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libsweep_draws_host.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                           "-shared", "-fPIC", "-I", str(CSRC), "-o",
                           str(so), str(d / "shim.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I, D, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_uint32)
    lib.fold_in_host.argtypes = [U, U, P, I, P]
    for t in ("f32", "f64"):
        getattr(lib, f"draws_{t}").argtypes = [U, U, P, I, I, P, P, P, P, I,
                                               I, D, P, P]
        getattr(lib, f"tile_drawn_{t}").argtypes = (
            [U, U] + [P] * 4 + [I, I, D] + [P] * 22 + [I] * 5 + [D] * 4)
    for fn in ("fold_in_host", "draws_f32", "draws_f64", "tile_drawn_f32",
               "tile_drawn_f64"):
        getattr(lib, fn).restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data


def _host_draws(lib, key, cell, draws, rows, dtype):
    """(uniforms (n, draws, 2), lifetimes (n, draws)) of the host build
    for `cell` under `key`, with the cells' mixture `rows`."""
    kind, p1, p2, cum = (np.ascontiguousarray(r) for r in rows)
    n = len(cell)
    u = np.empty((n, draws, 2), dtype)
    life = np.empty((n, draws), dtype)
    fn = lib.draws_f64 if dtype == np.float64 else lib.draws_f32
    fn(key[0], key[1], _ptr(cell), n, draws, _ptr(kind), _ptr(p1), _ptr(p2),
       _ptr(cum), kind.shape[1], cum.shape[1], tp.DAY_S, _ptr(u), _ptr(life))
    return u, life


def _draw_spec(draws=64, seed=11):
    return dataclasses.replace(tp.sweep_mixture_spec(draws=draws, seed=seed),
                               dists=tp.drawn_dists())


def test_fold_in_matches_prng_and_jax(host_lib):
    data = np.array([0, 1, 7, 4096, 8191, 123_456_789, 2**31 - 1], np.int32)
    for seed in (0, 7, 2**33 + 5):
        for x64 in (False, True):
            key = prng.prng_key(seed, x64=x64)
            got = np.empty((len(data), 2), np.uint32)
            host_lib.fold_in_host(key[0], key[1], _ptr(data), len(data),
                                  _ptr(got))
            k0, k1 = prng.fold_in(key, torch.from_numpy(data))
            np.testing.assert_array_equal(got[:, 0], k0.numpy())
            np.testing.assert_array_equal(got[:, 1], k1.numpy())
            with jax.enable_x64(x64):
                ref = np.stack([np.asarray(jax.random.key_data(
                    jax.random.fold_in(jax.random.PRNGKey(seed), int(i))))
                    for i in data])
            np.testing.assert_array_equal(got, ref.astype(np.uint32))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_uniform_bits_match_prng_and_reference(host_lib, dt):
    """Cells 0 to 2**31 - 1, counters up to 2 x 4,100 (past 2 x 4,096):
    the header's uniforms equal `prng.uniform` and the reference's
    `_uniforms` bit for bit."""
    dtype = DTYPES[dt]
    x64 = dtype == np.float64
    cell = np.array([0, 1, 1023, 15_839, 2**31 - 1], np.int32)
    draws, seed = 4100, 3
    key = prng.prng_key(seed, x64=x64)
    rows = (np.zeros((5, 1), np.int32), np.ones((5, 1), dtype),
            np.ones((5, 1), dtype), np.ones((5, 1), dtype))
    u, _ = _host_draws(host_lib, key, cell, draws, rows, dtype)
    plain = pdraws.uniforms(key, torch.from_numpy(cell), draws,
                            torch.float64 if x64 else torch.float32).numpy()
    np.testing.assert_array_equal(tp.ulps(u, plain), 0)
    with jax.enable_x64(x64):
        ref = np.asarray(rs._uniforms(jax.random.PRNGKey(seed),
                                      jnp.asarray(cell), draws,
                                      jnp.dtype(dtype)))
    np.testing.assert_array_equal(tp.ulps(u, ref), 0)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_lifetimes_within_ulps_of_reference_and_plain(host_lib, dt):
    """Every cell of a spec over `drawn_dists()` (lognormal, Weibull,
    point masses, mixtures): the header's lifetimes in days within
    LIFE_ULPS of the reference's and of the port's plain version, point
    masses exactly."""
    dtype = DTYPES[dt]
    ref_spec = dataclasses.replace(_mixture_spec(draws=64, seed=11),
                                   dists=tp.drawn_dists(rs.LifetimeDist))
    spec = convert.sweep_spec_from(ref_spec)
    tdt = ps._torch_dtype(dtype)
    step = ps._Step(spec, spec.n_cells, tdt, 64, 32, torch.device("cpu"))
    cell = np.arange(spec.n_cells, dtype=np.int32)
    _, di, *_ = step.decode(torch.from_numpy(cell))
    rows = (step.kind[di].numpy(), step.p1[di].numpy(), step.p2[di].numpy(),
            step.cum[di].numpy())
    u, got = _host_draws(host_lib, step.key, cell, spec.draws, rows, dtype)
    plain = step.life_days(torch.from_numpy(cell), di).numpy()
    ref = _ref_life_days(ref_spec, dtype)(cell)
    # the draws whose component is a point mass
    comp = (u[..., 1][..., None] >= rows[3][:, None, :]).sum(-1)
    point = np.take_along_axis(rows[0], comp, 1) == ps.POINT
    assert point.any() and not point.all()
    for name, want in (("plain", plain), ("reference", ref)):
        d = tp.ulps(want, got)
        assert d.max() <= tp.LIFE_ULPS[dtype], (name, d.max())
        assert (d[point] == 0).all(), name


def _host_stream(lib, cases, dtype):
    """The host walk over the drawn tiles: TileOuts, accumulators and
    lifetimes, as `tp.port_stream_drawn` gives them."""
    acc = convert.sweep_acc_to_numpy(pcs.init_acc(
        64, 32, torch.float64 if dtype == np.float64 else torch.float32,
        "cpu"))
    fn = lib.tile_drawn_f64 if dtype == np.float64 else lib.tile_drawn_f32
    outs, accs, lifes = [], [], []
    for case in cases:
        n_cells, n_cand = case["emb"].shape
        N = case["n_draws"]
        life = np.empty((n_cells, N), dtype)
        out = pcs.TileOut(np.empty((n_cells, N), dtype),
                          np.empty((n_cells, N), np.int32),
                          np.empty((n_cells, n_cand), np.int32),
                          *(np.empty(n_cells, dtype) for _ in range(5)))
        acc = pcs.SweepAcc(*(np.array(x, copy=True) for x in acc))
        ins = [np.ascontiguousarray(case[k]) for k in tp.DRAWN_ORDER]
        ins[8] = ins[8].astype(np.uint8)                   # valid
        kind, p1, p2, cum = ins[:4]
        fn(case["key"][0], case["key"][1], _ptr(kind), _ptr(p1), _ptr(p2),
           _ptr(cum), kind.shape[1], cum.shape[1], tp.DAY_S,
           *(_ptr(a) for a in ins[4:]), _ptr(life), *(_ptr(a) for a in out),
           *(_ptr(a) for a in acc), n_cells, N, n_cand, 64, 32,
           *(tp.TILE_KW[k] for k in ("hist_lo", "hist_inv", "par_lo",
                                     "par_inv")))
        outs.append(out)
        accs.append(acc)
        lifes.append(life)
    return outs, accs, lifes


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_host_drawn_tile_matches_plain_given_its_lifetimes(host_lib, dt):
    """Three streamed drawn tiles (40 draws, 3-4 candidates, invalid
    cells): the host model's lifetimes within LIFE_ULPS of the plain drawn
    tile's, and, fed its own lifetimes, `sweep_tile_plain` equals it."""
    dtype = DTYPES[dt]
    cases = tp.drawn_stream_cases(np.random.default_rng(41), dtype,
                                  n_draws=40)
    outs, accs, lifes = _host_stream(host_lib, cases, dtype)
    _, _, plain_lifes = tp.port_stream_drawn(cases, dtype)
    for a, b in zip(plain_lifes, lifes):
        assert tp.ulps(a, b).max() <= tp.LIFE_ULPS[dtype]
    fed = tp.with_lifetimes(cases, lifes)
    want = tp.port_stream(fed, dtype, fn=pcs.sweep_tile_plain)
    tp.assert_streams_equal(fed, want, (outs, accs), dtype, dt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_drawn_plain_equals_the_cpu_sweeps_tile(dt):
    """`sweep_tile_drawn` on CPU tensors (its plain version) over a
    step's own rows gives the CPU sweep's tile bit for bit, counts one
    plain call, and leaves best_core out when asked."""
    dtype = DTYPES[dt]
    spec = _draw_spec(draws=16)
    tdt = ps._torch_dtype(dtype)
    step = ps._Step(spec, 40, tdt, 64, 32, torch.device("cpu"))
    life = torch.empty((40, spec.draws), dtype=tdt)
    tb = step.tables
    bins = dict(hist_lo=tb.hist_lo, hist_inv=tb.hist_inv, par_lo=tb.par_lo,
                par_inv=tb.par_inv)
    acc0, st0 = step(pcs.init_acc(64, 32, tdt, "cpu"), 40, life_out=life)
    cell = 40 + torch.arange(40, dtype=torch.int32)
    valid, di, fi, ii, vi, wi, ti, fri = step.decode(cell)
    pcs.reset_counts()
    life2 = torch.empty_like(life)
    out, acc = pcs.sweep_tile_drawn(
        step.key, step.kind[di], step.p1[di], step.p2[di], step.cum[di],
        step.emb[fri, wi], step.kwh[ti, fri, wi], step.inten[ii],
        step.freq[fi], valid, cell, pcs.init_acc(64, 32, tdt, "cpu"),
        n_draws=spec.draws, day_s=ps.DAY_S, life_out=life2, best_core=False,
        device="cpu", **bins)
    assert (pcs.sweep_tile_drawn.plain_calls,
            pcs.sweep_tile_drawn.launches) == (1, 0)
    assert out.best_core is None
    np.testing.assert_array_equal(life.numpy(), life2.numpy())
    np.testing.assert_array_equal(out.counts.numpy(), st0["counts"].numpy())
    np.testing.assert_array_equal(out.min_best.numpy(), st0["min"].numpy())
    for a, b in zip(acc, acc0):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
