"""The carbon-sweep kernel's plain version and its CUDA arithmetic, on the CPU.

- `sweep_tile_plain` (the port's `kernels/carbon_sweep.py`) against the
  reference's `kernels/carbon_sweep.py::sweep_tile` on its jnp path and
  on its Pallas path (interpret mode, as the reference's own tests run
  it), on the same numpy inputs: three tiles streamed through one set of
  accumulators, with exact ties, +inf lifetimes and invalid cells, in
  float32 and float64.
- `csrc/carbon_sweep.cuh`, the kernel's per-draw and per-bin arithmetic,
  built for the host with g++ -ffp-contract=off inside a loop that walks
  a tile as the kernel's two passes do, against the plain version.

Tolerances are those of `_torch_parity` (everything bit for bit but the
per-cell sums, 2 (N - 1) u; a value at a histogram or Pareto bin edge may
change bins, and is counted).
"""
import ctypes
import functools
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from repro.kernels import carbon_sweep as rcs
from repro_torch import convert
from repro_torch.kernels import carbon_sweep as pcs

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "src"
        / "repro_torch" / "kernels" / "csrc")
DTYPES = {"f32": np.float32, "f64": np.float64}


def _ref_stream(cases, path, dtype):
    """The reference's sweep_tile over the tiles, one accumulator set;
    numpy TileOuts and accumulators after every tile."""
    outs, accs = [], []
    step = jax.jit(functools.partial(rcs.sweep_tile, path=path,
                                     **tp.TILE_KW))
    with jax.enable_x64(dtype == np.float64):
        acc = rcs.init_acc(64, 32, jnp.dtype(dtype))
        for case in cases:
            out, acc = step(*(jnp.asarray(case[k]) for k in tp.TILE_ORDER),
                            acc)
            outs.append(pcs.TileOut(*(np.asarray(x) for x in out)))
            accs.append(pcs.SweepAcc(*(np.asarray(x) for x in acc)))
    return outs, accs


@pytest.mark.parametrize("path", ["jnp", "pallas"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_plain_matches_reference_streamed(path, dt):
    dtype = DTYPES[dt]
    cases = tp.stream_cases(np.random.default_rng(11), dtype)
    ref = _ref_stream(cases, path, dtype)
    got = tp.port_stream(cases, dtype)
    tp.assert_streams_equal(cases, ref, got, dtype, f"{path}/{dt}")
    # the cases reach the edges they are meant to reach
    last = got[1][-1]
    assert np.isinf(got[0][1].best_total).any()
    assert (last.par_op < np.inf).sum() >= 2 and last.hist.sum() > 0


def test_plain_on_all_invalid_and_inf_tiles_keeps_sentinels():
    """A tile whose cells are all invalid adds nothing; a tile whose
    lifetimes are all +inf has no alive champion: the accumulators keep
    their sentinels, as the reference's do."""
    rng = np.random.default_rng(5)
    cases = [tp.tile_inputs(rng, 6, 5, 3, np.float32, invalid_frac=1.0),
             tp.tile_inputs(rng, 6, 5, 3, np.float32, invalid_frac=0.0)]
    cases[1]["life_days"][:] = np.inf
    ref = _ref_stream(cases, "jnp", np.float32)
    got = tp.port_stream(cases, np.float32)
    tp.assert_streams_equal(cases, ref, got, np.float32, "sentinels")
    acc = got[1][-1]
    assert acc.hist.sum() == 30 and acc.hist[-1] == 30     # inf -> top bin
    assert np.isinf(acc.par_op).all()
    assert (acc.par_cell == pcs.IMAX).all()


def test_empty_accumulators_equal_the_reference():
    """The port's fresh accumulators are the reference's sentinels, and
    `convert` carries them across both ways."""
    for dtype in (np.float32, np.float64):
        with jax.enable_x64(dtype == np.float64):
            ref = rcs.init_acc(64, 32, jnp.dtype(dtype))
            ref = pcs.SweepAcc(*(np.asarray(x) for x in ref))
        tdt = torch.float64 if dtype == np.float64 else torch.float32
        got = convert.sweep_acc_to_numpy(pcs.init_acc(64, 32, tdt, "cpu"))
        back = convert.sweep_acc_to_numpy(
            convert.sweep_acc_to_torch(ref, "cpu"))
        for a, b, c in zip(ref, got, back):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_wrapper_counts_plain_calls():
    rng = np.random.default_rng(2)
    case = tp.tile_inputs(rng, 4, 3, 2, np.float32)
    args = [torch.from_numpy(case[k]) for k in tp.TILE_ORDER]
    pcs.reset_counts()
    acc = pcs.init_acc(64, 32, torch.float32, "cpu")
    pcs.sweep_tile(*args, acc, device="cpu", **tp.TILE_KW)
    assert (pcs.sweep_tile.plain_calls, pcs.sweep_tile.launches) == (1, 0)
    pcs.reset_counts()
    assert pcs.sweep_tile.plain_calls == 0


# ------------------------------------------------ the header on the host
SHIM = r"""
#include <limits>
#include <vector>

#include "carbon_sweep.cuh"

// One tile the way the kernel walks it: pass A per cell over the draws
// (argmin, counts, min/max, histogram, champion draws), pass B per Pareto
// bin (least alive champion, merged into the accumulators).
template <typename T>
static void tile_host(const T* emb, const T* kwh, const T* inten,
                      const T* freq, const T* life, const uint8_t* valid,
                      const int32_t* cell_idx, T* best_total,
                      int32_t* best_core, int32_t* counts, T* min_best,
                      T* max_best, int32_t* hist, T* par_op, T* par_emb,
                      T* par_life, int32_t* par_cell, int32_t* par_draw,
                      int32_t* par_core, int n_cells, int N, int C,
                      int n_hist, int n_par, double hist_lo,
                      double hist_inv, double par_lo, double par_inv) {
  const T inf = std::numeric_limits<T>::infinity();
  const T hlo = T(hist_lo), hinv = T(hist_inv), plo = T(par_lo),
          pinv = T(par_inv);
  std::vector<T> base(C), ch_op(size_t(n_cells) * C), ch_life(ch_op.size());
  std::vector<int32_t> ch_draw(ch_op.size());
  for (int r = 0; r < n_cells; ++r) {
    for (int c = 0; c < C; ++c) {
      base[c] = csweep::mul(kwh[r * C + c], inten[r]);
      counts[r * C + c] = 0;
      ch_op[r * C + c] = inf;
      ch_draw[r * C + c] = csweep::kIMax;
    }
    T mn = inf, mx = -inf;
    for (int d = 0; d < N; ++d) {
      T bt, bo;
      const int32_t bc = csweep::argmin_draw(emb + r * C, base.data(),
                                             life[r * N + d], freq[r], C,
                                             &bt, &bo);
      best_total[r * N + d] = bt;
      best_core[r * N + d] = bc;
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
    min_best[r] = mn;
    max_best[r] = mx;
    for (int c = 0; c < C; ++c) {
      const int32_t dr = ch_draw[r * C + c];
      ch_life[r * C + c] = dr == csweep::kIMax ? T(0) : life[r * N + dr];
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

#define ENTRY(NAME, T)                                                      \
  extern "C" void NAME(                                                     \
      const T* emb, const T* kwh, const T* inten, const T* freq,            \
      const T* life, const uint8_t* valid, const int32_t* cell_idx,         \
      T* best_total, int32_t* best_core, int32_t* counts, T* min_best,      \
      T* max_best, int32_t* hist, T* par_op, T* par_emb, T* par_life,       \
      int32_t* par_cell, int32_t* par_draw, int32_t* par_core, int n_cells, \
      int N, int C, int n_hist, int n_par, double hist_lo,                  \
      double hist_inv, double par_lo, double par_inv) {                     \
    tile_host<T>(emb, kwh, inten, freq, life, valid, cell_idx, best_total,  \
                 best_core, counts, min_best, max_best, hist, par_op,       \
                 par_emb, par_life, par_cell, par_draw, par_core, n_cells,  \
                 N, C, n_hist, n_par, hist_lo, hist_inv, par_lo, par_inv);  \
  }
ENTRY(tile_host_f32, float)
ENTRY(tile_host_f64, double)

extern "C" int log_bin_f32(float x, float lo, float inv, int n) {
  return csweep::log_bin(x, lo, inv, n);
}
extern "C" int log_bin_f64(double x, double lo, double inv, int n) {
  return csweep::log_bin(x, lo, inv, n);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "carbon_sweep.cuh cannot be compiled here")
    d = tmp_path_factory.mktemp("carbon_sweep_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libcarbon_sweep_host.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                           "-shared", "-fPIC", "-I", str(CSRC), "-o",
                           str(so), str(d / "shim.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("tile_host_f32", "tile_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 19 + [I] * 5 + [D] * 4
        fn.restype = None
    lib.log_bin_f32.argtypes = [ctypes.c_float] * 3 + [I]
    lib.log_bin_f64.argtypes = [D] * 3 + [I]
    lib.log_bin_f32.restype = lib.log_bin_f64.restype = I
    return lib


def _host_stream(lib, cases, dtype):
    """The host build over the streamed tiles: TileOuts (sums absent:
    the host loop does not reduce them) and accumulators."""
    acc = convert.sweep_acc_to_numpy(pcs.init_acc(
        64, 32, torch.float64 if dtype == np.float64 else torch.float32,
        "cpu"))
    fn = lib.tile_host_f64 if dtype == np.float64 else lib.tile_host_f32
    ptr = lambda a: a.ctypes.data  # noqa: E731
    outs, accs = [], []
    for case in cases:
        n_cells, n_draws = case["life_days"].shape
        n_cand = case["emb"].shape[1]
        bt = np.empty((n_cells, n_draws), dtype)
        bc = np.empty((n_cells, n_draws), np.int32)
        cnt = np.empty((n_cells, n_cand), np.int32)
        mn, mx = np.empty(n_cells, dtype), np.empty(n_cells, dtype)
        acc = pcs.SweepAcc(*(np.array(x, copy=True) for x in acc))
        ins = [np.ascontiguousarray(case[k]) for k in tp.TILE_ORDER]
        ins[5] = ins[5].astype(np.uint8)
        fn(*(ptr(a) for a in ins), ptr(bt), ptr(bc), ptr(cnt), ptr(mn),
           ptr(mx), *(ptr(a) for a in acc), n_cells, n_draws, n_cand, 64,
           32, *(tp.TILE_KW[k] for k in ("hist_lo", "hist_inv", "par_lo",
                                         "par_inv")))
        nan = np.full(n_cells, np.nan, dtype)
        outs.append(pcs.TileOut(bt, bc, cnt, nan, mn, mx, nan, nan))
        accs.append(acc)
    return outs, accs


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_host_header_matches_plain(host_lib, dt):
    """Totals, first-min argmin, counts, min/max, the saturating log10
    bins and the lexicographic Pareto merge of the header, bit for bit
    against the plain version over three streamed tiles (ties, +inf
    lifetimes, invalid cells)."""
    dtype = DTYPES[dt]
    cases = tp.stream_cases(np.random.default_rng(29), dtype, n_draws=40)
    got = _host_stream(host_lib, cases, dtype)
    plain = tp.port_stream(cases, dtype)
    for k, (a, b) in enumerate(zip(plain[0], got[0])):
        for f in ("best_total", "best_core", "counts", "min_best",
                  "max_best"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"tile {k}: {f}")
    h_edges, p_edges = tp.stream_edges(cases, plain[0], dtype)
    for k, (a, b) in enumerate(zip(plain[1], got[1])):
        tp.assert_hist_equal(a.hist, b.hist, h_edges, f"acc {k}")
        tp.assert_pareto_equal(a, b, p_edges, f"acc {k}")


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_host_log_bin_saturates_like_the_reference(host_lib, dt):
    """Zero, infinities, NaN and values far outside the bins clip to the
    end bins exactly as XLA's saturating convert-then-clip does (the
    reference's `_log_bin`, run here through jnp)."""
    dtype = DTYPES[dt]
    xs = np.array([0.0, np.inf, -np.inf, np.nan, 1e-30, 1e30, 1e-4, 5e-3,
                   1e300 if dtype == np.float64 else 3e38, -1.0], dtype)
    fn = host_lib.log_bin_f64 if dtype == np.float64 else \
        host_lib.log_bin_f32
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(rcs._log_bin(jnp.asarray(xs), -4.0, 12.8, 64))
    got = np.array([fn(float(x), -4.0, 12.8, 64) for x in xs])
    plain = pcs._log_bin(torch.from_numpy(xs),
                         torch.tensor(-4.0, dtype=torch.from_numpy(xs).dtype),
                         torch.tensor(12.8, dtype=torch.from_numpy(xs).dtype),
                         64).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
