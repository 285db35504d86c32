"""The port's Monte Carlo carbon sweep (`repro_torch/core/sweep.py`) on the
CPU, against the reference's `repro/core/sweep.py` and the numpy oracles.

What is held, and to what:
- the spec's float64 tables, bit for bit (`build_tables` of
  `convert.sweep_spec_from(ref_spec)`), and `workload_spec`'s profiles
  and WCET certificates;
- the uniforms bit for bit; the lifetimes of lognormal and Weibull
  components within LIFE_ULPS (torch's `ndtri`, `exp`, `log1p` and `pow`
  are not XLA's, and XLA fuses `a + b * z` into an FMA: `exp` turns an
  argument near 23 that differs by one rounding into ~16 float32 ulps of
  the lifetime, and XLA's float64 `log1p` is not torch's near 0, where
  the Weibull transform reads it); point masses exactly;
- given the same lifetimes (the reference's, fed to the port's sweep),
  every field of `SweepResult` with `_torch_parity`'s tolerances: the
  percentiles, min, max, counts and `frontier()` rows bit for bit, the
  means to 2 (N + 1) u, the histogram and Pareto bins bit for bit but for
  values at a bin edge;
- float64 point-mass sweeps equal `total_grid(...).min(0)` and
  `selection_map` bit for bit, and the reference's sweep (under
  `jax.enable_x64(True)`);
- the port's own sweep is bit-identical at any tile size and flush
  cadence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import _torch_parity as tp
from repro.core import sweep as rs
from repro.flexibits.cycles import CORES as REF_CORES
from repro_torch import convert
from repro_torch.core import selection as psel
from repro_torch.core import sweep as ps
from test_sweep import DAY, PROF, _mixture_spec, _point_spec

# twice the largest differences seen on the reference test's mixture
# spec while the port was written (see above for their causes)
LIFE_ULPS = tp.LIFE_ULPS
DTYPES = {"f32": np.float32, "f64": np.float64}


def _redundancy_spec():
    """The reference test's expanded candidate axis (core x redundancy)
    and non-zero fault-rate axis (`test_sweep.py:281-290`)."""
    return dataclasses.replace(_mixture_spec(draws=16),
                               fault_rates=(0.0, 1e-3),
                               redundancies=("none", "dmr"))


def _timing_spec():
    events = [0.0] * 19
    events[0], events[1], events[2] = 600.0, 400.0, 120.0
    events[16], events[17], events[18] = 50.0, 200.0, 30.0
    prof = dataclasses.replace(PROF, events=tuple(events))
    return rs.SweepSpec(
        workloads=("w0",), profiles=(prof,),
        dists=(rs.LifetimeDist.point(DAY * 100),),
        execs_per_day=(24.0,), intensities=(0.367,),
        timing=("base", "dynamic", "wcet"),
        wcet_cycles=((60_000.0, 20_000.0, 12_000.0),), draws=4, seed=0)


def _ulps(a, b):
    it = np.int64 if a.dtype == np.float64 else np.int32
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


def _ref_life_days(spec, dtype):
    """The reference step's lifetimes (`_uniforms`, `_lifetimes`, the
    guarded division by DAY_S), jitted as its step is: a function of the
    global cell indices, numpy in and out."""
    tb = rs.build_tables(spec)
    D, F, I, V, W, T, FR = spec.axis_sizes
    n_cells = spec.n_cells
    jdt = jnp.dtype(dtype)

    @jax.jit
    def f(cell):
        c = jnp.where(cell < n_cells, cell, n_cells - 1)
        di = c // (F * I * V * W * T * FR)
        u = rs._uniforms(jax.random.PRNGKey(spec.seed), cell, spec.draws,
                         jdt)
        life = rs._lifetimes(jnp.asarray(tb.kind)[di],
                             jnp.asarray(tb.p1, jdt)[di],
                             jnp.asarray(tb.p2, jdt)[di],
                             jnp.asarray(tb.cum_prev, jdt)[di], u)
        return life / lax.optimization_barrier(jnp.asarray(rs.DAY_S, jdt))

    def days(cell: np.ndarray) -> np.ndarray:
        with jax.enable_x64(dtype == np.float64):
            return np.asarray(f(jnp.asarray(cell, jnp.int32)))
    return days


def _ref_run(spec, dtype, **kw):
    with jax.enable_x64(dtype == np.float64):
        return rs.run_sweep(spec, path="jnp", dtype=dtype, **kw)


def _port_run(spec, dtype, life_days=None, **kw):
    """The port's sweep on the CPU (`_torch_parity.run_sweep_recorded`);
    with `life_days`, a function of global cells, fed those lifetimes."""
    if life_days is not None:
        tile = kw.get("tile_cells", spec.n_cells)
        n = -(-spec.n_cells // tile) * tile
        life_days = life_days(np.arange(n, dtype=np.int32))
    res, best, emb = tp.run_sweep_recorded(
        convert.sweep_spec_from(spec), life_days=life_days, dtype=dtype,
        device="cpu", **kw)
    return res, (best, emb)


@pytest.mark.parametrize("make", [_mixture_spec, _redundancy_spec,
                                  lambda: _point_spec()[0], _timing_spec],
                         ids=["mixture", "redundancy", "point", "timing"])
def test_build_tables_of_converted_spec_bitwise(make):
    spec = make()
    ref = rs.build_tables(spec)
    got = ps.build_tables(convert.sweep_spec_from(spec))
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_uniforms_exact_and_lifetimes_within_ulp_bound(dt):
    dtype = DTYPES[dt]
    spec = dataclasses.replace(_mixture_spec(draws=64), dists=(
        _mixture_spec().dists[0], rs.LifetimeDist.weibull(DAY * 30, 2.5),
        rs.LifetimeDist.point(DAY * 7)))
    step = ps._Step(convert.sweep_spec_from(spec), spec.n_cells,
                    ps._torch_dtype(dtype), 64, 32, torch.device("cpu"))
    cell = np.arange(spec.n_cells, dtype=np.int32)
    with jax.enable_x64(dtype == np.float64):
        u_ref = np.asarray(rs._uniforms(jax.random.PRNGKey(spec.seed),
                                        jnp.asarray(cell), spec.draws,
                                        jnp.dtype(dtype)))
    u = ps._uniforms(step.key, torch.from_numpy(cell), spec.draws,
                     step.dtype).numpy()
    np.testing.assert_array_equal(_ulps(u_ref, u), 0)
    _, di, *_ = step.decode(torch.from_numpy(cell))
    got = step.life_days(torch.from_numpy(cell), di).numpy()
    want = _ref_life_days(spec, dtype)(cell)
    d = _ulps(want, got)
    assert d.max() <= LIFE_ULPS[dtype], d.max()
    point = di.numpy() == 2
    assert point.any() and (d[point] == 0).all()


@pytest.mark.parametrize("case", ["mixture-f32", "redundancy-f32",
                                  "mixture-f64"])
def test_run_sweep_matches_reference_given_its_lifetimes(case):
    name, dt = case.split("-")
    dtype = DTYPES[dt]
    spec = _mixture_spec() if name == "mixture" else _redundancy_spec()
    ref = _ref_run(spec, dtype, tile_cells=13)
    got, (best, emb) = _port_run(spec, dtype,
                                 life_days=_ref_life_days(spec, dtype),
                                 tile_cells=13)
    tp.assert_sweeps_equal(ref, got, ps.build_tables(got.spec), best, emb,
                           case)
    assert ref.frontier() == got.frontier()
    assert got.frontier() and got.hist.sum() == spec.n_scenarios
    assert got.counts.shape[-1] == spec.n_candidates


def test_run_sweep_end_to_end_close_to_reference():
    """With its own lifetimes the port's float32 sweep stays within the
    lifetimes' bound of the reference: relative LIFE_ULPS u on every
    per-cell statistic, and the same chosen candidates and frontier
    (no draw of this spec sits that close to a tie or a bin edge)."""
    spec = _mixture_spec()
    ref = _ref_run(spec, np.float32, tile_cells=48)
    got, _ = _port_run(spec, np.float32, tile_cells=48)
    rel = (LIFE_ULPS[np.float32] + 2 * spec.draws) * 2.0 ** -24
    for f in tp.RESULT_SUM_FIELDS + ("p50", "p90", "p99", "min", "max"):
        tp.assert_rel_close(getattr(ref, f), getattr(got, f), rel, f)
    np.testing.assert_array_equal(ref.counts, got.counts)
    np.testing.assert_array_equal(ref.hist, got.hist)
    assert ref.frontier() == got.frontier()


def test_point_mass_f64_equals_oracles_and_reference():
    spec, lifes = _point_spec(draws=8)
    cores = list(convert.sweep_spec_from(spec).cores)
    pprof = convert.sweep_spec_from(spec).profiles[0]
    tg = psel.total_grid(cores, pprof, np.asarray(lifes),
                         np.asarray(spec.execs_per_day))
    smap = psel.selection_map(pprof, np.asarray(lifes),
                              np.asarray(spec.execs_per_day))
    res, (best, emb) = _port_run(spec, np.float64, tile_cells=5)
    res1, _ = _port_run(dataclasses.replace(spec, draws=1), np.float64)
    sq = np.s_[:, :, 0, 0, 0, 0, 0]
    for f in ("p50", "min", "max"):
        np.testing.assert_array_equal(getattr(res, f)[sq], tg.min(axis=0), f)
    np.testing.assert_array_equal(res1.mean[sq], tg.min(axis=0))
    np.testing.assert_array_equal(res.best_core[sq], smap)
    ref = _ref_run(spec, np.float64, tile_cells=5)
    tp.assert_sweeps_equal(ref, res, ps.build_tables(res.spec), best, emb,
                           "point f64")
    np.testing.assert_array_equal(ref.best_core, res.best_core)


def test_redundancy_rate_zero_reproduces_selection():
    spec, lifes = _point_spec(draws=4)
    spec = dataclasses.replace(spec, fault_rates=(0.0, 1e-4),
                               redundancies=("none", "dmr", "tmr"))
    pprof = convert.sweep_spec_from(spec).profiles[0]
    smap = psel.selection_map(pprof, np.asarray(lifes),
                              np.asarray(spec.execs_per_day))
    res, (best, emb) = _port_run(spec, np.float64, tile_cells=5)
    sq0 = np.s_[:, :, 0, 0, 0, 0, 0]
    np.testing.assert_array_equal(res.best_redundancy[sq0], 0)
    np.testing.assert_array_equal(res.best_core[sq0], smap)
    ref = _ref_run(spec, np.float64, tile_cells=5)
    tp.assert_sweeps_equal(ref, res, ps.build_tables(res.spec), best, emb,
                           "redundancy f64")


def test_mixture_of_points_hits_both_components():
    d1, d2 = DAY * 1.0, DAY * 2000.0
    mix = rs.LifetimeDist.mixture([(rs.LifetimeDist.point(d1), 0.5),
                                   (rs.LifetimeDist.point(d2), 0.5)])
    spec = rs.SweepSpec(workloads=("w0",), profiles=(PROF,), dists=(mix,),
                        execs_per_day=(24.0,), intensities=(0.367,),
                        draws=64, seed=1)
    pspec = convert.sweep_spec_from(spec)
    tg = psel.total_grid(list(pspec.cores), pspec.profiles[0],
                         np.array([d1, d2]), np.array([24.0]))
    res, _ = _port_run(spec, np.float64)
    assert res.min.ravel()[0] == tg[:, 0, 0].min()
    assert res.max.ravel()[0] == tg[:, 1, 0].min()


def test_tile_size_and_flush_cadence_bit_identical():
    spec = convert.sweep_spec_from(_mixture_spec())
    runs = [ps.run_sweep(spec, tile_cells=t, device="cpu")
            for t in (3, 7, 48, spec.n_cells)]
    runs.append(ps.run_sweep(spec, tile_cells=7, flush_limit=1,
                             device="cpu"))
    for other in runs[1:]:
        tp.assert_sweeps_identical(runs[0], other, "tile sizes")
    assert runs[-1].host_syncs == -(-spec.n_cells // 7) + 1
    assert runs[0].host_syncs == 1 and runs[0].path == "plain"
    c = ps.run_sweep(dataclasses.replace(spec, seed=spec.seed + 1),
                     tile_cells=16, device="cpu")
    assert not np.array_equal(runs[0].mean, c.mean)


def test_timing_axis_orders_base_dynamic_wcet():
    res = ps.run_sweep(convert.sweep_spec_from(_timing_spec()),
                       device="cpu")
    base, dyn, wc = (res.mean_op[0, 0, 0, 0, 0, t, 0] for t in range(3))
    assert base < dyn < wc


def test_workload_spec_matches_reference():
    kw = dict(dists=(rs.LifetimeDist.point(DAY * 100),),
              execs_per_day=(24.0,), intensities=(0.367,),
              timing=("base", "dynamic", "wcet"), draws=8)
    ref = rs.workload_spec(("MC", "WQ"), **kw)
    got = ps.workload_spec(("MC", "WQ"), dists=(
        ps.LifetimeDist.point(DAY * 100),), **{
            k: v for k, v in kw.items() if k != "dists"})
    assert got == convert.sweep_spec_from(ref)
    assert got.wcet_cycles == ref.wcet_cycles
    assert [c.name for c in got.cores] == list(REF_CORES)


def test_spec_validation_errors():
    spec = convert.sweep_spec_from(_mixture_spec())
    bad = {"dists is empty": dict(dists=()), "draws": dict(draws=0),
           "unknown timing": dict(timing=("typical",)),
           "unknown redundancy": dict(redundancies=("quad",)),
           "fault rates": dict(fault_rates=(-1.0,)),
           "wcet": dict(timing=("wcet",))}
    for match, change in bad.items():
        with pytest.raises(ValueError, match=match):
            ps.run_sweep(dataclasses.replace(spec, **change), device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        ps.run_sweep(spec, dtype=np.float16, device="cpu")
