"""The port's paper-table and serving-planner copies against the
reference: Table 5 (`core/scale.py`) bit for bit; `core/planner.py` with
the chip as a parameter, given the reference's own constants, equal to
the reference's `plan_grid`; and `core/sweep.py::serving_plan`, the
float64 torch mirror, on the CPU equal bit for bit to the reference's
numpy `plan_grid` and to its jnp mirror `serving_plan_jnp` under
`jax.enable_x64(True)`, through tied options, infeasible cells and
inf/NaN QPS demands. The card's run is in tests/test_torch_gpu.py and
chip_smoke.py."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import planner as rp
from repro.core import scale as rscale
from repro.core.sweep import serving_plan_jnp
from repro.launch.roofline import HBM_BW
from repro_torch.core import planner as pp
from repro_torch.core import scale as pscale
from repro_torch.core import sweep as psweep

# the reference's chip, passed into the port's functions
REF_CHIP = pp.ServeChip(hbm_bw=HBM_BW, power_w=rp.CHIP_POWER_W,
                        embodied_kg=rp.TPU_EMBODIED_KG)
KV = 32 * 8 * 128 * 2 * 2
_MAPS = ("variant_idx", "chips", "total_kg")


def _bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.dtype, x.shape, x.view(np.uint8).tobytes()


def test_table5_equals_reference():
    assert pscale.table5() == rscale.table5()
    for k in ("BEEF_LBS_PER_YEAR", "KG_PER_LB", "BEEF_KG_PER_YEAR",
              "WASTE_FRACTION", "CO2_PER_KG_BEEF", "CAR_KG_PER_YEAR",
              "SYSTEM_FOOTPRINTS_KG"):
        assert getattr(pscale, k) == getattr(rscale, k), k
    for fp in (0.0, 0.01086, 0.12829, 2.66, 17.0):
        assert pscale.breakeven_effectiveness(fp) == \
            rscale.breakeven_effectiveness(fp)
        for e in (0.0, 1e-4, 0.3, 1.0):
            assert pscale.savings_kg(fp, e) == rscale.savings_kg(fp, e)
            assert pscale.savings_cars(fp, e) == rscale.savings_cars(fp, e)


def test_planner_copies_equal_reference():
    assert pp.PUE == rp.PUE
    got = pp.serve_variants(REF_CHIP)
    assert [dataclasses.astuple(v) for v in got] == \
        [dataclasses.astuple(v) for v in rp.VARIANTS]
    for chip_hours in (0.0, 1.0, 100.0, 4000.0):
        for intensity in (0.05, 0.367):
            assert pp._prep_kg(REF_CHIP, chip_hours, intensity) == \
                rp._prep_kg(chip_hours, intensity)
    for n_params in (1.5e9, 8e9, 7e10):
        for bits in (4, 8, 16):
            for chips in (1, 8, 48, 256):
                for batch in (1, 64):
                    assert pp.tokens_per_s_per_chip(
                        REF_CHIP, n_params, bits, KV, chips, batch) == \
                        rp.tokens_per_s_per_chip(n_params, bits, KV, chips,
                                                 batch)


def _grids():
    rng = np.random.default_rng(0)
    return {
        "example": dict(lifetimes_days=np.array([7.0, 90.0, 3 * 365.0]),
                        qps_grid=np.logspace(2, 6, 9)),
        # tied options (a repeated fleet size), infeasible demands, inf,
        # NaN and zero QPS, lifetimes past the 3-year amortization
        "edges": dict(lifetimes_days=np.concatenate(
            [[0.0, 1.0, 1095.0, 4000.0], rng.uniform(0.5, 3000.0, 20)]),
            qps_grid=np.concatenate([np.logspace(1, 8, 40),
                                     [0.0, np.inf, np.nan, 1e12]]),
            chips_options=(8, 16, 16, 32, 64, 64, 128, 256, 512)),
        "one_option": dict(lifetimes_days=np.array([30.0, 700.0]),
                           qps_grid=np.array([10.0, 1e5, 1e9]),
                           chips_options=(64,), intensity=0.7,
                           n_params=1.5e9),
    }


def _kwargs(case):
    kw = dict(n_params=8e9, kv_bytes_per_token=KV)
    kw.update(_grids()[case])
    return kw


@pytest.mark.parametrize("case", ["example", "edges", "one_option"])
def test_plan_grid_equals_reference(case):
    kw = _kwargs(case)
    want = rp.plan_grid(**kw)
    got = pp.plan_grid(chip=REF_CHIP, **kw)
    assert got["variants"] == want["variants"]
    for k in _MAPS:
        assert _bits(got[k]) == _bits(want[k]), k


@pytest.mark.parametrize("case", ["example", "edges", "one_option"])
def test_serving_plan_equals_plan_grid_and_jnp_mirror(case):
    kw = _kwargs(case)
    want = rp.plan_grid(**kw)
    with jax.enable_x64(True):
        jnp_plan = {k: np.asarray(v) for k, v in
                    serving_plan_jnp(**kw).items() if k != "variants"}
    got = psweep.serving_plan(chip=REF_CHIP, device="cpu", **kw)
    assert got["variants"] == want["variants"]
    for k in _MAPS:
        assert got[k].device.type == "cpu"
        g = got[k].numpy()
        assert _bits(g) == _bits(want[k]), k
        assert _bits(g) == _bits(jnp_plan[k]), k
    if case == "edges":
        vi = got["variant_idx"].numpy()
        assert (vi == -1).any() and (vi >= 0).any()
        assert np.isinf(got["total_kg"].numpy()).any()


def test_serving_plan_takes_the_first_of_tied_options():
    """Two identical variants and a repeated fleet size tie exactly:
    the first option wins, as `np.argmin` picks it."""
    v = pp.ServeVariant("W8", 8, 0.0, 1.0)
    rv = rp.ServeVariant("W8", 8, 0.0, 1.0)
    kw = dict(n_params=8e9, kv_bytes_per_token=KV,
              lifetimes_days=np.array([1.0, 365.0]),
              qps_grid=np.array([1.0, 1e3, 1e5]), chips_options=(16, 16))
    want = rp.plan_grid(variants=(rv, rv), **kw)
    got = psweep.serving_plan(chip=REF_CHIP, variants=(v, v), device="cpu",
                              **kw)
    for k in _MAPS:
        assert _bits(got[k].numpy()) == _bits(want[k]), k
    assert (got["variant_idx"].numpy() == 0).all()


@pytest.mark.parametrize("empty", ["chips_options", "variants"])
def test_empty_options_raise_as_the_reference(empty):
    kw = dict(n_params=8e9, kv_bytes_per_token=KV,
              lifetimes_days=np.array([7.0]), qps_grid=np.array([1.0]),
              **{empty: ()})
    with pytest.raises(ValueError, match=f"{empty} is empty"):
        rp.plan_grid(**kw)
    with pytest.raises(ValueError, match=f"{empty} is empty"):
        serving_plan_jnp(**kw)
    with pytest.raises(ValueError, match=f"{empty} is empty"):
        pp.plan_grid(chip=REF_CHIP, **kw)
    with pytest.raises(ValueError, match=f"{empty} is empty"):
        psweep.serving_plan(chip=REF_CHIP, device="cpu", **kw)


def test_h100_sxm_row(monkeypatch):
    from repro_torch import device
    chip = pp.h100_sxm(1500.0, power_w=650.0)
    assert chip == pp.ServeChip(hbm_bw=3.35e12, power_w=650.0,
                                embodied_kg=1500.0)
    monkeypatch.setattr(device, "card_power_limit_w", lambda: 700.0)
    assert pp.h100_sxm(10.0).power_w == 700.0
    monkeypatch.setattr(device, "card_power_limit_w", lambda: None)
    with pytest.raises(RuntimeError, match="pass power_w"):
        pp.h100_sxm(10.0)
    # the H100's variants and plan follow the same formulas
    kw = _kwargs("example")
    got = psweep.serving_plan(chip=chip, device="cpu", **kw)
    want = pp.plan_grid(chip=chip, **kw)
    for k in _MAPS:
        assert _bits(got[k].numpy()) == _bits(want[k]), k
