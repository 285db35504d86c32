"""The port's packed resident runtime and plan/report against the
reference's, end to end on the CPU (`device="cpu"`: the plain versions of
the kernels): every per-item field, the full final state and, at equal
chunk/seg_steps/adaptive, the schedule statistics, bit for bit; and the
carbon report of `examples/fleet_simulation.py`'s three-group plan."""
import dataclasses
import functools

import pytest

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.fleet import engine as reng
from repro.fleet import plan as rplan
from repro_torch.fleet import engine, plan

_SCHEDULE = ("lane_steps", "n_segments", "seg_schedule", "host_syncs")


@functools.lru_cache(maxsize=None)
def _port_run(adaptive: bool):
    return engine.run_packed(tp.skew_groups(engine), chunk=16, seg_steps=64,
                             keep_state=True, adaptive=adaptive,
                             device="cpu")


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("stepper", ["branchless", "pallas"])
def test_run_packed_matches_reference(stepper, adaptive):
    """16x-skewed halt times in two groups, one of which runs out of
    budget: the port's run equals the reference's resident run
    (`refill="device"`) under both of its steppers."""
    ref, rs = reng.run_packed(tp.skew_groups(reng), chunk=16, seg_steps=64,
                              keep_state=True, refill="device",
                              stepper=stepper, adaptive=adaptive)
    got, ps = _port_run(adaptive)
    tp.assert_results_equal(ref, got, f"{stepper} adaptive={adaptive}")
    for a, b in zip(ref, got):
        assert (a.lane_steps, a.n_segments) == (b.lane_steps, b.n_segments)
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(ps, f), f
    assert not got[1].halted[got[1].n_instr == 200].any()  # budget-bound
    assert ps.stepper == "plain" and ps.refill == "device"


def test_run_packed_matches_reference_on_workload_groups():
    """Two FlexiBench groups with their own sources, timing on for one
    of them (the other prices on a zero cost row), and a pool (chunk 20)
    smaller than the plan: per-item
    results, final state, per-group tick tallies and schedule."""
    from repro.flexibench.base import get as rget
    from repro_torch.flexibench.base import get as pget
    from repro_torch.flexibits.cycles import CORES, cost_row

    def groups(mod, get):
        out = []
        for i, (key, n, core) in enumerate((("WQ", 30, None),
                                            ("MC", 24, "HERV"))):
            w = get(key)
            out.append(mod.PackedGroup(
                code=w.program.code, source=mod.workload_source(w, seed=i),
                n_items=n, max_steps=w.max_steps,
                mem_words=w.total_mem_words, out_addr=w.out_addr,
                cost=None if core is None
                else cost_row(CORES[core], dynamic=True)))
        return out
    ref, rs = reng.run_packed(groups(reng, rget), chunk=20, seg_steps=128,
                              keep_state=True, adaptive=True)
    got, ps = engine.run_packed(groups(engine, pget), chunk=20,
                                seg_steps=128, keep_state=True,
                                adaptive=True, device="cpu")
    tp.assert_results_equal(ref, got, "workload groups")
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(ps, f), f


def _example_plan(mod, n_items, **kw):
    """`examples/fleet_simulation.py`'s three sub-fleets."""
    return mod.FleetPlan(groups=(
        mod.FleetGroup(workload="MC", core="SERV", n_items=n_items, seed=0),
        mod.FleetGroup(workload="WQ", core="QERV", n_items=n_items, seed=1),
        mod.FleetGroup(workload="SI", core="HERV", n_items=n_items, seed=2),
    ), **kw)


_REPORT_FIELDS = ("lifetime_s", "execs_per_day", "energy_j_per_exec",
                  "fleet_exec_kwh", "operational_kg", "embodied_kg",
                  "total_kg", "recommended_core", "measured_cycles",
                  "wcet_cycles", "certified_energy_j",
                  "certified_operational_kg", "cycles_per_item",
                  "wcet_ratio")


def _assert_reports_equal(ref, got):
    assert len(ref.groups) == len(got.groups)
    for a, b in zip(ref.groups, got.groups):
        for f in _REPORT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert dataclasses.astuple(a.profile) == \
            dataclasses.astuple(b.profile)
        assert dataclasses.astuple(a.core) == dataclasses.astuple(b.core)
        assert a.workload.key == b.workload.key
        assert a.group.workload == b.group.workload
    tp.assert_results_equal([g.result for g in ref.groups],
                            [g.result for g in got.groups], "report")
    # the text is equal but for the lines carrying wall time, sync
    # statistics and the simulation's own footprint (its power figure is
    # the card's, not the reference's)
    timed = ("fleet:", "sync stats")
    ra, ga = ref.format().splitlines(), got.format().splitlines()
    assert len(ra) == len(ga)
    for x, y in zip(ra, ga):
        if not x.startswith(timed):
            assert x == y


def test_run_plan_matches_reference_on_example_plan():
    ref = rplan.run_plan(_example_plan(rplan, 4, chunk=12, seg_steps=1024),
                         keep_state=True)
    got = plan.run_plan(_example_plan(plan, 4, chunk=12, seg_steps=1024),
                        keep_state=True, device="cpu", power_w=700.0)
    _assert_reports_equal(ref, got)
    assert got.power_w == 700.0 and got.simulation_kg() > 0.0


def test_run_plan_matches_reference_with_static_budgets_and_timing():
    """FlexiLint-static budgets, dynamic timing and the reachable-only
    subset: the measured cycles, the certificate and the report."""
    def mk(mod):
        return mod.FleetPlan(groups=(
            mod.FleetGroup(workload="WQ", core="SERV", n_items=20, seed=4,
                           max_steps="static"),
            mod.FleetGroup(workload="MC", core="HERV", n_items=12, seed=5,
                           max_steps="static"),
        ), chunk=16, seg_steps=32, timing="dynamic", subset_source="static",
            adaptive=True)
    ref = rplan.run_plan(mk(rplan), keep_state=True)
    got = plan.run_plan(mk(plan), keep_state=True, device="cpu")
    _assert_reports_equal(ref, got)
    assert got.groups[0].measured_cycles is not None
    assert got.simulation_kg() is None      # no card, no power given


def test_budget_error_matches_reference():
    def mk(mod):
        return mod.FleetPlan(groups=(mod.FleetGroup(
            workload="SI", n_items=2, max_steps=10),), chunk=2)
    with pytest.raises(rplan.BudgetError) as r:
        rplan.run_plan(mk(rplan))
    with pytest.raises(plan.BudgetError) as p:
        plan.run_plan(mk(plan), device="cpu")
    assert str(r.value) == str(p.value)


def test_run_packed_rejects_bad_arguments():
    groups = tp.skew_groups(engine)
    for kw in ({"chunk": 0}, {"seg_steps": 0}, {"refill": "telepathy"},
               {"redundancy": "tmr"}):
        with pytest.raises(ValueError):
            engine.run_packed(groups, device="cpu", **kw)
    with pytest.raises(ValueError):
        engine.run_packed([], device="cpu")
