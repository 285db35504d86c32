"""The port's host-refill loop (`run_packed(refill="host")`), its fallback
past the resident safety bounds, the sequential plan
(`FleetPlan(packed=False)`) and `run_workload_stream`, against the
reference's on the CPU (`device="cpu"`: the kernels' plain versions):
every per-item field, the full final state and, at equal chunk,
seg_steps and adaptive, the schedule statistics (`lane_steps`,
`n_segments`, `seg_schedule`, `host_syncs`), bit for bit. The reference
runs its default branchless stepper, whose pool is `chunk` lanes, as the
port's is."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.fleet import engine as reng
from repro.fleet import plan as rplan
from repro_torch.fleet import engine, plan

_SCHEDULE = ("lane_steps", "n_segments", "seg_schedule", "host_syncs")


def _assert_same_run(ref, rs, got, ps, ctx):
    tp.assert_results_equal(ref, got, ctx)
    for a, b in zip(ref, got):
        assert (a.lane_steps, a.n_segments) == (b.lane_steps, b.n_segments)
    for f in _SCHEDULE + ("refill",):
        assert getattr(rs, f) == getattr(ps, f), f"{ctx}: {f}"


@pytest.mark.parametrize("adaptive", [False, True])
def test_host_loop_matches_reference(adaptive):
    """Two groups of the skew program, one ended by its budget: the host
    loop's demux, final state and host syncs equal the reference's."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True, refill="host",
              adaptive=adaptive)
    ref, rs = reng.run_packed(tp.skew_groups(reng), **kw)
    got, ps = engine.run_packed(tp.skew_groups(engine), device="cpu", **kw)
    _assert_same_run(ref, rs, got, ps, f"adaptive={adaptive}")
    assert ps.refill == "host" and ps.stepper == "plain"
    assert not got[1].halted[got[1].n_instr == 200].any()   # budget-bound
    assert 0.0 <= ps.device_busy_frac <= 1.0
    assert len(ps.seg_schedule) == ps.n_segments


def _workload_groups(mod, get, timed):
    from repro_torch.flexibits.cycles import CORES, cost_row
    out = []
    for i, (key, n, core) in enumerate((("WQ", 30, None),
                                        ("MC", 24, "HERV"))):
        w = get(key)
        out.append(mod.PackedGroup(
            code=w.program.code, source=mod.workload_source(w, seed=i),
            n_items=n, max_steps=w.max_steps, mem_words=w.total_mem_words,
            out_addr=w.out_addr,
            cost=None if core is None or not timed
            else cost_row(CORES[core], dynamic=True)))
    return out


@pytest.mark.parametrize("timed", [False, True])
def test_host_loop_matches_reference_on_workload_groups(timed):
    """The two FlexiBench groups of `test_torch_fleet.py` (WQ and MC,
    their own sources, a 20-lane pool smaller than the plan), timing on
    for MC in one case: per-item results, ticks, final state, schedule
    and host syncs."""
    from repro.flexibench.base import get as rget
    from repro_torch.flexibench.base import get as pget
    kw = dict(chunk=20, seg_steps=128, keep_state=True, adaptive=True,
              refill="host")
    ref, rs = reng.run_packed(_workload_groups(reng, rget, timed), **kw)
    got, ps = engine.run_packed(_workload_groups(engine, pget, timed),
                                device="cpu", **kw)
    _assert_same_run(ref, rs, got, ps, f"timed={timed}")
    assert (got[1].n_cycles is not None) == timed


def _size_skew_groups(mod, chunk=16):
    """`benchmarks/fleet.py::fleet_packed_vs_sequential`'s plan cut to
    chunk 16: group sizes 128, 16, 8 and 8 (16x size skew), each with
    its own halt-time skew. Cut to keep the file fast: `long_iters` is
    160 + 32 g where the benchmark has 2,048 + 512 g."""
    prog = tp.skew_program()
    out = []
    for gi, n in enumerate((8 * chunk, chunk, chunk // 2, chunk // 2)):
        mems = tp.skew_mems(prog, n, 48, 160 + 32 * gi, 0.08 + 0.04 * gi,
                            17 + gi)
        out.append(mod.PackedGroup(
            code=prog.code, source=mod.array_source(mems), n_items=n,
            max_steps=100_000, mem_words=32, out_addr=1))
    return out


def test_host_loop_on_size_skewed_plan_and_resident_syncs_fewer():
    """The 16x size-skewed plan through both loops of both packages: the
    host loops agree bit for bit with their schedule and syncs, the
    resident loop returns the same per-item results, and its blocking
    host syncs are strictly fewer than the host loop's (one stats read
    per segment, one trailing, and the drain's reads)."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True)
    ref, rs = reng.run_packed(_size_skew_groups(reng), refill="host", **kw)
    got, ps = engine.run_packed(_size_skew_groups(engine), refill="host",
                                device="cpu", **kw)
    _assert_same_run(ref, rs, got, ps, "host loop")
    res, pd = engine.run_packed(_size_skew_groups(engine), refill="device",
                                device="cpu", **kw)
    tp.assert_results_equal(got, res, "resident vs host")
    assert pd.refill == "device"
    assert pd.host_syncs < ps.host_syncs, (pd.host_syncs, ps.host_syncs)
    assert pd.host_syncs == pd.n_segments + 1 + 9


def _mc_groups(mod, get, n, max_steps):
    w = get("MC")
    return [mod.PackedGroup(
        code=w.program.code, source=mod.workload_source(w, seed=3),
        n_items=n, max_steps=max_steps, mem_words=w.total_mem_words,
        out_addr=w.out_addr)]


def test_fallback_past_the_mix_bound():
    """11,000 MC items at a 200,000-step budget could retire more than
    2^31 - 1 instructions in one mix class: both packages fall back to
    the host loop (MC halts within 49 steps) and agree bit for bit."""
    from repro.flexibench.base import get as rget
    from repro_torch.flexibench.base import get as pget
    kw = dict(chunk=2048, seg_steps=64)
    ref, rs = reng.run_packed(_mc_groups(reng, rget, 11_000, 200_000), **kw)
    got, ps = engine.run_packed(_mc_groups(engine, pget, 11_000, 200_000),
                                device="cpu", **kw)
    assert rs.refill == ps.refill == "host"
    _assert_same_run(ref, rs, got, ps, "mix bound")
    assert got[0].halted.all()


def test_fallback_past_the_keep_state_bound(monkeypatch):
    """With the keep_state device-row budget lowered (here only) below
    the plan's full final state, both packages fall back to the host
    loop and agree bit for bit; under it both stay resident."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True)
    words = 64 * (32 + 16 + 1 + 8)
    for mod in (reng, engine):
        monkeypatch.setattr(mod, "_RESIDENT_KEEP_STATE_WORDS", words - 1)
    ref, rs = reng.run_packed(tp.skew_groups(reng), **kw)
    got, ps = engine.run_packed(tp.skew_groups(engine), device="cpu", **kw)
    assert rs.refill == ps.refill == "host"
    _assert_same_run(ref, rs, got, ps, "keep_state bound")
    for mod in (reng, engine):
        monkeypatch.setattr(mod, "_RESIDENT_KEEP_STATE_WORDS", words)
    _, ps = engine.run_packed(tp.skew_groups(engine), device="cpu", **kw)
    assert ps.refill == "device"


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
                  "wcet_cycles", "cycles_per_item", "wcet_ratio")


@pytest.mark.parametrize("refill", ["device", "host"])
def test_sequential_plan_matches_reference(refill):
    """`packed=False` drains the groups one after another: group by
    group, the port's report equals the reference's (carbon, profiles,
    per-item results, final state, each group's own schedule), and
    neither carries packed stats. The resident case runs the three
    groups of the example plan; the host loop's case its first two (SI's
    7,715 steps take the plain stepper ~13 s)."""
    kw = dict(chunk=12, seg_steps=1024, packed=False, refill=refill,
              timing="base")
    n_groups = 3 if refill == "device" else 2

    def mk(mod):
        p = _example_plan(mod, 6, **kw)
        return mod.FleetPlan(groups=p.groups[:n_groups], **kw)
    ref = rplan.run_plan(mk(rplan), keep_state=True)
    got = plan.run_plan(mk(plan), keep_state=True, device="cpu")
    assert ref.packed is None and got.packed is None
    assert len(ref.groups) == len(got.groups) == n_groups
    for a, b in zip(ref.groups, got.groups):
        for f in _REPORT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert dataclasses.astuple(a.profile) == \
            dataclasses.astuple(b.profile)
        r, g = a.result, b.result
        assert (r.lane_steps, r.n_segments, r.chunk) == \
            (g.lane_steps, g.n_segments, g.chunk)
    tp.assert_results_equal([g.result for g in ref.groups],
                            [g.result for g in got.groups], "sequential")


def test_run_workload_stream_matches_reference():
    """One workload end to end, on both loops."""
    from repro.flexibench.base import get as rget
    from repro_torch.flexibench.base import get as pget
    for refill in ("device", "host"):
        kw = dict(seed=5, chunk=8, seg_steps=128, keep_state=True,
                  refill=refill)
        ref = reng.run_workload_stream(rget("WQ"), 20, **kw)
        got = engine.run_workload_stream(pget("WQ"), 20, device="cpu",
                                         **kw)
        tp.assert_results_equal([ref], [got], refill)
        assert (ref.lane_steps, ref.n_segments, ref.chunk) == \
            (got.lane_steps, got.n_segments, got.chunk)


def test_host_loop_primitives_match_reference():
    """`_fresh_packed`, `_refill_packed` (in place here, donated there)
    and `_done_count_packed` on a random pool."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    n, m = 24, 16
    mems = rng.integers(-2**31, 2**31, (n, m)).astype(np.int32)
    active = rng.random(n) < 0.8
    prog = rng.integers(0, 3, n).astype(np.int32)
    ms = rng.integers(0, 50, n).astype(np.int32)
    a = reng._fresh_packed(mems, active, prog, ms)
    b = engine._fresh_packed(mems, active, prog, ms, torch.device("cpu"))
    tp.assert_packed_equal(a, b, "fresh")
    # step counts and halts so that some lanes are done
    n_instr = rng.integers(0, 60, n).astype(np.int32)
    halted = rng.random(n) < 0.3
    a = a._replace(lanes=a.lanes._replace(n_instr=jnp.asarray(n_instr),
                                          halted=jnp.asarray(halted)))
    b.lanes.n_instr.copy_(torch.from_numpy(n_instr))
    b.lanes.halted.copy_(torch.from_numpy(halted))
    assert int(reng._done_count_packed(a)) == \
        int(engine._done_count_packed(b))
    rep = rng.random(n) < 0.5
    new_mems = rng.integers(-2**31, 2**31, (n, m)).astype(np.int32)
    new_prog = rng.integers(0, 3, n).astype(np.int32)
    new_ms = rng.integers(1, 99, n).astype(np.int32)
    a = reng._refill_packed(a, jnp.asarray(rep), jnp.asarray(new_mems),
                            jnp.asarray(new_prog), jnp.asarray(new_ms))
    before = b.lanes.mem
    b2 = engine._refill_packed(b, *(torch.from_numpy(x) for x in
                                    (rep, new_mems, new_prog, new_ms)))
    assert b2.lanes.mem is before                  # updated in place
    tp.assert_packed_equal(a, b2, "refill")


def _tiny_plan(mod, **kw):
    return mod.FleetPlan(groups=(mod.FleetGroup(workload="WQ",
                                                n_items=4),),
                         chunk=4, **kw)


@pytest.mark.parametrize("what", ["host_checkpoint", "bounds_checkpoint",
                                  "sequential_checkpoint"])
def test_checkpoint_errors_match_reference(what, tmp_path):
    """A checkpoint needs the resident loop, within its bounds, and a
    packed plan: the reference's ValueErrors, word for word."""
    cdir = str(tmp_path / "ck")

    def run(mod, **dev):
        if what == "host_checkpoint":
            return mod.run_plan(_tiny_plan(mod, refill="host"),
                                checkpoint_dir=cdir, **dev)
        if what == "sequential_checkpoint":
            return mod.run_plan(_tiny_plan(mod, packed=False),
                                checkpoint_dir=cdir, **dev)
        return mod.run_plan(mod.FleetPlan(groups=(mod.FleetGroup(
            workload="WQ", n_items=4, max_steps=2**30),), chunk=4),
            checkpoint_dir=cdir, **dev)
    with pytest.raises(ValueError) as r:
        run(rplan)
    with pytest.raises(ValueError) as p:
        run(plan, device="cpu")
    assert str(r.value) == str(p.value)
