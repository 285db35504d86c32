"""Fault injection and DMR recovery in the port's resident loop against the
reference's, on the CPU (`device="cpu"`: the kernels' plain versions).

Unprotected faulty results depend on the lane and epoch each item lands
on, so they are held against the reference at equal chunk and seg_steps,
and against its Pallas stepper (interpret mode; chunk <= 128, where the
reference does not pad the pool): its XLA stepper differs from its own
kernel at two memory edges that a flipped address register can reach
(ROADMAP queue 3). Under DMR every item equals the fault-free run at any
chunk, and `detected`/`corrected`/`quarantined` equal the reference's.
The cases follow the reference's `tests/test_faults.py`."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.flexibits import faults as rf
from repro.fleet import engine as reng
from repro.fleet import plan as rplan
from repro_torch import convert
from repro_torch.fleet import engine, plan
from repro_torch.flexibits import faults as pf

_FIELDS = ("n_instr", "halted", "out", "mems", "regs", "pc")
_COUNTERS = ("detected", "corrected", "quarantined")
_SCHEDULE = ("lane_steps", "n_segments", "seg_schedule", "host_syncs")
MILD = dict(rate=0.0008, seed=5, targets=("regs", "mem", "pc"))


def _fleet(mod, n=40, seed=0, max_steps=400):
    """The reference test's fleet: the skew program's counting loop on
    `n` items of 5..59 iterations, one group."""
    prog = tp.skew_program()
    mems = np.tile(prog.initial_memory(32), (n, 1))
    mems[:, 0] = np.random.default_rng(seed).integers(5, 60, size=n)
    return [mod.PackedGroup(code=prog.code, source=mod.array_source(mems),
                            n_items=n, max_steps=max_steps, mem_words=32,
                            out_addr=1)]


def _long_fleet(mod):
    """The reference's long-item regression fleet, shortened: 16 items,
    half of them 800 iterations long (~25 segments of 64 steps)."""
    prog = tp.skew_program()
    mems = tp.skew_mems(prog, 16, 64, 800, 0.5, 7)
    return [mod.PackedGroup(code=prog.code, source=mod.array_source(mems),
                            n_items=16, max_steps=100_000, mem_words=32,
                            out_addr=1)]


def _golden(groups_fn=_fleet):
    gold, _ = engine.run_packed(groups_fn(engine), chunk=16, seg_steps=64,
                                keep_state=True, device="cpu")
    return gold


def _assert_golden(gold, got, ctx):
    for a, b in zip(gold, got):
        for f in _FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{ctx}: {f}")


def _spec(**kw):
    return rf.FaultSpec(**kw), pf.FaultSpec(**kw)


@pytest.mark.parametrize("targets", [("regs",), ("regs", "mem", "pc")])
def test_run_packed_with_faults_matches_reference(targets):
    """Unprotected transients: every per-item field and the final state
    equal the reference's Pallas run at equal chunk/seg_steps, the run
    is reproducible, and the faults did corrupt something."""
    rspec, spec = _spec(rate=0.02, seed=5, targets=targets)
    kw = dict(chunk=16, seg_steps=64, keep_state=True)
    ref, rs = reng.run_packed(_fleet(reng), faults=rspec, stepper="pallas",
                              **kw)
    got, ps = engine.run_packed(_fleet(engine), faults=spec, device="cpu",
                                **kw)
    tp.assert_results_equal(ref, got, "faults")
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(ps, f), f
    again, _ = engine.run_packed(_fleet(engine), faults=spec, device="cpu",
                                 **kw)
    tp.assert_results_equal(got, again, "rerun")
    assert not np.array_equal(got[0].mems, _golden()[0].mems)
    assert (ps.redundancy, ps.detected) == ("none", 0)


def test_run_packed_with_faults_on_workload_groups_matches_reference():
    """Two FlexiBench groups with their own sources, timing on, adaptive
    segments, transients over regs, mem and pc."""
    from repro.flexibench.base import get as rget
    from repro_torch.flexibench.base import get as pget
    from repro_torch.flexibits.cycles import CORES, cost_row

    def groups(mod, get):
        return [mod.PackedGroup(
            code=get(k).program.code, source=mod.workload_source(get(k), i),
            n_items=n, max_steps=get(k).max_steps,
            mem_words=get(k).total_mem_words, out_addr=get(k).out_addr,
            cost=cost_row(CORES["QERV"], dynamic=True))
            for i, (k, n) in enumerate((("WQ", 14), ("MC", 10)))]
    rspec, spec = _spec(rate=3e-4, seed=2, targets=("regs", "mem", "pc"))
    kw = dict(chunk=12, seg_steps=256, keep_state=True, adaptive=True)
    ref, rs = reng.run_packed(groups(reng, rget), faults=rspec,
                              stepper="pallas", **kw)
    got, ps = engine.run_packed(groups(engine, pget), faults=spec,
                                device="cpu", **kw)
    tp.assert_results_equal(ref, got, "workload groups")
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(ps, f), f


def test_rate_zero_is_the_fault_free_run():
    got, ps = engine.run_packed(_fleet(engine), chunk=16, seg_steps=64,
                                keep_state=True, device="cpu",
                                faults=pf.FaultSpec(rate=0.0))
    tp.assert_results_equal(_golden(), got, "rate 0")


@pytest.mark.parametrize("case", ["mild", "dead", "fault_free"])
def test_dmr_recovers_golden_results_and_counts_like_reference(case):
    """DMR under mild transients (max_retries 6), dead lanes (max_retries
    1: pairs quarantine and their items are re-admitted) and no faults
    at all (pure overhead): every item equals the fault-free run, and the
    counters and schedule equal the reference's."""
    specs = {"mild": (MILD, 6), "dead": (dict(rate=0.3, seed=5,
                                              mode="dead"), 1),
             "fault_free": (None, 2)}
    kw_spec, retries = specs[case]
    rspec, spec = _spec(**kw_spec) if kw_spec else (None, None)
    kw = dict(chunk=32, seg_steps=64, keep_state=True, redundancy="dmr",
              max_retries=retries)
    ref, rs = reng.run_packed(_fleet(reng), faults=rspec, stepper="pallas",
                              **kw)
    got, ps = engine.run_packed(_fleet(engine), faults=spec, device="cpu",
                                **kw)
    _assert_golden(_golden(), got, case)
    tp.assert_results_equal(ref, got, case)
    for f in _COUNTERS + _SCHEDULE + ("redundancy", "chunk"):
        assert getattr(rs, f) == getattr(ps, f), f
    assert ps.corrected <= ps.detected
    if case == "mild":
        assert ps.detected > 0 and ps.corrected > 0
    elif case == "dead":
        assert ps.quarantined > 0
    else:
        assert (ps.detected, ps.corrected, ps.quarantined) == (0, 0, 0)


def test_dmr_long_items_accrue_transients_without_quarantine():
    """The mismatch count is consecutive: items that span ~25 segments
    accrue many independent transients and still never quarantine."""
    rspec, spec = _spec(**MILD)
    kw = dict(chunk=16, seg_steps=64, keep_state=True, redundancy="dmr",
              max_retries=6)
    ref, rs = reng.run_packed(_long_fleet(reng), faults=rspec, **kw)
    got, ps = engine.run_packed(_long_fleet(engine), faults=spec,
                                device="cpu", **kw)
    assert ps.detected > 10 and ps.quarantined == 0
    for f in _COUNTERS:
        assert getattr(rs, f) == getattr(ps, f), f
    _assert_golden(_golden(_long_fleet), got, "long items")


@pytest.mark.parametrize("chunk", [5, 18, 100])
def test_dmr_results_equal_fault_free_at_any_chunk(chunk):
    """Pools of odd and even requests (rounded up to whole pairs, and
    capped at two lanes per item): the items still equal the fault-free
    run."""
    got, ps = engine.run_packed(
        _fleet(engine), chunk=chunk, seg_steps=48, keep_state=True,
        redundancy="dmr", max_retries=6, faults=pf.FaultSpec(**MILD),
        device="cpu")
    assert ps.chunk == min(chunk + chunk % 2, 80)
    _assert_golden(_golden(), got, f"chunk {chunk}")


def test_dmr_starved_pool_raises_like_reference():
    """One dead lane in each of the two pairs (seed 4) and no retry: both
    pairs quarantine and the run stops with the reference's error."""
    rspec, spec = _spec(rate=0.5, seed=4, mode="dead")
    kw = dict(chunk=4, seg_steps=64, redundancy="dmr", max_retries=0)
    with pytest.raises(RuntimeError, match="DMR pool starved") as r:
        reng.run_packed(_fleet(reng, n=6), faults=rspec, **kw)
    with pytest.raises(RuntimeError, match="DMR pool starved") as p:
        engine.run_packed(_fleet(engine, n=6), faults=spec, device="cpu",
                          **kw)
    assert str(p.value) == str(r.value)


def _dmr_op_inputs(rng, chunk=24, mem_words=16, n_groups=2, n_staged=7):
    """A mid-run DMR boundary: active pairs whose shadow diverged in a
    few lanes, pairs at their retry limit, a quarantined pair, staged
    rows and a rollback snapshot."""
    st = tp.soup_state(rng, chunk, mem_words, n_groups)
    lanes = st.lanes._replace(
        n_instr=rng.integers(1, 40, chunk).astype(np.int32),
        halted=rng.random(chunk) < 0.4)
    pairs = chunk // 2
    # shadows copy their primaries, then a few diverge
    for f in ("regs", "pc", "mem", "halted", "n_instr"):
        x = getattr(lanes, f)
        x[1::2] = x[0::2]
    div = rng.choice(pairs, 5, replace=False)
    lanes.regs[2 * div + 1, 3] ^= 0x10
    st = st._replace(lanes=lanes, prog_id=np.repeat(
        rng.integers(0, n_groups, pairs), 2).astype(np.int32),
        max_steps=np.full(chunk, 30, np.int32))
    slot = np.full(chunk, -1, np.int32)
    slot[0::2] = np.where(rng.random(pairs) < 0.8,
                          rng.permutation(40)[:pairs], -1)
    snap = tp.soup_state(rng, chunk, mem_words, n_groups).lanes
    acc_n = 40
    acc = dict(n_instr=np.zeros(acc_n, np.int32),
               n_two=np.zeros(acc_n, np.int32),
               n_cycles=np.zeros(acc_n, np.int32),
               halted=np.zeros(acc_n, bool), out=np.zeros(acc_n, np.int32),
               mix_g=np.zeros((1, n_groups, 8), np.int32),
               prev_instr=rng.integers(0, 5, chunk).astype(np.int32),
               mems=np.zeros((acc_n, mem_words), np.int32),
               regs=np.zeros((acc_n, 16), np.int32),
               pc=np.zeros(acc_n, np.int32),
               mix_items=np.zeros((acc_n, 8), np.int32))
    staged = (rng.integers(-9, 9, (chunk, mem_words)).astype(np.int32),
              rng.integers(0, n_groups, chunk).astype(np.int32),
              rng.integers(5, 50, chunk).astype(np.int32),
              (40 + np.arange(chunk)).astype(np.int32))
    return dict(state=st, slot=slot,
                epoch=rng.integers(0, 5, chunk).astype(np.int32),
                retries=np.where(np.arange(pairs) % 3 == 0, 2, 0
                                 ).astype(np.int32),
                quar=np.arange(pairs) == pairs - 1, snap=snap, acc=acc,
                staged=staged, n_staged=np.array([n_staged], np.int32),
                out_addr=np.array([3, -1], np.int32), n_groups=n_groups)


@pytest.mark.parametrize("n_staged", [0, 7, 24])
def test_retire_refill_dmr_matches_reference_op(n_staged):
    """The DMR retire/refill op against the reference's compiled
    `_resident_refill_runner(dmr=True)` at one shard: the pool, item
    rows, epochs, retry counts, quarantine flags, accumulators and the
    stats block [retired, taken, delta, mismatches, rollbacks, q_slot,
    active per group], bit for bit."""
    rng = np.random.default_rng(40 + n_staged)
    d = _dmr_op_inputs(rng, n_staged=n_staged)
    keep_state, max_retries = True, 2
    fn = reng._resident_refill_runner(None, 16, d["n_groups"], keep_state,
                                      False, False, True, max_retries)
    from repro.flexibits import iss as riss
    j = jnp.asarray
    rst = riss.PackedState(
        lanes=riss.ISSState(*(j(x) for x in d["state"].lanes)),
        prog_id=j(d["state"].prog_id), max_steps=j(d["state"].max_steps))
    racc = reng.ResidentAcc(**{k: j(v) for k, v in d["acc"].items()})
    rsnap = riss.ISSState(*(j(x) for x in d["snap"]))
    want = fn(rst, j(d["slot"]), j(d["epoch"]), j(d["retries"]),
              j(d["quar"]), rsnap, racc,
              *(j(x)[None] for x in d["staged"]), j(d["n_staged"]),
              j(d["out_addr"]))
    t = torch.from_numpy
    got = engine.retire_refill_dmr(
        convert.packed_to_torch(d["state"], "cpu"), t(d["slot"].copy()),
        t(d["epoch"].copy()), t(d["retries"].copy()), t(d["quar"].copy()),
        convert.state_to_torch(d["snap"], "cpu"),
        convert.acc_to_torch(reng.ResidentAcc(**d["acc"]), "cpu"),
        *(t(x.copy()) for x in d["staged"]), t(d["n_staged"].copy()),
        t(d["out_addr"].copy()), d["n_groups"], max_retries, device="cpu")
    tp.assert_packed_equal(want[0], convert.packed_to_numpy(got[0]), "pool")
    for name, a, b in zip(("slot", "epoch", "retries", "quar"), want[1:5],
                          got[1:5]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    got_acc = convert.acc_to_numpy(got[5])
    for f in reng.ResidentAcc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want[5], f)),
                                      getattr(got_acc, f), err_msg=f)
    np.testing.assert_array_equal(np.asarray(want[6])[0], got[6].numpy())
    sv = got[6].numpy()
    assert sv[3] > 0 and sv[4] > 0 and sv[5] >= 0   # the op's paths ran


def test_run_stream_matches_reference():
    """The single-group entry point, faults and DMR on."""
    prog = tp.skew_program()
    mems = tp.skew_mems(prog, 30, 8, 200, 0.3, 3)
    rspec, spec = _spec(**MILD)
    kw = dict(n_items=30, mem_words=32, max_steps=5000, chunk=16,
              seg_steps=64, out_addr=1, keep_state=True, redundancy="dmr",
              max_retries=6)
    want = reng.run_stream(prog.code, reng.array_source(mems),
                           faults=rspec, **kw)
    got = engine.run_stream(prog.code, engine.array_source(mems),
                            faults=spec, device="cpu", **kw)
    tp.assert_results_equal([want], [got], "run_stream")
    assert (want.lane_steps, want.n_segments, want.chunk) == \
        (got.lane_steps, got.n_segments, got.chunk)


_REPORT_FIELDS = ("energy_j_per_exec", "fleet_exec_kwh", "operational_kg",
                  "embodied_kg", "total_kg", "recommended_core",
                  "measured_cycles", "wcet_cycles", "certified_energy_j",
                  "certified_operational_kg")


@pytest.mark.parametrize("redundancy", ["dmr", "none"])
def test_run_plan_prices_resilience_like_reference(redundancy):
    """`FleetPlan(faults=..., redundancy=...)` through `run_plan`: every
    GroupReport float, the per-item results and the report's resilience
    line equal the reference's; under DMR the items equal the fault-free
    plan's and the carbon is strictly higher."""
    def mk(mod, faults, red):
        return mod.FleetPlan(groups=[
            mod.FleetGroup("WQ", n_items=8, seed=1),
            mod.FleetGroup("MC", core="HERV", n_items=6, seed=2,
                           max_steps="static")],
            chunk=16, seg_steps=128, timing="dynamic", faults=faults,
            redundancy=red, max_retries=6)
    rspec, spec = _spec(rate=2e-4, seed=5, targets=("regs", "mem", "pc"))
    ref = rplan.run_plan(mk(rplan, rspec, redundancy), keep_state=True)
    got = plan.run_plan(mk(plan, spec, redundancy), keep_state=True,
                        device="cpu")
    base = plan.run_plan(mk(plan, None, "none"), keep_state=True,
                         device="cpu")
    for a, b, c in zip(ref.groups, got.groups, base.groups):
        for f in _REPORT_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert dataclasses.astuple(a.profile) == \
            dataclasses.astuple(b.profile)
        if redundancy == "dmr":
            np.testing.assert_array_equal(b.result.out, c.result.out)
            np.testing.assert_array_equal(b.result.n_instr,
                                          c.result.n_instr)
            assert b.total_kg > c.total_kg
    tp.assert_results_equal([g.result for g in ref.groups],
                            [g.result for g in got.groups], "plan")
    for f in _COUNTERS + ("redundancy",):
        assert getattr(ref.packed, f) == getattr(got.packed, f), f
    rl = [x for x in ref.format().splitlines() if "resilience" in x]
    gl = [x for x in got.format().splitlines() if "resilience" in x]
    assert rl == gl and len(gl) == (redundancy == "dmr")
    assert "resilience" not in base.format()
