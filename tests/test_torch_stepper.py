"""The reference's baseline steppers, ported as plain torch
(`repro_torch/flexibits/iss.py`), against `repro.flexibits.iss` on the
CPU, every field bit for bit: the `lax.switch` interpreter (`step`,
`run`, `run_segment`, `run_segment_banked`, `run_fleet`) and the
branchless stepper with the reference's XLA memory ports
(`step_branchless`, `step_lanes`, `run_segment_lanes`, and the banked
stepper with `edges="xla"`), on instruction soups (odd fields, opcodes
outside RV32E, loads and stores at both memory edges), on the 11
FlexiBench workloads, timing on and off, and under faults; then the
engine's `stepper=` for all three names against the reference's same
stepper, schedule statistics and host syncs included."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.flexibits import faults as rfaults
from repro.flexibits import iss as riss
from repro.fleet import engine as reng
from repro.fleet import plan as rplan
from repro_torch import convert
from repro_torch.flexibench.base import all_workloads, get
from repro_torch.flexibits import iss
from repro_torch.flexibits.cycles import CORES, cost_row
from repro_torch.fleet import engine, plan

M = 48


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _j(st):
    """A numpy `ISSState` -> the reference's, as jnp arrays."""
    return riss.ISSState(*(jnp.asarray(x) for x in st))


def _assert_state(ref, got, ctx):
    tp.assert_packed_equal(
        iss.PackedState(riss.ISSState(*(np.asarray(x) for x in ref)), 0, 0),
        iss.PackedState(convert.state_to_numpy(got), 0, 0), ctx)


def _soup_lanes(rng, n_lanes, code_len):
    """Soup lanes on one program, each at a random pc inside it (a few
    just past its end: the fetch clamps)."""
    st = tp.soup_state(rng, n_lanes, M, 1).lanes
    return st._replace(pc=(4 * rng.integers(0, code_len + 2, n_lanes)
                           ).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _ref_step(kind: str, bounded: bool, timing: bool):
    fn = riss.step if kind == "switch" else riss.step_branchless

    def one(code, s, ml, cost):
        kw = {"mem_len": ml} if bounded else {}
        return fn(code, s, cost=cost if timing else None, **kw)
    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, None)))


@pytest.mark.parametrize("timing", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("kind", ["switch", "branchless"])
def test_step_matches_reference_on_soups(kind, bounded, timing):
    """`step` / `step_branchless` on 96 soup lanes, four steps in a row,
    with and without a per-lane memory bound (then the two memory edges
    of the XLA ports show: a store to a negative word index wraps to the
    row's end, and the branchless load past mem_len writes the clamped
    word into the pad)."""
    rng = np.random.default_rng(100 + 4 * bounded + 2 * timing
                                + (kind == "switch"))
    bank, clen = tp.soup_bank(rng, 1, 40, M)
    code = bank[0, :clen[0]]
    st = _soup_lanes(rng, 96, int(clen[0]))
    ml = rng.integers(1, M + 1, 96).astype(np.int32)
    cost = tp.soup_cost(rng, 1)[0]
    ref_fn = _ref_step(kind, bounded, timing)
    port_fn = iss.step if kind == "switch" else iss.step_branchless
    ref, got = _j(st), convert.state_to_torch(st, "cpu")
    kw = {"mem_len": _t(ml)} if bounded else {}
    for k in range(4):
        ref = ref_fn(jnp.asarray(code), ref, jnp.asarray(ml),
                     jnp.asarray(cost))
        got = port_fn(_t(code), got, cost=_t(cost) if timing else None,
                      **kw)
        _assert_state(ref, got, f"{kind} step {k}")


@functools.lru_cache(maxsize=None)
def _ref_banked_segment(kind: str, seg_steps: int, timing: bool):
    if kind == "xla":
        def seg(bank, clen, ps, ml, cost):
            return riss.run_segment_lanes_banked(
                bank, clen, ps, seg_steps, None, ml,
                cost if timing else None).lanes
    else:
        def seg(bank, clen, ps, ml, cost):
            return jax.vmap(lambda p, m, s: riss.run_segment_banked(
                bank, clen, p, m, s, seg_steps, ml,
                cost if timing else None))(ps.prog_id, ps.max_steps,
                                           ps.lanes)
    return jax.jit(seg)


def _port_banked_segment(kind, bank, clen, ps, seg_steps, ml, cost):
    if kind == "xla":
        return iss.run_segment_lanes_banked(
            bank, clen, ps, seg_steps, None, ml, cost, edges="xla").lanes
    return iss.run_segment_banked(bank, clen, ps.prog_id, ps.max_steps,
                                  ps.lanes, seg_steps, ml, cost)


def _banked_segments(kind, bank, clen, mlen, cost, st, seg_steps, n_seg):
    fn = _ref_banked_segment(kind, seg_steps, cost is not None)
    ref_ps = riss.PackedState(_j(st.lanes), jnp.asarray(st.prog_id),
                              jnp.asarray(st.max_steps))
    got_ps = convert.packed_to_torch(st, "cpu")
    co = np.zeros((len(clen), 19), np.int32) if cost is None else cost
    for k in range(n_seg):
        ref = fn(jnp.asarray(bank), jnp.asarray(clen), ref_ps,
                 jnp.asarray(mlen), jnp.asarray(co))
        got = _port_banked_segment(kind, _t(bank), _t(clen), got_ps,
                                   seg_steps, _t(mlen),
                                   None if cost is None else _t(cost))
        _assert_state(ref, got, f"{kind} segment {k}")
        ref_ps = ref_ps._replace(lanes=ref)
        got_ps = got_ps._replace(lanes=got)


@pytest.mark.parametrize("timing", [False, True])
@pytest.mark.parametrize("kind", ["switch", "xla"])
def test_banked_segments_match_reference_on_edge_soups(kind, timing):
    """`run_segment_banked` (the engine's "switch") and
    `run_segment_lanes_banked(edges="xla")` (its "branchless") on random
    programs and the memory-edge programs in one bank, with mixed
    per-program bounds, halted lanes and lanes past their budget: three
    segments of 48 steps."""
    rng = np.random.default_rng(200 + 2 * timing + (kind == "xla"))
    bank, clen, mlen, st = tp.edge_soup(rng, 64, M)
    cost = tp.soup_cost(rng, len(clen)) if timing else None
    _banked_segments(kind, bank, clen, mlen, cost, st, 48, 3)


@pytest.mark.parametrize("kind", ["switch", "xla"])
def test_banked_segments_match_reference_on_workloads(kind):
    """All 11 FlexiBench workloads in one pool (22 lanes, dynamic cost
    rows of SERV, QERV and HERV), two segments of 300 steps."""
    bank, clen, mlen, cost, st = tp.workload_pool(22, seed=3)
    _banked_segments(kind, bank, clen, mlen, cost, st, 300, 2)


@pytest.mark.parametrize("timing", [False, True])
def test_run_and_unbanked_segments_match_reference(timing):
    """`run_fleet` and `run` to the ecall, `run_segment` resumed in
    segments, and `step_lanes` / `run_segment_lanes` on MC and WQ
    items."""
    from repro.flexibits.fleet import fleet_inputs
    for key in ("MC", "WQ"):
        w = get(key)
        code = w.program.code.view(np.int32)
        mems = fleet_inputs(w, 6, seed=5)
        cost = cost_row(CORES["QERV"], dynamic=True) if timing else None
        rc = None if cost is None else jnp.asarray(cost)
        pc_ = None if cost is None else _t(cost)
        ref = riss.run_fleet(jnp.asarray(code), jnp.asarray(mems),
                             w.max_steps, rc)
        got = iss.run_fleet(_t(code), _t(mems), w.max_steps, pc_)
        _assert_state(ref, got, f"{key} run_fleet")
        assert np.asarray(ref.halted).all()
        ref1 = riss.run(jnp.asarray(code), jnp.asarray(mems[0]),
                        w.max_steps, rc)
        got1 = iss.run(_t(code), _t(mems[0]), w.max_steps, pc_)
        assert got1.pc.dim() == 0
        _assert_state(jax.tree.map(lambda x: x[None], ref1),
                      iss.ISSState(*(x[None] for x in got1)), f"{key} run")

        rs = riss.init_state(jnp.asarray(mems[1]))
        ps = iss.init_state(_t(mems[1]))
        for k in range(4):
            rs = jax.jit(lambda s: riss.run_segment(
                jnp.asarray(code), s, 5, w.max_steps, rc))(rs)
            ps = iss.run_segment(_t(code), ps, 5, w.max_steps, pc_)
            _assert_state(jax.tree.map(lambda x: x[None], rs),
                          iss.ISSState(*(x[None] for x in ps)),
                          f"{key} run_segment {k}")

        rl = jax.vmap(riss.init_state)(jnp.asarray(mems))
        pl = iss.init_state(_t(mems))
        sub = riss.opcode_subset(w.program.code)
        rl = jax.jit(lambda s: riss.step_lanes(jnp.asarray(code), s, sub,
                                               cost=rc))(rl)
        pl = iss.step_lanes(_t(code), pl, sub, cost=pc_)
        _assert_state(rl, pl, f"{key} step_lanes")
        rl = jax.jit(lambda s: riss.run_segment_lanes(
            jnp.asarray(code), s, 7, w.max_steps, sub, unroll=3,
            cost=rc))(rl)
        pl = iss.run_segment_lanes(_t(code), pl, 7, w.max_steps, sub,
                                   unroll=3, cost=pc_)
        _assert_state(rl, pl, f"{key} run_segment_lanes")


def test_faulty_run_segment_lanes_matches_reference():
    """Transients on regs, mem and pc at rate 0.05 through
    `run_segment_lanes` (the reference test's fleet of 8 skew items, 400
    steps), against the reference's; and the port's switch stepper under
    the same schedule retires the same trajectories."""
    prog = tp.skew_program()
    code = prog.code.view(np.int32)
    mems = np.tile(prog.initial_memory(32), (8, 1))
    mems[:, 0] = np.random.default_rng(0).integers(5, 60, size=8)
    rspec = rfaults.FaultSpec(rate=0.05, seed=3,
                              targets=("regs", "mem", "pc"))
    spec = convert.fault_spec_from(rspec)
    keys = rfaults.lane_keys(rspec.seed, len(mems))
    ref = riss.run_segment_lanes(
        jnp.asarray(code), jax.vmap(riss.init_state)(jnp.asarray(mems)),
        seg_steps=400, max_steps=400, faults=rspec,
        lane_key=jnp.asarray(keys), epoch=jnp.zeros(8, jnp.int32))
    pkeys = _t(keys.view(np.int32))
    z = torch.zeros(8, dtype=torch.int32)
    got = iss.run_segment_lanes(_t(code), iss.init_state(_t(mems)),
                                seg_steps=400, max_steps=400, faults=spec,
                                lane_key=pkeys, epoch=z)
    _assert_state(ref, got, "faulty run_segment_lanes")
    sw = iss.run_segment_banked(
        _t(code)[None], torch.tensor([len(code)], dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.full((8,), 400),
        iss.init_state(_t(mems)), 400, faults=spec, lane_key=pkeys,
        epoch=z)
    for f in ("regs", "pc", "mem", "halted", "n_instr"):
        assert torch.equal(getattr(sw, f), getattr(got, f)), f
    assert not np.array_equal(np.asarray(ref.mem),
                              np.asarray(jax.vmap(lambda m: riss.run(
                                  jnp.asarray(code), m, 400))(
                                  jnp.asarray(mems)).mem))  # faults fired


_SCHEDULE = ("lane_steps", "n_segments", "seg_schedule", "host_syncs")


@pytest.mark.parametrize("stepper", ["branchless", "pallas", "switch"])
def test_run_packed_steppers_match_reference(stepper):
    """`run_packed(stepper=...)` against the reference's same stepper on
    the skew plan (chunk 16, seg_steps 64, adaptive, keep_state): every
    per-item field, the final state, the schedule and the host syncs;
    `stats.stepper` names the route."""
    ref, rs = reng.run_packed(tp.skew_groups(reng), chunk=16, seg_steps=64,
                              keep_state=True, adaptive=True,
                              stepper=stepper)
    got, ps = engine.run_packed(tp.skew_groups(engine), chunk=16,
                                seg_steps=64, keep_state=True,
                                adaptive=True, stepper=stepper,
                                device="cpu")
    tp.assert_results_equal(ref, got, stepper)
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(ps, f), f
    want = "plain" if stepper == "pallas" else stepper
    assert ps.stepper == want and got[0].stepper == want


@pytest.mark.parametrize("stepper", ["branchless", "switch"])
def test_steppers_through_run_plan_and_host_loop(stepper):
    """`FleetPlan.stepper` through `run_plan` (packed, and `packed=False`
    on the host loop), against the reference's plan with the same
    stepper, on MC and WQ with dynamic timing."""
    def fleet(mod, **kw):
        return mod.FleetPlan(groups=(
            mod.FleetGroup(workload="MC", core="SERV", n_items=20, seed=0),
            mod.FleetGroup(workload="WQ", core="HERV", n_items=14, seed=1),
        ), chunk=12, seg_steps=32, timing="dynamic", stepper=stepper, **kw)
    for kw in ({}, {"packed": False, "refill": "host"}):
        want = rplan.run_plan(fleet(rplan, **kw), keep_state=True)
        got = plan.run_plan(fleet(plan, **kw), keep_state=True,
                            device="cpu")
        tp.assert_results_equal([g.result for g in want.groups],
                                [g.result for g in got.groups],
                                f"{stepper} {kw}")
        assert all(g.result.stepper == stepper for g in got.groups)


def test_default_stepper_is_the_kernel_route():
    """The port's default stepper is "pallas" (the kernel route; the
    reference's default is "branchless"), and it is bit for bit the
    reference's default on FlexiBench groups."""
    assert plan.FleetPlan(groups=()).stepper == "pallas"
    assert engine.STEPPERS == reng.STEPPERS
    ws = [w for w in all_workloads() if w.key in ("AD", "WQ")]

    def groups(mod, get_):
        return [mod.PackedGroup(
            code=w.program.code, source=mod.workload_source(get_(w.key), 2),
            n_items=10, max_steps=w.max_steps, mem_words=w.total_mem_words,
            out_addr=w.out_addr) for w in ws]
    from repro.flexibench.base import get as rget
    ref, _ = reng.run_packed(groups(reng, rget), chunk=8, seg_steps=256,
                             keep_state=True)
    got, ps = engine.run_packed(groups(engine, get), chunk=8, seg_steps=256,
                                keep_state=True, device="cpu")
    tp.assert_results_equal(ref, got, "default steppers")
    assert ps.stepper == "plain"


def test_unknown_stepper_raises_reference_text():
    def run(mod, **kw):
        return mod.run_packed(tp.skew_groups(mod), stepper="vliw", **kw)
    with pytest.raises(ValueError) as r:
        run(reng)
    with pytest.raises(ValueError) as p:
        run(engine, device="cpu")
    assert str(r.value) == str(p.value)
    with pytest.raises(ValueError):
        iss.run_segment_lanes_banked(
            torch.zeros((1, 1), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
            convert.packed_to_torch(tp.soup_state(
                np.random.default_rng(0), 2, 4, 1), "cpu"), 1, edges="tpu")
