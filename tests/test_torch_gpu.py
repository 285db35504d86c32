"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: every test asks the `cuda` fixture for the device, which
skips when there is no card, so here (CPU only) they all skip. Run them
on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The plain versions are the port's `flexibits/iss.py` (with the
FlexiFault transform of `flexibits/faults.py`),
`kernels/carbon_sweep.py::sweep_tile_plain` (and
`sweep_tile_drawn_plain`) and the LM kernels'
`*_plain` functions, which the CPU tests hold against the reference; no
JAX is needed here. The sweep comparisons use
`_torch_parity`'s tolerances (bit for bit but the per-cell sums, and
values at a bin edge).
"""
import numpy as np
import pytest
import torch

import _torch_parity as tp
from repro_torch import convert
from repro_torch.core import selection as psel
from repro_torch.core import sweep as psweep
from repro_torch.fleet import engine
from repro_torch.flexibits import faults as pf
from repro_torch.flexibits import iss
from repro_torch.kernels import carbon_sweep as pcs
from repro_torch.kernels import iss_stepper

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _segments(dev, bank, clen, mlen, cost, state, seg_steps, n_segs,
              subset=None, faults=None, epoch=None):
    a = convert.packed_to_torch(state, dev)
    b = convert.packed_to_torch(state, dev)
    bank, clen, mlen = _t(bank, dev), _t(clen, dev), _t(mlen, dev)
    cost = None if cost is None else _t(cost, dev)
    n = len(state.prog_id)
    fk = {} if faults is None else dict(
        faults=faults, lane_key=pf.lane_keys_tensor(faults.seed, n, dev),
        epoch=_t(epoch, dev))
    for k in range(n_segs):
        a = iss_stepper.iss_segment_banked(bank, clen, a, seg_steps=seg_steps,
                                           mem_len=mlen, cost=cost,
                                           device=dev, **fk)
        b = iss.run_segment_lanes_banked(bank, clen, b, seg_steps, subset,
                                         mlen, cost, **fk)
        torch.cuda.synchronize()
        tp.assert_packed_equal(convert.packed_to_numpy(b),
                               convert.packed_to_numpy(a), f"segment {k}")


@pytest.mark.parametrize("timing", [False, True])
def test_segment_kernel_matches_plain_on_workloads(cuda, timing):
    bank, clen, mlen, cost, st = tp.workload_pool(77, seed=4)
    _segments(cuda, bank, clen, mlen, cost if timing else None, st, 256, 3)


@pytest.mark.parametrize("timing", [False, True])
def test_segment_kernel_matches_plain_on_soups(cuda, timing):
    rng = np.random.default_rng(55 + timing)
    bank, clen = tp.soup_bank(rng, 7, 32, 64)
    mlen = rng.integers(8, 65, 7).astype(np.int32)
    cost = tp.soup_cost(rng, 7) if timing else None
    _segments(cuda, bank, clen, mlen, cost, tp.soup_state(rng, 300, 64, 7),
              64, 3)


_FAULT_SPECS = {
    "transient": pf.FaultSpec(rate=1e-2, seed=3,
                              targets=("regs", "mem", "pc")),
    "always": pf.FaultSpec(rate=1.0, seed=4, targets=("regs", "mem", "pc")),
    "stuck": pf.FaultSpec(rate=0.5, seed=5, mode="stuck"),
    "dead": pf.FaultSpec(rate=0.5, seed=6, mode="dead"),
}


@pytest.mark.parametrize("timing", [False, True])
@pytest.mark.parametrize("mode", sorted(_FAULT_SPECS))
def test_fault_kernel_matches_plain(cuda, mode, timing):
    """The faults variant against the plain faulty stepper: soups (wild
    addresses, mixed memory bounds, nonzero epochs) and the 11
    workloads, full state bit for bit after every segment."""
    rng = np.random.default_rng(70 + timing)
    spec = _FAULT_SPECS[mode]
    bank, clen = tp.soup_bank(rng, 7, 32, 64)
    mlen = rng.integers(8, 65, 7).astype(np.int32)
    cost = tp.soup_cost(rng, 7) if timing else None
    iss_stepper.reset_counts()
    _segments(cuda, bank, clen, mlen, cost, tp.soup_state(rng, 300, 64, 7),
              64, 3, faults=spec, epoch=rng.integers(0, 9, 300)
              .astype(np.int32))
    assert iss_stepper.iss_segment_banked.fault_launches == 3
    assert iss_stepper.iss_segment_banked.launches == 0
    bank, clen, mlen, cost, st = tp.workload_pool(77, seed=5)
    _segments(cuda, bank, clen, mlen, cost if timing else None, st, 256, 2,
              faults=spec, epoch=np.arange(77, dtype=np.int32) % 5)


@pytest.mark.parametrize("timing", [False, True])
@pytest.mark.parametrize("mode", ["none"] + sorted(_FAULT_SPECS))
def test_segment_kernel_mixed_pool_with_parked_lanes(cuda, mode, timing):
    """The 11 workloads in one pool (memory rows of 64 to 2,824 words),
    some lanes halted or past their budget, so that the warps' lanes mix
    programs and parked lanes: every fault mode, full state bit for bit
    after every segment."""
    bank, clen, mlen, cost, st = tp.parked_workload_pool(300, seed=12)
    spec = None if mode == "none" else _FAULT_SPECS[mode]
    _segments(cuda, bank, clen, mlen, cost if timing else None, st, 256, 2,
              faults=spec, epoch=np.arange(300, dtype=np.int32) % 3)


def test_iss_segment_wrapper_on_card_matches_plain(cuda):
    prog = tp.skew_program()
    mems = tp.skew_mems(prog, 64, 8, 300, 0.3, 5)
    code = torch.from_numpy(np.asarray(prog.code, np.uint32).view(np.int32))
    spec = _FAULT_SPECS["transient"]
    out = []
    for dev in (cuda, "cpu"):
        out.append(iss_stepper.iss_segment(
            code.to(dev), iss.fresh_lanes(_t(mems, dev)), seg_steps=700,
            max_steps=650, faults=spec,
            lane_key=pf.lane_keys_tensor(spec.seed, 64, dev),
            epoch=torch.zeros(64, dtype=torch.int32, device=dev),
            device=dev))
    torch.cuda.synchronize()
    for f, a, b in zip(iss.ISSState._fields, *out):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(), err_msg=f)


@pytest.mark.parametrize("redundancy", ["none", "dmr"])
def test_resilient_run_packed_on_card_matches_cpu(cuda, redundancy):
    """Unprotected transients and DMR on the skew groups: per-item
    results, final state, schedule and DMR counters equal on card and
    CPU; DMR's items equal the fault-free run."""
    spec = pf.FaultSpec(rate=2e-3, seed=5, targets=("regs", "mem", "pc"))
    kw = dict(chunk=16, seg_steps=64, keep_state=True, faults=spec,
              redundancy=redundancy, max_retries=6)
    iss_stepper.reset_counts()
    gpu, sg = engine.run_packed(tp.skew_groups(engine), device=cuda, **kw)
    assert iss_stepper.iss_segment_banked.fault_launches > 0
    assert iss_stepper.iss_refill.launches > 0
    assert iss_stepper.iss_segment_banked.plain_calls == 0
    cpu, sc = engine.run_packed(tp.skew_groups(engine), device="cpu", **kw)
    tp.assert_results_equal(cpu, gpu, "card vs cpu")
    for f in ("lane_steps", "n_segments", "seg_schedule", "detected",
              "corrected", "quarantined"):
        assert getattr(sg, f) == getattr(sc, f), f
    if redundancy == "dmr":
        assert sg.detected > 0
        gold, _ = engine.run_packed(tp.skew_groups(engine), device=cuda,
                                    chunk=16, seg_steps=64, keep_state=True)
        tp.assert_results_equal(gold, gpu, "dmr vs fault-free")


def _launches():
    return (iss_stepper.iss_segment_banked.launches,
            iss_stepper.iss_refill.launches,
            iss_stepper.iss_segment_banked.plain_calls
            + iss_stepper.iss_refill.plain_calls)


@pytest.mark.parametrize("adaptive", [False, True])
def test_host_loop_on_card_matches_cpu(cuda, adaptive):
    """The host-refill loop on the card: its segments run the kernel (no
    refill kernel: the loop rebuilds lanes with torch ops), and its
    per-item results, final state, schedule and host syncs equal the
    CPU's."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True, refill="host",
              adaptive=adaptive)
    iss_stepper.reset_counts()
    gpu, sg = engine.run_packed(tp.skew_groups(engine), device=cuda, **kw)
    seg, ref, plain = _launches()
    assert seg == sg.n_segments and ref == 0 and plain == 0
    cpu, sc = engine.run_packed(tp.skew_groups(engine), device="cpu", **kw)
    tp.assert_results_equal(cpu, gpu, "card vs cpu")
    for f in ("lane_steps", "n_segments", "seg_schedule", "host_syncs",
              "refill"):
        assert getattr(sg, f) == getattr(sc, f), f


def test_fallback_past_the_mix_bound_on_card(cuda):
    """11,000 MC items at a 200,000-step budget fall back to the host loop
    on the card too, equal to the CPU's run."""
    from repro_torch.flexibench.base import get

    def groups():
        w = get("MC")
        return [engine.PackedGroup(
            code=w.program.code, source=engine.workload_source(w, seed=3),
            n_items=11_000, max_steps=200_000, mem_words=w.total_mem_words,
            out_addr=w.out_addr)]
    iss_stepper.reset_counts()
    gpu, sg = engine.run_packed(groups(), chunk=2048, seg_steps=64,
                                device=cuda)
    assert sg.refill == "host" and _launches()[0] > 0 and not _launches()[2]
    cpu, sc = engine.run_packed(groups(), chunk=2048, seg_steps=64,
                                device="cpu")
    tp.assert_results_equal(cpu, gpu, "fallback")
    assert gpu[0].halted.all() and sg.host_syncs == sc.host_syncs


def test_sequential_plan_on_card_matches_cpu(cuda):
    from repro_torch.fleet import FleetGroup, FleetPlan, run_plan
    plan = FleetPlan(groups=(
        FleetGroup(workload="MC", core="SERV", n_items=40, seed=0),
        FleetGroup(workload="WQ", core="QERV", n_items=24, seed=1)),
        chunk=16, seg_steps=64, packed=False, timing="dynamic")
    gpu = run_plan(plan, keep_state=True, device=cuda)
    cpu = run_plan(plan, keep_state=True, device="cpu")
    assert gpu.packed is None and cpu.packed is None
    tp.assert_results_equal([g.result for g in cpu.groups],
                            [g.result for g in gpu.groups], "sequential")
    assert [g.total_kg for g in gpu.groups] == \
        [g.total_kg for g in cpu.groups]


@pytest.mark.parametrize("crash_on", ["cuda", "cpu"])
def test_checkpoint_crosses_card_and_cpu(cuda, crash_on, tmp_path):
    """A stream checkpointed and crashed on one device resumes on the
    other, bit for bit with an uninterrupted run and its schedule."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True)

    def groups():
        return tp.skew_groups(engine, max_steps_b=100_000)
    gold, gs = engine.run_packed(groups(), device="cpu", **kw)
    devs = {"cuda": cuda, "cpu": "cpu"}
    resume_on = "cpu" if crash_on == "cuda" else "cuda"
    cdir = str(tmp_path / "ck")
    iss_stepper.reset_counts()
    with pytest.raises(engine.InjectedFault):
        engine.run_packed(groups(), checkpoint_dir=cdir, checkpoint_every=4,
                          _crash_after_segments=10, device=devs[crash_on],
                          **kw)
    res, rs = engine.run_packed(groups(), checkpoint_dir=cdir,
                                checkpoint_every=4, device=devs[resume_on],
                                **kw)
    seg, ref, _ = _launches()
    assert seg > 0 and ref > 0
    tp.assert_results_equal(gold, res, f"crashed on {crash_on}")
    for f in ("lane_steps", "n_segments", "seg_schedule"):
        assert getattr(gs, f) == getattr(rs, f), f


def test_refill_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    st = tp.soup_state(rng, 200, 96, 5)
    st = st._replace(lanes=st.lanes._replace(
        n_instr=rng.integers(0, 50, 200).astype(np.int32),
        mix=rng.integers(0, 9, (200, 8)).astype(np.int32)))
    free = _t(rng.random(200) < 0.6, cuda)
    for n_staged in (0, 37, 200):
        take, src = iss.refill_take(
            free, torch.tensor([n_staged], dtype=torch.int32, device=cuda))
        staged = (_t(rng.integers(-99, 99, (150, 96)).astype(np.int32), cuda),
                  _t(rng.integers(0, 5, 150).astype(np.int32), cuda),
                  _t(rng.integers(1, 99, 150).astype(np.int32), cuda))
        ps = convert.packed_to_torch(st, cuda)
        want = iss.refill_lanes(ps, take, src, *staged)
        got = iss_stepper.iss_refill(ps, take, src, *staged, device=cuda)
        torch.cuda.synchronize()
        tp.assert_packed_equal(convert.packed_to_numpy(want),
                               convert.packed_to_numpy(got), f"{n_staged}")


@pytest.mark.parametrize("adaptive", [False, True])
def test_run_packed_on_card_matches_cpu(cuda, adaptive):
    kw = dict(chunk=16, seg_steps=64, keep_state=True, adaptive=adaptive)
    iss_stepper.reset_counts()
    gpu, sg = engine.run_packed(tp.skew_groups(engine), device=cuda, **kw)
    assert iss_stepper.iss_segment_banked.launches > 0
    assert iss_stepper.iss_refill.launches > 0
    assert iss_stepper.iss_segment_banked.plain_calls == 0
    cpu, sc = engine.run_packed(tp.skew_groups(engine), device="cpu", **kw)
    tp.assert_results_equal(cpu, gpu, "card vs cpu")
    assert (sg.lane_steps, sg.n_segments, sg.seg_schedule) == \
        (sc.lane_steps, sc.n_segments, sc.seg_schedule)
    assert sg.stepper == "cuda" and sc.stepper == "plain"


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_on_card_match_cpu(cuda, shards):
    """Logical shards on the one card: both kernels launch (the segment
    kernel once a segment for all the shards) and no plain version runs;
    per item, final state, schedule and shard statistics equal the CPU's
    at the same shard count, per item equal the one-shard run, and the
    host syncs are not multiplied by the shard count."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True, adaptive=True)
    iss_stepper.reset_counts()
    gpu, sg = engine.run_packed(tp.skew_groups(engine),
                                mesh=["cuda"] * shards, **kw)
    seg, ref, plain = _launches()
    assert seg == sg.n_segments + 1 and ref > 0 and plain == 0
    cpu, sc = engine.run_packed(tp.skew_groups(engine),
                                mesh=["cpu"] * shards, **kw)
    tp.assert_results_equal(cpu, gpu, "card vs cpu")
    for f in ("lane_steps", "n_segments", "seg_schedule", "host_syncs",
              "n_shards", "shard_retired", "shard_lane_steps"):
        assert getattr(sg, f) == getattr(sc, f), f
    one, s1 = engine.run_packed(tp.skew_groups(engine), device=cuda, **kw)
    tp.assert_results_equal(one, gpu, "shards vs one shard")
    assert sg.host_syncs - sg.n_segments == s1.host_syncs - s1.n_segments
    assert (sg.n_shards, sg.n_devices, sg.stepper) == (shards, 1, "cuda")


@pytest.mark.parametrize("stepper", ["branchless", "switch"])
def test_plain_steppers_on_card_match_cpu(cuda, stepper):
    """The reference's baseline steppers run as plain torch on the card
    (no segment kernel launch; the refill kernel still swaps): per item,
    final state and schedule equal the CPU's and the kernel route's."""
    kw = dict(chunk=16, seg_steps=64, keep_state=True)
    iss_stepper.reset_counts()
    gpu, sg = engine.run_packed(tp.skew_groups(engine), stepper=stepper,
                                device=cuda, **kw)
    seg, ref, plain = _launches()
    assert seg == 0 and ref > 0 and plain == 0 and sg.stepper == stepper
    cpu, sc = engine.run_packed(tp.skew_groups(engine), stepper=stepper,
                                device="cpu", **kw)
    kernel, _ = engine.run_packed(tp.skew_groups(engine), device=cuda, **kw)
    tp.assert_results_equal(cpu, gpu, "card vs cpu")
    tp.assert_results_equal(kernel, gpu, "vs the kernel route")
    for f in ("lane_steps", "n_segments", "seg_schedule", "host_syncs"):
        assert getattr(sg, f) == getattr(sc, f), f


def test_wrappers_check_their_tensors(cuda):
    bank, clen, mlen, _, st = tp.workload_pool(11)
    ps = convert.packed_to_torch(st, "cpu")
    with pytest.raises(ValueError, match="expected cuda"):
        iss_stepper.iss_segment_banked(_t(bank, cuda), _t(clen, cuda), ps,
                                       seg_steps=4, mem_len=_t(mlen, cuda),
                                       device=cuda)


# ------------------------------------------------------ the carbon sweep
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_sweep_kernel_matches_plain_streamed(cuda, dt):
    """Three tiles (12 cells x 8 draws x 3 candidates; +inf lifetimes,
    invalid cells, exact ties) through one set of accumulators."""
    dtype = np.float64 if dt == "f64" else np.float32
    cases = tp.stream_cases(np.random.default_rng(31), dtype)
    pcs.reset_counts()
    got = tp.port_stream(cases, dtype, cuda)
    torch.cuda.synchronize()
    assert (pcs.sweep_tile.launches, pcs.sweep_tile.plain_calls) == (3, 0)
    want = tp.port_stream(cases, dtype, cuda, fn=pcs.sweep_tile_plain)
    tp.assert_streams_equal(cases, want, got, dtype, dt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_sweep_drawn_kernel_matches_plain_streamed(cuda, dt):
    """Three drawn tiles (12 cells x 40 draws x 3-4 candidates, invalid
    cells) through one set of accumulators: the kernel's lifetimes within
    LIFE_ULPS of the plain draws, and every output equal to the plain
    tile's given the kernel's lifetimes."""
    dtype = np.float64 if dt == "f64" else np.float32
    cases = tp.drawn_stream_cases(np.random.default_rng(37), dtype,
                                  n_draws=40)
    pcs.reset_counts()
    outs, accs, lifes = tp.port_stream_drawn(cases, dtype, cuda)
    torch.cuda.synchronize()
    assert (pcs.sweep_tile_drawn.launches,
            pcs.sweep_tile_drawn.plain_calls) == (3, 0)
    _, _, plain_lifes = tp.port_stream_drawn(
        cases, dtype, cuda, fn=pcs.sweep_tile_drawn_plain)
    for a, b in zip(plain_lifes, lifes):
        assert tp.ulps(a, b).max() <= tp.LIFE_ULPS[dtype]
    fed = tp.with_lifetimes(cases, lifes)
    want = tp.port_stream(fed, dtype, cuda, fn=pcs.sweep_tile_plain)
    tp.assert_streams_equal(fed, want, (outs, accs), dtype, dt)


def test_sweep_drawn_kernel_skips_best_core(cuda):
    """With best_core=False the drawn kernel writes every other output
    as with it."""
    case = tp.drawn_tile_inputs(np.random.default_rng(3), 9, 300, 9,
                                np.float32)
    args = [_t(case[k], cuda) for k in tp.DRAWN_ORDER]
    kw = dict(tp.TILE_KW, n_draws=300, day_s=tp.DAY_S, device=cuda)
    fresh = lambda: pcs.init_acc(64, 32, torch.float32, cuda)  # noqa: E731
    a, acc_a = pcs.sweep_tile_drawn(case["key"], *args, fresh(), **kw)
    b, acc_b = pcs.sweep_tile_drawn(case["key"], *args, fresh(),
                                    best_core=False, **kw)
    assert b.best_core is None
    for f in a._fields:
        if f != "best_core":
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(acc_a, acc_b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n_cand", [64, 300])
def test_sweep_kernels_many_candidates_match_plain(cuda, dt, n_cand):
    """Candidate counts whose champion columns do not fit shared memory
    at 256 threads a cell (the kernel narrows its blocks, down to one
    warp at 300): both builds over three streamed tiles of 100 draws
    against their plain versions."""
    dtype = np.float64 if dt == "f64" else np.float32
    cases = tp.stream_cases(np.random.default_rng(41), dtype, n_cells=5,
                            n_draws=100, n_cand=n_cand)
    want = tp.port_stream(cases, dtype, cuda, fn=pcs.sweep_tile_plain)
    tp.assert_streams_equal(cases, want, tp.port_stream(cases, dtype, cuda),
                            dtype, f"(a) {dt} C {n_cand}")
    cases = tp.drawn_stream_cases(np.random.default_rng(43), dtype,
                                  n_cells=5, n_draws=100, n_cand=n_cand)
    outs, accs, lifes = tp.port_stream_drawn(cases, dtype, cuda)
    _, _, plain_lifes = tp.port_stream_drawn(
        cases, dtype, cuda, fn=pcs.sweep_tile_drawn_plain)
    for a, b in zip(plain_lifes, lifes):
        assert tp.ulps(a, b).max() <= tp.LIFE_ULPS[dtype]
    fed = tp.with_lifetimes(cases, lifes)
    want = tp.port_stream(fed, dtype, cuda, fn=pcs.sweep_tile_plain)
    tp.assert_streams_equal(fed, want, (outs, accs), dtype,
                            f"(b) {dt} C {n_cand}")


def test_sweep_kernel_refuses_too_many_candidates(cuda):
    """Past one warp's champion columns in shared memory the launch
    raises."""
    n = 1000
    case = tp.tile_inputs(np.random.default_rng(4), 2, 8, n, np.float64)
    args = [_t(case[k], cuda) for k in tp.TILE_ORDER]
    with pytest.raises(RuntimeError, match="carbon_sweep launch"):
        pcs.sweep_tile(*args, pcs.init_acc(64, 32, torch.float64, cuda),
                       device=cuda, **tp.TILE_KW)


def test_sweep_on_card_matches_cpu(cuda):
    """The reference test's mixture spec on the card and on the CPU: the
    card kernel's lifetimes (`life_out`) within the CPU tests' ulp bound
    of the CPU's, and the CPU sweep fed the card's lifetimes equal to
    the card's sweep."""
    spec = tp.sweep_mixture_spec()
    card, best, emb = tp.run_sweep_recorded(spec, tile_cells=48,
                                            device=cuda)
    assert card.path == "cuda" and card.hist.sum() == spec.n_scenarios
    life_card = tp.sweep_life_days(spec, np.float32, cuda, spec.n_cells)
    life_cpu = tp.sweep_life_days(spec, np.float32, "cpu", spec.n_cells)
    ulps = tp.ulps(life_card, life_cpu)
    assert ulps.max() <= tp.LIFE_ULPS[np.float32], ulps.max()
    cpu, _, _ = tp.run_sweep_recorded(spec, life_days=life_card,
                                      tile_cells=48, device="cpu")
    tp.assert_sweeps_equal(cpu, card, psweep.build_tables(spec), best, emb,
                           "card vs cpu")


def test_sweep_on_card_tile_sizes_bit_identical(cuda):
    spec = tp.sweep_mixture_spec()
    runs = [psweep.run_sweep(spec, tile_cells=t, device=cuda)
            for t in (3, 7, 48, spec.n_cells)]
    for other in runs[1:]:
        tp.assert_sweeps_identical(runs[0], other, "tile sizes")


def test_point_mass_f64_on_card_equals_oracles(cuda):
    spec, lifes = tp.sweep_point_spec()
    pcs.reset_counts()
    res = psweep.run_sweep(spec, tile_cells=5, dtype=np.float64,
                           device=cuda)
    assert pcs.sweep_tile_drawn.launches == -(-spec.n_cells // 5)
    assert pcs.sweep_tile.launches == 0
    tg = psel.total_grid(list(spec.cores), spec.profiles[0],
                         np.asarray(lifes), np.asarray(spec.execs_per_day))
    smap = psel.selection_map(spec.profiles[0], np.asarray(lifes),
                              np.asarray(spec.execs_per_day))
    sq = np.s_[:, :, 0, 0, 0, 0, 0]
    for f in ("p50", "min", "max"):
        np.testing.assert_array_equal(getattr(res, f)[sq], tg.min(axis=0), f)
    np.testing.assert_array_equal(res.best_core[sq], smap)


# ---------------------------------------------------------- LM kernels
# The LM kernels sum in another order than their plain versions, the
# bfloat16 flash kernel rounds P to bfloat16 for P v, and the bfloat16
# scan rounds W, S and B w for its products: float32 outputs within 1e-4
# (relative to the output's scale), bfloat16 outputs within one bfloat16
# step (2^-7 relative, 1e-2 here).
_LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rand(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _lm_close(got, want, dtype):
    tol = _LM_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(3, 11, 16, 11, 11), (2, 200, 112, 200, 200),
                                   (2, 200, 64, 50, 100),
                                   (2, 256, 128, 128, 64),
                                   # D 40 and 12 (12 zero-padded to 16):
                                   # rows narrower than the 64 build's box
                                   (2, 200, 40, 200, 200),
                                   (2, 200, 40, 50, 100),
                                   (2, 256, 12, 64, 64),
                                   # one ragged tile, Whisper's encoder's
                                   # shape cut to L 300
                                   (2, 300, 64, 300, 300)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal, shape):
    """Every bfloat16 forward is a `flash_fwd_wgmma` launch; float32 runs
    the CUDA-core kernel."""
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, tq, tk = shape
    g = torch.Generator(device=cuda).manual_seed(l + d)
    q, k, v = (_rand(g, (bh, l, d), dtype, cuda) for _ in range(3))
    pfa.reset_counts()
    got = pfa.flash_attention(q, k, v, causal=causal, tq=tq, tk=tk,
                              device=cuda)
    torch.cuda.synchronize()
    assert (pfa.flash_attention.launches,
            pfa.flash_attention.wgmma_launches) == (
                1, int(dtype == torch.bfloat16))
    want = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq, tk=tk)
    assert got.dtype == dtype and got.shape == q.shape
    _lm_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 22, 16, 8, 11, 1),
                                   (2, 4, 128, 32, 16, 64, 1),
                                   (2, 6, 300, 20, 40, 100, 3),
                                   (1, 8, 512, 64, 64, 256, 1),
                                   (1, 4, 512, 128, 128, 256, 1),
                                   (1, 2, 1024, 64, 64, 512, 1)])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, shape):
    """Small, ragged and odd head counts; P = N = 128 (the bfloat16
    kernel's two slices of P and two boxes of N); and a chunk of 512
    steps (eight row tiles, 36 tile pairs a chunk)."""
    _ssd_case(cuda, dtype, shape)


_LONG_CHUNK = (1, 1, 3072, 128, 128, 3072, 1)
# Mamba2-1.3B's prefill of 8 x 512 tokens: 64 heads of P 64 sharing one
# group's B and C of N 128, chunk 256
_MAMBA2_SHAPE = (8, 64, 512, 64, 128, 256, 1)


def test_ssd_scan_bf16_mamba2_shape(cuda):
    """The bfloat16 kernel at N 128 with 64 heads a group: its build of
    two 64-column boxes of N, the state in two m64 halves."""
    _ssd_case(cuda, torch.bfloat16, _MAMBA2_SHAPE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_flash_attention_d128_group5(cuda, dtype):
    """`ops.gqa_flash_attention` at D 128 with 5 query heads a KV head
    (Qwen2.5-14B's grouping; 10 heads here), one 512-row tile, against
    the plain version on the repeated heads."""
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops
    b, l, h, hkv, d = 2, 512, 10, 2, 128
    g = torch.Generator(device=cuda).manual_seed(128)
    q = _rand(g, (b, l, h, d), dtype, cuda)
    k, v = (_rand(g, (b, l, hkv, d), dtype, cuda) for _ in range(2))
    got = ops.gqa_flash_attention(q, k, v, causal=True, tq=l, tk=l,
                                  device=cuda)
    torch.cuda.synchronize()

    def flat(t):
        return t.repeat_interleave(h // t.shape[2], dim=2).transpose(
            1, 2).reshape(b * h, l, d)
    want = pfa.flash_attention_plain(flat(q), flat(k), flat(v), causal=True,
                                     tq=l, tk=l)
    assert got.dtype == dtype and got.shape == q.shape
    _lm_close(got.transpose(1, 2).reshape(b * h, l, d), want, dtype)


def test_ssd_scan_bf16_long_chunk(cuda):
    """A 3,072-step chunk at P = N = 128: the bfloat16 kernel walks 48
    row tiles and 1,176 tile pairs in one chunk, its cumsum and weights
    12 KB each in shared memory."""
    _ssd_case(cuda, torch.bfloat16, _LONG_CHUNK)


# (batch, heads, L, P, N, chunk, groups) of `ssd_fwd_wgmma`, the bfloat16
# forward: Zamba2-7B's P = N = 64 with 112 heads a group (one batch);
# Mamba2-1.3B's N 128; P = N = 128 (two 64-column slices of P, two boxes
# of N); P 13 and N 21, not multiples of 8 (zero-padded), three chunks
_SSD_WGMMA_CASES = [(1, 112, 512, 64, 64, 256, 1), _MAMBA2_SHAPE,
                    (1, 4, 512, 128, 128, 256, 1), (1, 3, 150, 13, 21, 50, 1)]


@pytest.mark.parametrize("shape", _SSD_WGMMA_CASES)
def test_ssd_wgmma_matches_plain_and_its_model(cuda, shape):
    """y, the final state and the states the backward reads against the
    plain version and against the rounding model
    (`_torch_ssd_wgmma.ssd_wgmma_emulation`); two launches give the same
    bits, each counted as an `ssd_fwd_wgmma` launch."""
    from _torch_ssd_wgmma import ssd_wgmma_emulation
    from repro_torch.kernels import ssd_scan as pss
    a, x, dt, b, c, q, rep = _ssd_inputs(cuda, torch.bfloat16, shape)
    pss.reset_counts()
    got = pss._forward(a, x, dt, b, c, q, rep, x.device, True)
    again = pss._forward(a, x, dt, b, c, q, rep, x.device, True)
    torch.cuda.synchronize()
    assert (pss.ssd_scan.launches, pss.ssd_scan.wgmma_launches) == (2, 2)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert got[0].shape == x.shape and got[2].shape == (
        x.shape[0], x.shape[1] // q - 1, b.shape[-1], x.shape[-1])
    want = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep,
                              return_states=True)
    model = ssd_wgmma_emulation(a, x, dt, b, c, q=q, rep=rep,
                                return_states=True)
    for u, v, w in zip(got, want, model):
        _lm_close(u, v, torch.bfloat16)
        _lm_close(u, w, torch.bfloat16)


def test_ssd_wgmma_counts_bfloat16_only_and_refuses_past_its_chunk(cuda):
    """A float32 forward runs the CUDA-core kernel and is not counted as
    `ssd_fwd_wgmma`; a bfloat16 chunk past what the kernel's shared memory
    holds (`fwd_wgmma_max_q`) raises ValueError before any launch."""
    from repro_torch.kernels import ssd_scan as pss
    pss.reset_counts()
    a, x, dt, b, c, q, rep = _ssd_inputs(cuda, torch.float32,
                                         (1, 2, 128, 32, 16, 64, 1))
    pss.ssd_scan(a, x, dt, b, c, q=q, rep=rep, device=cuda)
    pss.ssd_scan(a, x.bfloat16(), dt, b.bfloat16(), c.bfloat16(), q=q,
                 rep=rep, device=cuda)
    torch.cuda.synchronize()
    assert (pss.ssd_scan.launches, pss.ssd_scan.wgmma_launches) == (2, 1)
    long_q = pss.fwd_wgmma_max_q(128) + 64
    a, x, dt, b, c, q, rep = _ssd_inputs(cuda, torch.bfloat16,
                                         (1, 1, long_q, 64, 128, long_q, 1))
    with pytest.raises(ValueError, match="shared memory holds"):
        pss.ssd_scan(a, x, dt, b, c, q=q, rep=rep, device=cuda)
    assert pss.ssd_scan.launches == 2


def test_ssd_scan_f32_long_chunk_against_float64(cuda):
    """The float32 build at the same 3,072-step chunk, held with its plain
    version to the scan evaluated in float64. Both take the chunk's
    cumsum of dt A in float32: each entry is off by about u |cum| (u =
    2^-24, |cum| in the thousands here), and exp turns the difference of
    two entries into a relative error of each decay. Each float32 result
    is within 4 u max|cum| of the exact one, of its scale (2e-4 on the
    card: past 1e-4, so the two float32 results are more than 1e-4 apart
    here; ROADMAP queue 3)."""
    from repro_torch.kernels import ssd_scan as pss
    a, x, dt, b, c, q, rep = _ssd_inputs(cuda, torch.float32, _LONG_CHUNK)
    y, s = pss.ssd_scan(a, x, dt, b, c, q=q, rep=rep, device=cuda)
    torch.cuda.synchronize()
    yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep)
    # one chunk spans the sequence: every product in float64
    x64, dt64, b64, c64 = (t.double() for t in (x, dt, b, c))
    cum = torch.cumsum(dt64 * a.double()[:, None], -1)
    causal = torch.ones(q, q, dtype=torch.bool, device=cuda).tril()
    decay = torch.exp((cum[:, :, None] - cum[:, None, :])
                      .masked_fill(~causal, float("-inf")))
    y64 = ((c64 @ b64.transpose(1, 2)) * decay * dt64[:, None, :]) @ x64
    s64 = (b64 * (torch.exp(cum[:, -1:] - cum) * dt64)[:, :, None]
           ).transpose(1, 2) @ x64
    tol = max(_LM_TOL[torch.float32], 4 * 2.0 ** -24
              * float(cum.abs().max()))
    for what, got, want in (("kernel y", y, y64), ("kernel state", s, s64),
                            ("plain y", yp, y64), ("plain state", sp, s64)):
        err = float((got.double() - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), (what, err)


def _ssd_inputs(cuda, dtype, shape):
    """(a, x, dt, b, c, q, rep) for shape (batch, heads, L, P, N, chunk,
    groups), drawn on the card from a seed."""
    bt, h, l, p, n, q, groups = shape
    g = torch.Generator(device=cuda).manual_seed(l + p)
    x = _rand(g, (bt * h, l, p), dtype, cuda)
    dt = torch.nn.functional.softplus(_rand(g, (bt * h, l), torch.float32,
                                            cuda))
    a = -torch.exp(_rand(g, (bt * h,), torch.float32, cuda, 0.3))
    b = _rand(g, (bt * groups, l, n), dtype, cuda, 0.5)
    c = _rand(g, (bt * groups, l, n), dtype, cuda, 0.5)
    return a, x, dt, b, c, q, h // groups


def _ssd_case(cuda, dtype, shape):
    from repro_torch.kernels import ssd_scan as pss
    a, x, dt, b, c, q, rep = _ssd_inputs(cuda, dtype, shape)
    y, s = pss.ssd_scan(a, x, dt, b, c, q=q, rep=rep, device=cuda)
    torch.cuda.synchronize()
    yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep)
    _lm_close(y, yp, dtype)
    _lm_close(s, sp, torch.float32 if dtype == torch.float32
              else torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bitplane_kernel_matches_plain(cuda, dtype, bits):
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=cuda).manual_seed(bits)
    x = _rand(g, (256, 128), dtype, cuda)
    w = _rand(g, (128, 384), torch.float32, cuda, 0.1)
    planes, scales, _ = ref.quantize_weights(w, bits)
    got = pbp.bitplane_matmul(x, planes, scales, bits=bits, device=cuda)
    torch.cuda.synchronize()
    _lm_close(got, pbp.bitplane_matmul_plain(x, planes, scales, bits=bits),
              dtype)
    # ragged M through the op's padding
    xm = _rand(g, (3, 50, 128), dtype, cuda)
    _lm_close(ops.quantized_linear(xm, w, bits=bits, device=cuda),
              ref.bitplane_matmul_ref(xm.reshape(-1, 128), planes, scales,
                                      bits=bits).reshape(3, 50, 384), dtype)


@pytest.mark.parametrize("bits", range(1, 9))
def test_bitplane_repack_kernel_bit_for_bit(cuda, bits):
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import ref
    g = torch.Generator(device=cuda).manual_seed(bits)
    w = _rand(g, (640, 384), torch.float32, cuda, 0.1)
    planes, _, w_q = ref.quantize_weights(w, bits)
    got = pbp.bitplane_repack(planes, bits=bits, device=cuda)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (640, 384)
    assert torch.equal(got, pbp.bitplane_repack_plain(planes, bits=bits))
    assert torch.equal(got.to(torch.int32), w_q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bitplane_kernel_ragged_against_the_block_tile(cuda, dtype, bits):
    """M 384 (3 x 128 rows), K 640 (10 x 64) and N 384 (1.5 x the 256
    columns of the bfloat16 GEMM's block tile)."""
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import ref
    g = torch.Generator(device=cuda).manual_seed(10 + bits)
    x = _rand(g, (384, 640), dtype, cuda)
    w = _rand(g, (640, 384), torch.float32, cuda, 0.1)
    planes, scales, _ = ref.quantize_weights(w, bits)
    got = pbp.bitplane_matmul(x, planes, scales, bits=bits, device=cuda)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (384, 384)
    _lm_close(got, pbp.bitplane_matmul_plain(x, planes, scales, bits=bits),
              dtype)
    if dtype == torch.bfloat16:   # the two phases alone, the same kernels
        w_q = pbp.bitplane_repack(planes, bits=bits, device=cuda)
        assert torch.equal(pbp.bitplane_gemm(x, w_q, scales, device=cuda),
                           got)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2.5-14b", "minitron-8b",
                                  "mamba2-1.3b", "gemma3-12b"])
def test_dense_and_ssm_smoke_serve_on_card_match_cpu(cuda, arch):
    """The dense and Mamba2 smoke configs in float32 with the same
    parameters on the card (the kernels) and on the CPU (the plain
    versions): one flash_attention launch per dense layer, one ssd_scan
    per Mamba2 layer, no plain call on the card. Gemma3's 64-token prompt
    is longer than its local layers' window (16)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.models.model import build_model
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    pfa.reset_counts()
    pss.reset_counts()
    with torch.inference_mode():
        lc, cc = model.prefill_fn(card, {"tokens": toks.to(cuda)}, 70)
        dc, _ = model.decode_fn(card, cc, toks[:, :1].to(cuda), 64)
    on_card = (pfa.flash_attention.launches, pss.ssd_scan.launches,
               pfa.flash_attention.plain_calls, pss.ssd_scan.plain_calls)
    with torch.inference_mode():
        lp, cp = model.prefill_fn(cpu, {"tokens": toks}, 70)
        dp, _ = model.decode_fn(cpu, cp, toks[:, :1], 64)
    n = cfg.n_layers
    assert on_card == ((0, n) if cfg.family == "ssm" else (n, 0)) + (0, 0)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=1e-3)


def test_smoke_serve_on_card_matches_cpu(cuda):
    """The Zamba2 smoke config in float32 with the same parameters on the
    card (the kernels) and on the CPU (the plain versions)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.models.model import build_model
    cfg = get_smoke_config("zamba2-7b").replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = build_model(cfg).init_params(torch.Generator(
        device=cuda).manual_seed(0), cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    pfa.reset_counts()
    pss.reset_counts()
    with torch.inference_mode():
        lc, cc = model.prefill_fn(card, {"tokens": toks.to(cuda)}, 70)
        lp, cp = model.prefill_fn(cpu, {"tokens": toks}, 70)
        dc, _ = model.decode_fn(card, cc, toks[:, :1].to(cuda), 64)
        dp, _ = model.decode_fn(cpu, cp, toks[:, :1], 64)
    assert (pss.ssd_scan.launches, pfa.flash_attention.launches) == (
        cfg.n_layers, cfg.n_layers // cfg.shared_attn_period)
    torch.testing.assert_close(lc.cpu(), lp, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(dc.cpu(), dp, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("grid", ["example", "dense"])
def test_serving_plan_on_card_equals_plan_grid(cuda, grid):
    """The float64 serving planner on the card bit for bit against the
    numpy oracle: CUDA divides by a float64 tensor (never by a Python
    scalar, whose reciprocal ATen multiplies by), argmin takes the first
    of tied options, infeasible cells stay +inf."""
    from repro_torch.core import planner
    chip = planner.h100_sxm(1500.0, power_w=700.0)
    rng = np.random.default_rng(1)
    kw = dict(chip=chip, n_params=8e9, kv_bytes_per_token=32 * 8 * 128 * 4)
    if grid == "example":
        kw.update(lifetimes_days=np.array([7.0, 90.0, 3 * 365.0]),
                  qps_grid=np.logspace(2, 6, 9))
    else:
        kw.update(lifetimes_days=np.concatenate(
            [np.arange(1.0, 366.0), rng.uniform(0.1, 4000.0, 35)]),
            qps_grid=np.concatenate([np.logspace(0, 8, 397),
                                     [0.0, np.inf, np.nan]]),
            chips_options=(8, 16, 16, 64, 128, 256))
    want = planner.plan_grid(**kw)
    got = psweep.serving_plan(device=cuda, **kw)
    for k in ("variant_idx", "chips", "total_kg"):
        assert got[k].device.type == "cuda"
        g = got[k].cpu().numpy()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape
        assert g.tobytes() == want[k].tobytes(), k
    assert (want["variant_idx"] == -1).any() or grid == "example"


def test_spoilage_variant_through_the_kernel_equals_ref(cuda):
    """DT-Large on 512 held-out inputs through `iss_segment` on the card:
    every output equals the variant's reference function, and the state
    equals the plain version's on the card."""
    from repro_torch.flexibench import spoilage_algos as sa
    algo = {a.name: a for a in sa.all_algos()}["DT-Large"]
    x, _ = sa.gen_dataset(np.random.default_rng(99), 512)
    mems = tp.spoilage_memory(algo, x)
    code = _t(np.asarray(algo.program.code).view(np.int32), cuda)
    a = iss.fresh_lanes(_t(mems, cuda))
    b = iss.fresh_lanes(_t(mems, cuda))
    iss_stepper.reset_counts()
    for _ in range(4):
        a = iss_stepper.iss_segment(code, a, seg_steps=64,
                                    max_steps=algo.max_steps, device=cuda)
        b = iss.run_segment_lanes(code, b, 64, algo.max_steps)
    torch.cuda.synchronize()
    assert iss_stepper.iss_segment_banked.launches == 4
    assert bool(a.halted.all())
    for f, u, v in zip(iss.ISSState._fields, a, b):
        assert torch.equal(u, v), f
    np.testing.assert_array_equal(a.mem[:, algo.out_addr].cpu().numpy(),
                                  algo.ref(x))


# ------------------------------------------------------------- training

_BWD_SHAPES = [(3, 11, 16, 11, 11), (2, 200, 112, 200, 200),
               (2, 200, 64, 50, 100), (2, 200, 64, 100, 50),
               (2, 13, 5, 13, 13), (2, 200, 40, 50, 100),
               (1, 130, 128, 130, 130), (96, 512, 128, 512, 512),
               (16, 512, 12, 512, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, dtype, causal,
                                                  shape):
    """The forward's log-sum-exp and the backward kernel's dq, dk, dv
    against the plain versions on the same inputs: odd and ragged L and
    D, tq < tk and tq > tk (the forward's key bound), Qwen2-1.5B's
    training shape and its smoke config's (D 12) at L 512."""
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, tq, tk = shape
    g = torch.Generator(device=cuda).manual_seed(l + d + 7)
    q, k, v, do = (_rand(g, (bh, l, d), dtype, cuda) for _ in range(4))
    o, lse = pfa._forward(q, k, v, causal, tq, tk, 0, q.device, True)
    po, plse = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq,
                                         tk=tk, return_lse=True)
    _lm_close(o, po, dtype)
    _lm_close(lse, plse, torch.float32)
    pfa.reset_counts()
    got = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                  tq=tq, tk=tk, device=cuda)
    torch.cuda.synchronize()
    assert pfa.flash_attention.bwd_launches == 1
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=tq, tk=tk)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        _lm_close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(96, 512, 128, 512, 512),
                                   (2, 200, 40, 50, 100)])
def test_flash_attention_bwd_kernel_is_deterministic(cuda, dtype, shape):
    """Two launches on the same inputs give the same bits (no atomics):
    a resumed training run repeats its gradients."""
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, tq, tk = shape
    g = torch.Generator(device=cuda).manual_seed(l + d)
    q, k, v, do = (_rand(g, (bh, l, d), dtype, cuda) for _ in range(4))
    o, lse = pfa._forward(q, k, v, True, tq, tk, 0, q.device, True)
    a, b = (pfa.flash_attention_bwd(q, k, v, o, do, lse, tq=tq, tk=tk,
                                    device=cuda) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_attention_autograd_launches_both_kernels(cuda):
    """A loss through `ops.gqa_flash_attention` on the card: one forward
    and one backward launch, no plain call, the gradients equal to
    autograd through the plain forward on the CPU."""
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops
    b, l, h, hkv, d = 2, 128, 6, 2, 32
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn((b, l, n, d), generator=g) for n in (h, hkv, hkv)]
    do = torch.randn((b, l, h, d), generator=g)
    card = [x.to(cuda).requires_grad_() for x in xs]
    pfa.reset_counts()
    got = torch.autograd.grad(ops.gqa_flash_attention(
        *card, causal=True, tq=64, tk=64, device=cuda), card, do.to(cuda))
    torch.cuda.synchronize()
    assert (pfa.flash_attention.launches, pfa.flash_attention.bwd_launches,
            pfa.flash_attention.plain_calls,
            pfa.flash_attention.bwd_plain_calls) == (1, 1, 0, 0)
    cpu = [x.clone().requires_grad_() for x in xs]
    want = torch.autograd.grad(ops.gqa_flash_attention(
        *cpu, causal=True, tq=64, tk=64, device="cpu"), cpu, do)
    for a, w in zip(got, want):
        _lm_close(a.cpu(), w, torch.float32)


# (bh, L, D, tile, window): the wide builds (D 130 -> 192, D 200 and 256
# -> 256), without a window and with windows that are and are not
# multiples of 64 and of the tile, wider than the tile (window // tk > 0)
# and than L, ragged L; and windows on the narrow builds.
_WIDE_SHAPES = [(2, 512, 256, 128, 0), (2, 512, 256, 128, 128),
                (2, 512, 256, 128, 100), (1, 1024, 256, 512, 1000),
                (2, 384, 192, 64, 64), (2, 256, 256, 64, 1000),
                (3, 200, 256, 40, 50), (2, 200, 200, 100, 0),
                (2, 192, 130, 64, 70), (2, 512, 64, 128, 100),
                (2, 300, 16, 100, 37), (2, 256, 128, 32, 12)]


def _wide_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _WIDE_SHAPES, ids=_wide_id)
def test_flash_attention_wide_and_windowed_match_plain(cuda, dtype, shape):
    """The forward (output and log-sum-exp) and the backward at head dims
    past 128 and with a sliding window, against the plain versions on the
    same inputs; the bfloat16 kernels twice, for the same bits."""
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, t, w = shape
    g = torch.Generator(device=cuda).manual_seed(l + d + w)
    q, k, v, do = (_rand(g, (bh, l, d), dtype, cuda) for _ in range(4))
    pfa.reset_counts()
    o, lse = pfa._forward(q, k, v, True, t, t, w, q.device, True)
    grads = pfa.flash_attention_bwd(q, k, v, o, do, lse, tq=t, tk=t,
                                    window=w, device=cuda)
    torch.cuda.synchronize()
    assert (pfa.flash_attention.launches,
            pfa.flash_attention.wgmma_launches,
            pfa.flash_attention.bwd_launches) == (
                1, int(dtype == torch.bfloat16), 1)
    po, plse = pfa.flash_attention_plain(q, k, v, tq=t, tk=t, window=w,
                                         return_lse=True)
    _lm_close(o, po, dtype)
    _lm_close(lse, plse, torch.float32)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, tq=t, tk=t,
                                         window=w)
    for a, b in zip(grads, want):
        assert a.dtype == dtype and a.shape == q.shape
        _lm_close(a, b, dtype)
    if dtype == torch.bfloat16:
        o2, lse2 = pfa._forward(q, k, v, True, t, t, w, q.device, True)
        again = pfa.flash_attention_bwd(q, k, v, o, do, lse, tq=t, tk=t,
                                        window=w, device=cuda)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        for a, b in zip(grads, again):
            assert torch.equal(a, b)


def test_flash_attention_refuses_past_d256_and_bad_windows(cuda):
    """Head dims above 256, and a window with tq != tk or without the
    causal mask, raise ValueError on the card: no fallback."""
    from repro_torch.kernels import flash_attention as pfa
    x = torch.zeros((1, 64, 272), device=cuda)
    with pytest.raises(ValueError, match="head dim 272"):
        pfa.flash_attention(x, x, x, tq=64, tk=64, device=cuda)
    y = torch.zeros((1, 64, 16), device=cuda)
    with pytest.raises(ValueError, match="tq == tk"):
        pfa.flash_attention(y, y, y, tq=32, tk=64, window=8, device=cuda)
    with pytest.raises(ValueError, match="tq == tk"):
        pfa.flash_attention(y, y, y, causal=False, tq=64, tk=64, window=8,
                            device=cuda)


def test_bit_planes_refuse_a_backward_on_the_card(cuda):
    """No silent missing gradient: a backward through `bitplane_matmul`
    on the card raises NotImplementedError, and without a gradient it
    runs as before."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(5)
    w = _rand(g, (128, 128), torch.float32, cuda, 0.1).requires_grad_()
    xq = _rand(g, (4, 128), torch.float32, cuda).requires_grad_()
    out = ops.quantized_linear(xq, w, bits=8, device=cuda)
    with pytest.raises(NotImplementedError, match="bit planes"):
        out.sum().backward()
    with torch.no_grad():
        assert ops.quantized_linear(xq, w, bits=8,
                                    device=cuda).grad_fn is None


def test_scan_gradients_on_card_equal_cpu(cuda):
    """A loss through `ops.ssd` on the card (the forward kernel saving
    its states, then `ssd_scan_bwd`): one launch of each, no plain call,
    every gradient equal to the CPU's (`SSDScan`'s plain forward and
    backward) within 1e-4; and `.backward()` through the Mamba2 and
    Zamba2 smoke losses on the card raises nothing and reaches every
    parameter."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as pss
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4, 96, 16), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((2, 4, 96), generator=g))
    a = -torch.exp(torch.randn((4,), generator=g) * 0.3)
    bm, cm = (torch.randn((2, 2, 96, 8), generator=g) * 0.5
              for _ in range(2))
    dy = torch.randn((2, 4, 96, 16), generator=g)
    ds = torch.randn((2, 4, 8, 16), generator=g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).requires_grad_() for t in (x, dt, a, bm, cm)]
        pss.reset_counts()
        y, s = ops.ssd(*ins, q=32, return_state=True, device=dev)
        grads.append(torch.autograd.grad((y, s), ins,
                                         (dy.to(dev), ds.to(dev))))
        counts = (pss.ssd_scan.launches, pss.ssd_scan.bwd_launches,
                  pss.ssd_scan.plain_calls, pss.ssd_scan.bwd_plain_calls)
        assert counts == ((1, 1, 0, 0) if dev.type == "cuda"
                          else (0, 0, 1, 1))
    for got, want in zip(*grads):
        _lm_close(got.cpu(), want, torch.float32)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import build_model
    for arch in ("mamba2-1.3b", "zamba2-7b"):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init_params(torch.Generator(device=cuda).manual_seed(
            0), cuda, trainable=True)
        toks = torch.randint(0, cfg.vocab, (2, 65), device=cuda)
        loss, _ = model.loss_fn(params, {"tokens": toks[:, :-1],
                                         "targets": toks[:, 1:]})
        pss.reset_counts()
        loss.backward()
        torch.cuda.synchronize()
        assert pss.ssd_scan.bwd_launches > 0
        assert pss.ssd_scan.plain_calls == pss.ssd_scan.bwd_plain_calls == 0
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in params.parameters())


# (batch, heads, L, P, N, chunk, groups)
_BWD_SSD_SHAPES = [(1, 3, 22, 16, 8, 11, 1), (2, 6, 96, 11, 13, 32, 2),
                   (2, 4, 100, 16, 16, 25, 1), (1, 4, 128, 128, 128, 64, 2),
                   (1, 8, 512, 64, 128, 256, 1), (1, 2, 300, 64, 128, 150, 1),
                   (2, 4, 64, 16, 8, 64, 1)]


def _ssd_bwd_case(cuda, dtype, shape, with_ds=True):
    """(kernel gradients, plain gradients, inputs) on the forward kernel's
    own saved states."""
    from repro_torch.device import resolve
    from repro_torch.kernels import ssd_scan as pss
    a, x, dt, b, c, q, rep = _ssd_inputs(cuda, dtype, shape)
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = _rand(g, x.shape, dtype, cuda)
    ds = (_rand(g, (x.shape[0], b.shape[-1], x.shape[-1]), torch.float32,
                cuda) if with_ds else None)
    _, _, states = pss._forward(a, x, dt, b, c, q, rep, resolve(cuda), True)
    _, _, want_states = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep,
                                           return_states=True)
    if states.numel():
        _lm_close(states, want_states, torch.float32 if dtype == torch.float32
                  else torch.bfloat16)
    got = pss.ssd_scan_bwd(a, x, dt, b, c, dy, states, ds, q=q, rep=rep,
                           device=cuda)
    torch.cuda.synchronize()
    want = pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, ds, q=q,
                                  rep=rep)
    return got, want, (a, x, dt, b, c, dy, states, ds, q, rep)


@pytest.mark.parametrize("with_ds", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _BWD_SSD_SHAPES)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, dtype, shape, with_ds):
    """Ragged chunks and odd P, N; rep > 1; P = N = 128 (32-row tiles);
    Mamba2's N 128 at chunk 256; one chunk (no saved state). The kernel's
    float32 arithmetic against the plain version on the same saved
    states: dx, dB, dC in the input's dtype within its tolerance, ddt and
    da within the float32 one."""
    got, want, ins = _ssd_bwd_case(cuda, dtype, shape, with_ds)
    for name, gt, w, inp in zip(("da", "dx", "ddt", "db", "dc"), got, want,
                                ins[:5]):
        assert gt.dtype == inp.dtype and gt.shape == inp.shape, name
        _lm_close(gt, w, gt.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 512, 64, 128, 256, 1),
                                   (2, 112, 512, 64, 64, 256, 1)])
def test_ssd_scan_bwd_kernel_is_deterministic(cuda, dtype, shape):
    """No float atomics: two launches give the same bits, the groups'
    partial sums of dB and dC included (Mamba2-1.3B's training shape;
    Zamba2-7B's heads, 112 a group, at batch 2)."""
    from repro_torch.kernels import ssd_scan as pss
    got, want, (a, x, dt, b, c, dy, states, ds, q, rep) = _ssd_bwd_case(
        cuda, dtype, shape)
    for gt, w in zip(got, want):
        _lm_close(gt, w, gt.dtype)
    again = pss.ssd_scan_bwd(a, x, dt, b, c, dy, states, ds, q=q, rep=rep,
                             device=cuda)
    torch.cuda.synchronize()
    for u, v in zip(got, again):
        assert torch.equal(u, v)


def test_ssd_scan_bwd_bf16_kernel_matches_its_rounding_model(cuda):
    """The bfloat16 kernel (`ssd_bwd_wgmma`) against
    `_torch_ssd_bwd_wgmma.ssd_bwd_wgmma_emulation`, the rounding model the
    CPU tests hold to the plain version and to the reference, at its
    heads a block, on the same saved states: Mamba2-1.3B's training shape
    at batch 1 (64 heads a group: 32 blocks of 2, L 512, P 64, N 128,
    chunk 256); one `bwd_wgmma_launches` count a call."""
    from _torch_ssd_bwd_wgmma import ssd_bwd_wgmma_emulation
    from repro_torch.kernels import ssd_scan as pss
    pss.reset_counts()
    got, _, (a, x, dt, b, c, dy, states, ds, q, rep) = _ssd_bwd_case(
        cuda, torch.bfloat16, (1, 64, 512, 64, 128, 256, 1))
    assert (pss.ssd_scan.bwd_launches, pss.ssd_scan.bwd_wgmma_launches) == (
        1, 1)
    hb = pss.bwd_wgmma_heads(x.shape[2], b.shape[2], q, rep)
    want = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, ds, q, rep,
                                   hb)
    for gt, w in zip(got, want):
        assert gt.dtype == w.dtype and gt.shape == w.shape
        _lm_close(gt, w, gt.dtype)


_BWD_HEADS_SHAPES = [s for s in _BWD_SSD_SHAPES if s[3] <= 64] + [
    (1, 6, 64, 16, 16, 32, 1), (1, 11, 64, 8, 8, 64, 1)]


def _bf16_heads_a_block(cuda, shape, hb, monkeypatch):
    from _torch_ssd_bwd_wgmma import ssd_bwd_wgmma_emulation
    from repro_torch.kernels import ssd_scan as pss
    monkeypatch.setattr(pss, "bwd_wgmma_heads", lambda *args: hb)
    got, want, (a, x, dt, b, c, dy, states, ds, q, rep) = _ssd_bwd_case(
        cuda, torch.bfloat16, shape)
    model = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, ds, q, rep,
                                    min(hb, rep))
    for gt, w, m in zip(got, want, model):
        _lm_close(gt, w, gt.dtype)
        _lm_close(gt, m, gt.dtype)


@pytest.mark.parametrize("shape", _BWD_HEADS_SHAPES)
def test_ssd_scan_bwd_bf16_two_heads_a_block(cuda, shape, monkeypatch):
    """The bfloat16 kernel at two heads a block where the host would pick
    one (a group of one head, or a chunk past 768 steps at N 128): ragged
    P, N and chunks, one chunk, groups of 3 heads (blocks of 2 and 1:
    uneven heads a block), of 6 and of 11 (6 blocks, the last of one
    head); against the plain version and the rounding model at two heads
    a block."""
    _bf16_heads_a_block(cuda, shape, 2, monkeypatch)


@pytest.mark.parametrize("shape", _BWD_HEADS_SHAPES)
def test_ssd_scan_bwd_bf16_one_head_a_block(cuda, shape, monkeypatch):
    """The same at one head a block: the group of 11 runs 11 blocks, their
    partials summed in order by the second kernel."""
    _bf16_heads_a_block(cuda, shape, 1, monkeypatch)


def test_ssd_scan_bwd_bf16_long_chunk(cuda, monkeypatch):
    """Long chunks at P 64, N 128: 640 at two heads a block, every
    gradient held to the plain version; then past the two-head limit
    (768: the host switches to one head a block, chunk 832), and the
    refusal past the kernel's own (`bwd_wgmma_max_q`, 4,544), with no
    fallback. At 832, dx, ddt, dB and dC are held to the plain version,
    and da to the backward evaluated in float64 on the same saved
    states: there the plain version's own float32 da is up to 2e-4 of
    its largest value off the float64 one (its cumsum of dt A in
    float32, as the forward's long chunk; ROADMAP queue 3), so the
    kernel's da may be no farther from it than the plain version's,
    plus the float32 tolerance."""
    from repro_torch.kernels import ssd_scan as pss
    got, want, _ = _ssd_bwd_case(cuda, torch.bfloat16,
                                 (1, 2, 1280, 64, 128, 640, 1))
    assert pss.bwd_wgmma_heads(64, 128, 640, 2) == 2
    for gt, w in zip(got, want):
        _lm_close(gt, w, gt.dtype)
    shape = (1, 2, 1664, 64, 128, 832, 1)
    got, want, (a, x, dt, b, c, dy, states, ds, q, rep) = _ssd_bwd_case(
        cuda, torch.bfloat16, shape)
    assert pss.bwd_wgmma_heads(64, 128, 832, 2) == 1
    for gt, w in zip(got[1:], want[1:]):
        _lm_close(gt, w, gt.dtype)
    monkeypatch.setattr(pss, "F32", torch.float64)
    exact = pss.ssd_scan_bwd_plain(*(t.double() for t in (
        a, x, dt, b, c, dy, states, ds)), q=q, rep=rep)[0]
    scale = max(1.0, float(exact.abs().max()))
    plain_err = float((want[0].double() - exact).abs().max())
    err = float((got[0].double() - exact).abs().max())
    assert err <= plain_err + _LM_TOL[torch.float32] * scale, (err,
                                                                plain_err)
    monkeypatch.undo()
    q = pss.bwd_wgmma_max_q(128, 64) + 64
    a, x, dt, b, c, _, rep = _ssd_inputs(cuda, torch.bfloat16,
                                         (1, 2, q, 64, 128, q, 1))
    dy = torch.zeros_like(x)
    states = torch.zeros((2, 0, 128, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="holds 4544 steps"):
        pss.ssd_scan_bwd(a, x, dt, b, c, dy, states, q=q, rep=rep,
                         device=cuda)


_TRAIN_CASES = [(1, "qwen2-1.5b"), (2, "qwen2-1.5b"), (1, "mamba2-1.3b"),
                (2, "mamba2-1.3b"), (1, "zamba2-7b"), (2, "zamba2-7b"),
                (1, "gemma3-12b")]


@pytest.mark.parametrize(
    "grad_accum,arch", _TRAIN_CASES,
    ids=[str(ga) if arch == "qwen2-1.5b" else f"{arch}-{ga}"
         for ga, arch in _TRAIN_CASES])
def test_smoke_train_steps_on_card_match_cpu(cuda, grad_accum, arch):
    """Three `train_loop` steps of a smoke config in float32 on the card
    (the flash and scan kernels, forward and backward) and on the CPU
    (their plain versions) from the same parameters: losses and gnorms
    within 1e-4 relative; the parameters within 2 x the summed learning
    rates, the most a sign flip of Adam's normalised update can move them
    (a gradient at rounding level differs in sign between the two)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import build_model
    from repro_torch.optim import cosine_schedule
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    lr_kwargs = {"warmup": 1}
    opt_init, step_fn = psteps.make_train_step(model, grad_accum=grad_accum,
                                               lr_kwargs=lr_kwargs)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
    card = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                             cuda, trainable=True)
    with torch.no_grad():
        for a, b in zip(card.parameters(), cpu.parameters()):
            a.copy_(b)
    sc, sp = opt_init(card), opt_init(cpu)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    pfa.reset_counts()
    pss.reset_counts()
    for step in range(3):
        bt = host_batch(dcfg, step)
        card, sc, mc = step_fn(card, sc, to_device(bt, cuda), step)
        cpu, sp, mp = step_fn(cpu, sp, to_device(bt, torch.device("cpu")),
                              step)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(mc[k]), float(mp[k]),
                                       rtol=1e-4)
    # each kernel the family runs, forward and backward, on the card; the
    # plain versions' calls are the CPU's, one for one
    kernels = {"qwen2-1.5b": (pfa.flash_attention,),
               "gemma3-12b": (pfa.flash_attention,),
               "mamba2-1.3b": (pss.ssd_scan,),
               "zamba2-7b": (pfa.flash_attention, pss.ssd_scan)}[arch]
    for k in kernels:
        assert k.launches > 0 and k.bwd_launches > 0
        assert (k.plain_calls, k.bwd_plain_calls) == (k.launches,
                                                      k.bwd_launches)
    atol = 2 * sum(float(cosine_schedule(s, **lr_kwargs)) for s in range(3))
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=atol, msg=name)


# the Whisper encoder's attention: non-causal over 1,500 frames (one tile
# of every frame, or 500), which is no multiple of the kernels' 64-row
# blocks and 64-key tiles; its smoke config's D 12; a small ragged L
_RAGGED_SHAPES = [(24, 1500, 64, 1500), (8, 1500, 64, 500),
                  (6, 1500, 12, 1500), (4, 150, 64, 150), (4, 150, 12, 150),
                  (3, 77, 64, 77)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_ragged_non_causal_matches_plain(cuda, dtype,
                                                         shape):
    """The forward, its log-sum-exp and the backward without a causal
    mask at a ragged L, against the plain versions."""
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, t = shape
    g = torch.Generator(device=cuda).manual_seed(l + d + 3)
    q, k, v, do = (_rand(g, (bh, l, d), dtype, cuda) for _ in range(4))
    o, lse = pfa._forward(q, k, v, False, t, t, 0, q.device, True)
    po, plse = pfa.flash_attention_plain(q, k, v, causal=False, tq=t, tk=t,
                                         return_lse=True)
    _lm_close(o, po, dtype)
    _lm_close(lse, plse, torch.float32)
    got = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=False, tq=t,
                                  tk=t, device=cuda)
    torch.cuda.synchronize()
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=False,
                                         tq=t, tk=t)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == q.shape
        _lm_close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_d192_matches_plain(cuda, dtype):
    """The D 192 backward (MLA's q·k width, DeepSeek-V3's training) at a
    small shape, causal, tile 128, against the plain version."""
    from repro_torch.kernels import flash_attention as pfa
    g = torch.Generator(device=cuda).manual_seed(192)
    q, k, v, do = (_rand(g, (4, 256, 192), dtype, cuda) for _ in range(4))
    o, lse = pfa._forward(q, k, v, True, 128, 128, 0, q.device, True)
    _lm_close(o, pfa.flash_attention_plain(q, k, v, tq=128, tk=128), dtype)
    got = pfa.flash_attention_bwd(q, k, v, o, do, lse, tq=128, tk=128,
                                  device=cuda)
    torch.cuda.synchronize()
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, tq=128,
                                         tk=128)
    for a, b in zip(got, want):
        _lm_close(a, b, dtype)


def test_stacked_adafactor_step_on_card_matches_cpu(cuda):
    """One `make_train_step` step of DeepSeek-V3's smoke config with its
    Adafactor over the reference's stacked leaves, float32, on the card
    and the CPU from the same parameters: loss and gnorm within 1e-4
    relative, every parameter within 2 x the learning rate (the most a
    sign flip of a unit update moves it) and every state leaf within
    1e-3 relative."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import build_model
    from repro_torch.optim import cosine_schedule
    cfg = get_smoke_config("deepseek-v3-671b").replace(dtype="float32")
    assert cfg.optimizer == "adafactor"
    model = build_model(cfg)
    lr_kwargs = {"warmup": 1}
    opt_init, step_fn = psteps.make_train_step(model, lr_kwargs=lr_kwargs)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
    card = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                             cuda, trainable=True)
    with torch.no_grad():
        for a, b in zip(card.parameters(), cpu.parameters()):
            a.copy_(b)
    bt = host_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                               global_batch=4), 0)
    card, sc, mc = step_fn(card, opt_init(card), to_device(bt, cuda), 0)
    cpu, sp, mp = step_fn(cpu, opt_init(cpu),
                          to_device(bt, torch.device("cpu")), 0)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(mc[k]), float(mp[k]), rtol=1e-4)
    atol = 2 * float(cosine_schedule(0, **lr_kwargs))
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=atol, msg=name)
    got = convert.adafactor_state_to_numpy(sc)
    want = convert.adafactor_state_to_numpy(sp)
    assert int(got["step"]) == int(want["step"]) == 1

    def close(a, b):
        for k in b:
            if isinstance(b[k], dict):
                close(a[k], b[k])
            else:
                np.testing.assert_allclose(
                    a[k], b[k], rtol=1e-3,
                    atol=1e-6 * max(1.0, float(np.abs(b[k]).max())))
    close(got["vs"], want["vs"])


# (BH, L, D, tq, tk, causal, window) of `flash_fwd_wgmma`, the bfloat16
# forward: the CPU design tests' cases (D 192, 256 and 250, zero-padded
# to 256; causal with tq != tk; a window of 100 at tile 64; non-causal;
# ragged last 128-row blocks) and D 136 (padded to 136, read at the 192
# build's width); the narrow builds' (D 12, padded to 16 and read at the
# 64 build's width, 64, 112 and 128, causal and non-causal; one ragged
# non-causal tile of 300 like Whisper's encoder's; tq != tk both ways; a
# window)
_WGMMA_CASES = [(2, 256, 256, 64, 64, True, 0), (2, 256, 192, 128, 128, True, 0),
                (3, 320, 250, 64, 64, True, 0), (2, 256, 192, 64, 128, True, 0),
                (2, 256, 256, 128, 64, True, 0), (2, 320, 256, 64, 64, True, 100),
                (2, 256, 192, 64, 64, True, 100), (2, 320, 250, 64, 64, True, 100),
                (2, 200, 256, 200, 200, False, 0), (4, 128, 192, 64, 64, False, 0),
                (3, 320, 136, 64, 64, True, 0), (2, 200, 136, 100, 100, False, 0),
                (2, 256, 12, 64, 64, True, 0), (2, 200, 12, 100, 100, False, 0),
                (2, 320, 64, 64, 64, True, 0), (2, 256, 64, 128, 128, False, 0),
                (2, 256, 112, 128, 128, True, 0), (2, 200, 112, 200, 200, False, 0),
                (2, 384, 128, 128, 128, True, 0), (3, 256, 128, 64, 64, False, 0),
                (2, 300, 64, 300, 300, False, 0), (2, 200, 64, 50, 100, True, 0),
                (2, 200, 64, 100, 50, True, 0), (2, 320, 128, 64, 64, True, 100),
                (2, 256, 64, 64, 64, True, 100)]


@pytest.mark.parametrize("case", _WGMMA_CASES, ids=_wide_id)
def test_flash_wgmma_kernel_matches_plain_and_its_model(cuda, case):
    """The forward's output and log-sum-exp against the plain version and
    the output against its rounding model (`_torch_flash_wgmma`); two
    launches the same bits, each counted as a `flash_fwd_wgmma` launch;
    the backward kernel, given that log-sum-exp, within the bfloat16
    tolerance of the plain backward."""
    from _torch_flash_wgmma import flash_wgmma_emulation
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, tq, tk, causal, w = case
    g = torch.Generator(device=cuda).manual_seed(l + d + w + tq)
    q, k, v, do = (_rand(g, (bh, l, d), torch.bfloat16, cuda)
                   for _ in range(4))
    pfa.reset_counts()
    o, lse = pfa._forward(q, k, v, causal, tq, tk, w, q.device, True)
    o2, lse2 = pfa._forward(q, k, v, causal, tq, tk, w, q.device, True)
    torch.cuda.synchronize()
    assert (pfa.flash_attention.launches,
            pfa.flash_attention.wgmma_launches) == (2, 2)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    po, plse = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq,
                                         tk=tk, window=w, return_lse=True)
    _lm_close(o, po, torch.bfloat16)
    _lm_close(lse, plse, torch.float32)
    _lm_close(o, flash_wgmma_emulation(q, k, v, causal=causal, tq=tq, tk=tk,
                                       window=w), torch.bfloat16)
    got = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, tq=tq,
                                  tk=tk, window=w, device=cuda)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=tq, tk=tk, window=w)
    for a, b in zip(got, want):
        _lm_close(a, b, torch.bfloat16)


def test_flash_wgmma_takes_a_misaligned_q(cuda):
    """A q whose data is not 16-byte aligned (a view one value into its
    storage) reaches the kernel through `wgmma_operand`'s copy; the
    float32 kernel never counts as `flash_fwd_wgmma`, the narrow
    bfloat16 build does."""
    from repro_torch.kernels import flash_attention as pfa
    g = torch.Generator(device=cuda).manual_seed(5)
    flat = _rand(g, (2 * 128 * 200 + 1,), torch.bfloat16, cuda)
    q = flat[1:].view(2, 128, 200)
    k, v = (_rand(g, (2, 128, 200), torch.bfloat16, cuda) for _ in range(2))
    assert q.data_ptr() % 16
    pfa.reset_counts()
    got = pfa.flash_attention(q, k, v, tq=64, tk=64, device=cuda)
    _lm_close(got, pfa.flash_attention_plain(q, k, v, tq=64, tk=64),
              torch.bfloat16)
    pfa.flash_attention(q.float(), k.float(), v.float(), tq=64, tk=64,
                        device=cuda)
    pfa.flash_attention(q[..., :128].contiguous(), k[..., :128].contiguous(),
                        v[..., :128].contiguous(), tq=64, tk=64, device=cuda)
    torch.cuda.synchronize()
    assert (pfa.flash_attention.launches,
            pfa.flash_attention.wgmma_launches) == (3, 2)


# (BH, L, D, tq, tk, causal, window) of the bfloat16 backward
# (`flash_bwd_dq_wgmma` then `flash_bwd_dkdv_wgmma`): the CPU design
# tests' cases (D 256, 192 and the padded 250 and 136; causal with tq !=
# tk both ways; a window of 100 at tile 64; non-causal; ragged L 200 and
# 320, and L 13, less than one 64-row tile; the narrow builds' D 128,
# 112, 64, 40, 12 and 5, tq != tk both ways, a non-causal single tile of
# a ragged L 300, a window at D 128)
_BWD_WGMMA_CASES = [(2, 256, 256, 64, 64, True, 0),
                    (2, 256, 192, 128, 128, True, 0),
                    (3, 320, 250, 64, 64, True, 0),
                    (2, 256, 192, 64, 128, True, 0),
                    (2, 256, 256, 128, 64, True, 0),
                    (2, 320, 256, 64, 64, True, 100),
                    (2, 256, 192, 64, 64, True, 100),
                    (1, 320, 136, 64, 64, True, 100),
                    (2, 200, 256, 200, 200, False, 0),
                    (3, 128, 136, 64, 64, False, 0),
                    (2, 200, 192, 40, 40, True, 0),
                    (2, 13, 200, 13, 13, True, 0),
                    (2, 256, 128, 128, 128, True, 0),
                    (2, 200, 112, 200, 200, True, 0),
                    (2, 320, 64, 64, 64, True, 0),
                    (2, 200, 40, 50, 100, True, 0),
                    (2, 200, 12, 100, 50, True, 0),
                    (2, 300, 64, 300, 300, False, 0),
                    (2, 320, 128, 64, 64, True, 100),
                    (2, 13, 5, 13, 13, True, 0)]

@pytest.mark.parametrize("case", _BWD_WGMMA_CASES, ids=_wide_id)
def test_flash_bwd_wgmma_matches_plain_and_its_model(cuda, case):
    """The backward, given the forward kernel's output and
    log-sum-exp: every gradient within the bfloat16 tolerance of the
    plain backward and of its rounding model (`_torch_flash_wgmma`); two
    launches the same bits, each counted as a wgmma backward launch, no
    plain call."""
    from _torch_flash_wgmma import flash_bwd_wgmma_emulation
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, tq, tk, causal, w = case
    g = torch.Generator(device=cuda).manual_seed(l + d + w + tq + 31)
    q, k, v, do = (_rand(g, (bh, l, d), torch.bfloat16, cuda)
                   for _ in range(4))
    o, lse = pfa._forward(q, k, v, causal, tq, tk, w, q.device, True)
    pfa.reset_counts()
    got, again = (pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                          tq=tq, tk=tk, window=w, device=cuda)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert (pfa.flash_attention.bwd_launches,
            pfa.flash_attention.bwd_wgmma_launches,
            pfa.flash_attention.bwd_plain_calls) == (2, 2, 0)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=tq, tk=tk, window=w)
    model = flash_bwd_wgmma_emulation(q, k, v, o, do, lse, causal=causal,
                                      tq=tq, tk=tk, window=w)
    for a, b, p, m in zip(got, again, want, model):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        assert torch.equal(a, b)
        _lm_close(a, p, torch.bfloat16)
        _lm_close(a, m, torch.bfloat16)


@pytest.mark.parametrize("d", [256, 200, 128, 64])
def test_flash_backward_through_autograd_reaches_the_wgmma_pair(cuda, d):
    """`.backward()` through `flash_attention` at D 256 (and 200, padded
    to 200 and read at the 256 build's width), 128 and 64 (the narrow
    builds): one wgmma forward and one wgmma backward launch, no plain
    call, the gradients within the bfloat16 tolerance of the plain
    backward."""
    from repro_torch.kernels import flash_attention as pfa
    g = torch.Generator(device=cuda).manual_seed(d)
    x = [_rand(g, (2, 256, d), torch.bfloat16, cuda).requires_grad_()
         for _ in range(3)]
    do = _rand(g, (2, 256, d), torch.bfloat16, cuda)
    pfa.reset_counts()
    out = pfa.flash_attention(*x, tq=64, tk=64, device=cuda)
    out.backward(do)
    torch.cuda.synchronize()
    assert (pfa.flash_attention.launches, pfa.flash_attention.wgmma_launches,
            pfa.flash_attention.bwd_launches,
            pfa.flash_attention.bwd_wgmma_launches,
            pfa.flash_attention.plain_calls,
            pfa.flash_attention.bwd_plain_calls) == (1, 1, 1, 1, 0, 0)
    q, k, v = (t.detach() for t in x)
    o, lse = pfa._forward(q, k, v, True, 64, 64, 0, q.device, True)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, tq=64, tk=64)
    for t, w in zip(x, want):
        _lm_close(t.grad, w, torch.bfloat16)
