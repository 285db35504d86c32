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
                                   # D 40: zero-padded to 48 for the MMAs
                                   (2, 200, 40, 200, 200),
                                   (2, 200, 40, 50, 100)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal, shape):
    from repro_torch.kernels import flash_attention as pfa
    bh, l, d, tq, tk = shape
    g = torch.Generator(device=cuda).manual_seed(l + d)
    q, k, v = (_rand(g, (bh, l, d), dtype, cuda) for _ in range(3))
    got = pfa.flash_attention(q, k, v, causal=causal, tq=tq, tk=tk,
                              device=cuda)
    torch.cuda.synchronize()
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
    kernel's wide build); and a chunk past one C B^T strip (one head a
    block, several strips a row block)."""
    _ssd_case(cuda, dtype, shape)


_LONG_CHUNK = (1, 1, 3072, 128, 128, 3072, 1)


def test_ssd_scan_bf16_long_chunk(cuda):
    """A 3,072-step chunk at P = N = 128: the bfloat16 kernel's C B^T
    strips of one row block span twelve passes."""
    _ssd_case(cuda, torch.bfloat16, _LONG_CHUNK)


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
