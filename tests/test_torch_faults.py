"""FlexiFault in the port (`repro_torch.flexibits.faults` and the plain
faulty stepper) against the reference's `repro.flexibits.faults`: the
lane keys, `mix32`, `FaultSpec`, the post-commit transform in every mode
and over every subset of targets, `arch_digest`, `measure_rates`, and
faulty banked segments over the full lane state against the reference's
Pallas kernel (interpret mode) and its PyISS `FaultOracle`, all bit for
bit."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.flexibits import faults as rf
from repro.kernels import iss_stepper as rks
from repro_torch import convert
from repro_torch.flexibench.base import all_workloads
from repro_torch.flexibits import faults as pf
from repro_torch.flexibits import iss, pyiss
from repro_torch.kernels import iss_stepper

_TARGET_SETS = [t for k in (1, 2, 3)
                for t in itertools.combinations(("regs", "mem", "pc"), k)]


def _i32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


@pytest.mark.parametrize("seed", [0, 5, 12345])
def test_lane_keys_match_reference(seed):
    want = rf.lane_keys(seed, 4096)
    got = pf.lane_keys(seed, 4096)
    assert got.dtype == np.uint32 and not got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pf.lane_keys_tensor(seed, 4096).numpy().view(np.uint32), want)


def test_mix32_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = (0, 1, 0x7FFFFFFF, 0xFFFFFFFF)
    want = np.asarray(rf.mix32(jnp.asarray(x)))
    np.testing.assert_array_equal(pf.mix32(_i32(x)).numpy().view(np.uint32),
                                  want)
    for v, w in zip(x[:64], want[:64]):
        assert pf.mix32_py(int(v)) == rf.mix32_py(int(v)) == int(w)


def test_fault_spec_matches_reference():
    from repro_torch.flexibits.cycles import CORES
    for kw in (dict(rate=0.0), dict(rate=1e-5, seed=3),
               dict(rate=0.3, targets=("pc", "regs")), dict(rate=1.0),
               dict(rate=0.5, mode="stuck"), dict(rate=2**-33, mode="dead")):
        r, p = rf.FaultSpec(**kw), pf.FaultSpec(**kw)
        assert (r.threshold, r.always, r.off, r.targets) == \
            (p.threshold, p.always, p.off, p.targets)
        for core in ("SERV", "QERV", "HERV"):
            assert p.for_core(CORES[core]).rate == \
                r.for_core(CORES[core]).rate
        assert convert.fault_spec_from(r) == p
        assert hash(p) == hash(pf.FaultSpec(**kw))
    for bad in (dict(rate=0.1, mode="flaky"), dict(rate=0.1, targets=()),
                dict(rate=0.1, targets=("cache",)), dict(rate=1.5)):
        with pytest.raises(ValueError):
            rf.FaultSpec(**bad)
        with pytest.raises(ValueError):
            pf.FaultSpec(**bad)


def _tile(rng, n=257, m=40):
    return dict(
        key=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        epoch=rng.integers(0, 2**31, n).astype(np.int32),
        regs=rng.integers(-2**31, 2**31, (n, 16)).astype(np.int32),
        pc=rng.integers(-2**31, 2**31, n).astype(np.int32),
        mem=rng.integers(-2**31, 2**31, (n, m)).astype(np.int32),
        n_instr=rng.integers(0, 2**31, n).astype(np.int32),
        gate=rng.random(n) < 0.8,
        mem_len=rng.integers(1, m + 1, n).astype(np.int32))


_APPLY_CASES = ([("transient", r, t) for r in (0.3, 1.0)
                 for t in _TARGET_SETS]
                + [(m, r, ("regs",)) for m in ("stuck", "dead")
                   for r in (0.5, 1.0)])


@pytest.mark.parametrize("mode,rate,targets", _APPLY_CASES)
def test_apply_fault_arrays_matches_reference(mode, rate, targets):
    """Random lane tiles (keys, epochs, post-commit counters, a gate and
    per-lane memory bounds): every output word equal, under a drawn
    threshold and under `always`."""
    rng = np.random.default_rng(_APPLY_CASES.index((mode, rate, targets)))
    t = _tile(rng)
    kw = dict(rate=rate, seed=0, targets=targets, mode=mode)
    want = rf.apply_fault_arrays(
        rf.FaultSpec(**kw), jnp.asarray(t["key"]), jnp.asarray(t["epoch"]),
        jnp.asarray(t["regs"]), jnp.asarray(t["pc"]), jnp.asarray(t["mem"]),
        jnp.asarray(t["n_instr"]), jnp.asarray(t["gate"]),
        mem_len=jnp.asarray(t["mem_len"]))
    got = pf.apply_fault_arrays(
        pf.FaultSpec(**kw), _i32(t["key"]), _i32(t["epoch"]),
        _i32(t["regs"]), _i32(t["pc"]), _i32(t["mem"]), _i32(t["n_instr"]),
        torch.from_numpy(t["gate"]), mem_len=_i32(t["mem_len"]))
    changed = False
    for name, a, b, orig in zip(("regs", "pc", "mem"), want, got,
                                (t["regs"], t["pc"], t["mem"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
        changed |= not np.array_equal(orig, b.numpy())
    assert changed, "the schedule never fired: the test proved nothing"
    # without a per-lane bound the memory draw spans the full width
    if "mem" in targets:
        w2 = rf.apply_fault_arrays(
            rf.FaultSpec(**kw), jnp.asarray(t["key"]),
            jnp.asarray(t["epoch"]), jnp.asarray(t["regs"]),
            jnp.asarray(t["pc"]), jnp.asarray(t["mem"]),
            jnp.asarray(t["n_instr"]), jnp.asarray(t["gate"]))
        g2 = pf.apply_fault_arrays(
            pf.FaultSpec(**kw), _i32(t["key"]), _i32(t["epoch"]),
            _i32(t["regs"]), _i32(t["pc"]), _i32(t["mem"]),
            _i32(t["n_instr"]), torch.from_numpy(t["gate"]))
        np.testing.assert_array_equal(np.asarray(w2[2]), g2[2].numpy())


def test_off_schedule_passes_through():
    t = _tile(np.random.default_rng(2))
    args = [_i32(t[k]) for k in ("key", "epoch", "regs", "pc", "mem",
                                 "n_instr")] + [torch.from_numpy(t["gate"])]
    for spec in (None, pf.FaultSpec(rate=0.0), pf.FaultSpec(rate=1e-12)):
        out = pf.apply_fault_arrays(spec, *args)
        assert all(a is b for a, b in zip(out, args[2:5]))


def test_arch_digest_matches_reference():
    rng = np.random.default_rng(3)
    t = _tile(rng, n=300, m=97)
    halted = rng.random(300) < 0.5
    want = rf.arch_digest(jnp.asarray(t["regs"]), jnp.asarray(t["pc"]),
                          jnp.asarray(t["mem"]), jnp.asarray(halted),
                          jnp.asarray(t["n_instr"]))
    got = pf.arch_digest(_i32(t["regs"]), _i32(t["pc"]), _i32(t["mem"]),
                         torch.from_numpy(halted), _i32(t["n_instr"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


# ------------------------------------------------ faulty banked segments
_SEG_SPECS = {
    "transient": dict(rate=0.05, seed=3, targets=("regs", "mem", "pc")),
    "stuck": dict(rate=0.5, seed=1, mode="stuck"),
    "dead": dict(rate=0.5, seed=2, mode="dead"),
}


def _plain_faulty(bank, clen, state, seg_steps, mem_len, cost, spec, keys,
                  epoch):
    t = torch.from_numpy
    out = iss.run_segment_lanes_banked(
        t(bank), t(clen), convert.packed_to_torch(state, "cpu"), seg_steps,
        None, t(mem_len), None if cost is None else t(cost),
        faults=spec, lane_key=_i32(keys), epoch=_i32(epoch))
    return convert.packed_to_numpy(out)


def _oracle(code, mem_words, mem, spec, key, epoch, steps, cost=None):
    p = pyiss.PyISS(code, mem_words, init_mem=mem[:mem_words], cost=cost)
    o = pf.FaultOracle(spec, int(key), int(epoch))
    p.post_commit = o
    p.run(steps)
    return p, o


def _assert_lane_equals_oracle(st, i, p, mem_words, timing, ctx):
    ln = st.lanes
    np.testing.assert_array_equal(ln.regs[i], np.array(p.regs, np.int64)
                                  .astype(np.int32), err_msg=f"{ctx} regs")
    assert int(ln.pc[i]) == np.int64(p.pc).astype(np.int32), ctx
    np.testing.assert_array_equal(ln.mem[i, :mem_words],
                                  p.mem.astype(np.int32), err_msg=ctx)
    assert (int(ln.n_instr[i]), bool(ln.halted[i])) == \
        (p.n_instr, p.halted), ctx
    if timing:
        assert int(ln.n_cycles[i]) == p.n_cycles, ctx


@pytest.mark.parametrize("timing", [False, True])
@pytest.mark.parametrize("mode", sorted(_SEG_SPECS))
def test_faulty_segments_match_reference_on_soups(mode, timing):
    """Random programs on random lanes with mixed per-program memory
    bounds, nonzero epochs: two 64-step segments, full state bit for bit
    against the reference's Pallas kernel under the same schedule."""
    rng = np.random.default_rng(7 + timing + 10 * len(mode))
    n_progs, mem_words, n = 5, 48, 32
    bank, clen = tp.soup_bank(rng, n_progs, 24, mem_words)
    mlen = rng.integers(8, mem_words + 1, n_progs).astype(np.int32)
    cost = tp.soup_cost(rng, n_progs) if timing else None
    st = tp.soup_state(rng, n, mem_words, n_progs)
    rspec = rf.FaultSpec(**_SEG_SPECS[mode])
    spec = convert.fault_spec_from(rspec)
    keys = rf.lane_keys(rspec.seed, n)
    epoch = rng.integers(0, 9, n).astype(np.int32)
    ref = got = st
    clean = st
    for k in range(2):
        ref = tp.ref_segment("pallas", bank, clen, ref, 64, mlen, cost,
                             faults=rspec, lane_key=keys, epoch=epoch)
        got = _plain_faulty(bank, clen, got, 64, mlen, cost, spec, keys,
                            epoch)
        tp.assert_packed_equal(ref, got, f"{mode} segment {k}")
        clean = tp.ref_segment("pallas", bank, clen, clean, 64, mlen, cost)
    assert not np.array_equal(clean.lanes.regs, got.lanes.regs)


@pytest.mark.parametrize("timing", [False, True])
def test_faulty_segments_match_reference_and_oracle_on_workloads(timing):
    """All 11 FlexiBench workloads in one pool under a transient schedule
    over regs, mem and pc: two 256-step segments equal the reference's
    Pallas kernel, and every lane equals the PyISS FaultOracle run for
    as many steps."""
    bank, clen, mlen, cost, st = tp.workload_pool(22, seed=5)
    cost = cost if timing else None
    rspec = rf.FaultSpec(rate=0.004, seed=9, targets=("regs", "mem", "pc"))
    spec = convert.fault_spec_from(rspec)
    keys = rf.lane_keys(rspec.seed, 22)
    epoch = np.arange(22, dtype=np.int32) % 3
    ref = got = st
    for k in range(2):
        ref = tp.ref_segment("pallas", bank, clen, ref, 256, mlen, cost,
                             faults=rspec, lane_key=keys, epoch=epoch)
        got = _plain_faulty(bank, clen, got, 256, mlen, cost, spec, keys,
                            epoch)
        tp.assert_packed_equal(ref, got, f"workload segment {k}")
    ws = all_workloads()
    fired = 0
    for i in range(22):
        w = ws[st.prog_id[i]]
        p, o = _oracle(w.program.code, w.total_mem_words, st.lanes.mem[i],
                       spec, keys[i], epoch[i], int(got.lanes.n_instr[i]),
                       None if cost is None else cost[st.prog_id[i]])
        fired += o.fired
        _assert_lane_equals_oracle(got, i, p, w.total_mem_words, timing,
                                   f"lane {i} ({w.key})")
    assert fired > 0


def test_iss_segment_wrapper_matches_reference():
    """The one-program wrapper (a 1-row bank, uniform budget, pool-wide
    memory bounds) under a transient schedule, against the reference's
    `iss_segment` (Pallas, interpret mode) and the oracle."""
    prog = tp.skew_program()
    mems = np.tile(prog.initial_memory(32), (8, 1))
    mems[:, 0] = np.random.default_rng(0).integers(5, 60, size=8)
    code = np.asarray(prog.code, np.uint32).view(np.int32)
    rspec = rf.FaultSpec(rate=0.05, seed=3, targets=("regs", "mem", "pc"))
    spec = convert.fault_spec_from(rspec)
    keys = rf.lane_keys(rspec.seed, 8)
    from repro.flexibits import iss as riss
    import jax
    rstate = jax.vmap(riss.init_state)(jnp.asarray(mems))
    want = rks.iss_segment(jnp.asarray(code), rstate, seg_steps=400,
                           max_steps=400, faults=rspec,
                           lane_key=jnp.asarray(keys),
                           epoch=jnp.zeros(8, jnp.int32))
    iss_stepper.reset_counts()
    got = iss_stepper.iss_segment(
        torch.from_numpy(code), iss.fresh_lanes(torch.from_numpy(mems)),
        seg_steps=400, max_steps=400, faults=spec, lane_key=_i32(keys),
        epoch=torch.zeros(8, dtype=torch.int32), device="cpu")
    assert iss_stepper.iss_segment_banked.plain_calls == 1
    for f in iss.ISSState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    for i in range(8):
        p, _ = _oracle(prog.code, 32, mems[i], spec, keys[i], 0, 400)
        ps = iss.PackedState(convert.state_to_numpy(got), None, None)
        _assert_lane_equals_oracle(ps, i, p, 32, False, f"lane {i}")


def test_rate_zero_segment_is_the_fault_free_segment():
    bank, clen, mlen, cost, st = tp.workload_pool(11, seed=1)
    keys = pf.lane_keys(0, 11)
    clean = tp.ref_segment("xla", bank, clen, st, 200, mlen, cost)
    got = _plain_faulty(bank, clen, st, 200, mlen, cost,
                        pf.FaultSpec(rate=0.0), keys,
                        np.zeros(11, np.int32))
    tp.assert_packed_equal(clean, got, "rate 0")


def test_measure_rates_matches_reference():
    prog = tp.skew_program()
    mems = np.tile(prog.initial_memory(32), (8, 1))
    mems[:, 0] = np.random.default_rng(2).integers(5, 60, size=8)
    for kw in (dict(rate=0.05, seed=3, targets=("regs", "mem", "pc")),
               dict(rate=0.5, seed=1, mode="stuck"), dict(rate=0.0)):
        want = rf.measure_rates(prog.code, mems, max_steps=400,
                                spec=rf.FaultSpec(**kw))
        got = pf.measure_rates(prog.code, mems, max_steps=400,
                               spec=pf.FaultSpec(**kw))
        assert (got.n_trials, got.exposed, got.masked, got.derated,
                got.sdc, got.live_regs) == \
            (want.n_trials, want.exposed, want.masked, want.derated,
             want.sdc, want.live_regs), kw
        assert (got.sdc_rate, got.derate_rate, got.avf) == \
            (want.sdc_rate, want.derate_rate, want.avf)
