"""The segment kernel's fault transform, built for the host.

`repro_torch/kernels/csrc/flexifault.cuh` holds the per-lane FlexiFault
transform that the CUDA segment kernel's `faults` variant applies after
every commit (through `rv32e_step.cuh`'s `run_lane<TIMING, FAULT>`); it
compiles as plain C++ when `__CUDACC__` is undefined. This test compiles
a small C shim over both headers with g++ (the transform over a lane
tile, and a lane loop around `run_lane`, the body the kernel runs per
thread), loads it with ctypes, and holds it bit for bit against the
reference's `faults.apply_fault_arrays`, its Pallas segment kernel
(interpret mode) and its PyISS `FaultOracle`. The host build is
test-only: nothing in `repro_torch` calls it.
"""
import ctypes
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as tp
from repro.flexibits import faults as rf
from repro_torch.flexibench.base import all_workloads
from repro_torch.flexibits import faults as pf
from repro_torch.flexibits import pyiss
from repro_torch.flexibits.iss import ISSState, PackedState

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "src"
        / "repro_torch" / "kernels" / "csrc")

SHIM = r"""
#include "flexifault.cuh"
#include "rv32e_step.cuh"

namespace {
template <int M>
void apply_lanes(const flexifault::Spec& fs, const uint32_t* key,
                 const int32_t* epoch, int32_t* regs, int32_t* pc,
                 int32_t* mem, int mem_words, const int32_t* mem_len,
                 const int32_t* n_instr, const uint8_t* gate, int n) {
  for (int l = 0; l < n; ++l) {
    if (!gate[l]) continue;
    const flexifault::LaneConsts c =
        flexifault::lane_consts<M>(fs, key[l], epoch[l]);
    flexifault::apply<M>(fs, c, regs + l * 16, 1,
                         mem + static_cast<size_t>(l) * mem_words,
                         mem_len[l], pc[l], n_instr[l]);
  }
}

template <bool T, int M>
void run_lanes(const flexifault::Spec& fs, const uint32_t* key,
               const int32_t* epoch, const int32_t* bank, int n_progs,
               int bank_width, const int32_t* code_len,
               const int32_t* mem_len, const int32_t* cost,
               const int32_t* prog_id, const int32_t* max_steps,
               int32_t* regs, int32_t* pc, int32_t* mem, int mem_words,
               uint8_t* halted, int32_t* n_instr, int32_t* n_two,
               int32_t* mix, int32_t* n_cycles, int n_lanes,
               int seg_steps) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    rv32e::Lane s;
    s.regs = regs + lane * 16;
    s.regs_stride = 1;
    s.mix = mix + lane * rv32e::N_MIX;
    s.mix_stride = 1;
    s.pc = pc[lane];
    s.halted = halted[lane] != 0;
    s.n_instr = n_instr[lane];
    s.n_two = n_two[lane];
    s.n_cycles = n_cycles[lane];
    const int32_t p = rv32e::clampi(prog_id[lane], 0, n_progs - 1);
    rv32e::Program prog;
    prog.code = bank + p * bank_width;
    prog.clen = code_len[p];
    prog.mem = mem + static_cast<size_t>(lane) * mem_words;
    prog.mlen = mem_len[p];
    prog.cost = T ? cost + p * rv32e::N_COST : nullptr;
    const flexifault::LaneConsts c =
        flexifault::lane_consts<M>(fs, key[lane], epoch[lane]);
    rv32e::run_lane<T, M>(s, prog, max_steps[lane], seg_steps, fs, c);
    pc[lane] = s.pc;
    halted[lane] = s.halted ? 1 : 0;
    n_instr[lane] = s.n_instr;
    n_two[lane] = s.n_two;
    n_cycles[lane] = s.n_cycles;
  }
}
}  // namespace

#define SPEC \
  flexifault::Spec fs{threshold, always, n_targets, {t0, t1, t2}}

extern "C" void apply_tile(int mode, uint32_t threshold, int always,
                           int n_targets, int t0, int t1, int t2,
                           const uint32_t* key, const int32_t* epoch,
                           int32_t* regs, int32_t* pc, int32_t* mem,
                           int mem_words, const int32_t* mem_len,
                           const int32_t* n_instr, const uint8_t* gate,
                           int n) {
  SPEC;
  if (mode == flexifault::TRANSIENT)
    apply_lanes<flexifault::TRANSIENT>(fs, key, epoch, regs, pc, mem,
                                       mem_words, mem_len, n_instr, gate, n);
  if (mode == flexifault::STUCK)
    apply_lanes<flexifault::STUCK>(fs, key, epoch, regs, pc, mem,
                                   mem_words, mem_len, n_instr, gate, n);
  if (mode == flexifault::DEAD)
    apply_lanes<flexifault::DEAD>(fs, key, epoch, regs, pc, mem,
                                  mem_words, mem_len, n_instr, gate, n);
}

extern "C" void run_segment_host(
    int mode, uint32_t threshold, int always, int n_targets, int t0, int t1,
    int t2, const uint32_t* key, const int32_t* epoch, const int32_t* bank,
    int n_progs, int bank_width, const int32_t* code_len,
    const int32_t* mem_len, const int32_t* cost, int timing,
    const int32_t* prog_id, const int32_t* max_steps, int32_t* regs,
    int32_t* pc, int32_t* mem, int mem_words, uint8_t* halted,
    int32_t* n_instr, int32_t* n_two, int32_t* mix, int32_t* n_cycles,
    int n_lanes, int seg_steps) {
  SPEC;
#define RUN(T, M)                                                           \
  run_lanes<T, M>(fs, key, epoch, bank, n_progs, bank_width, code_len,      \
                  mem_len, cost, prog_id, max_steps, regs, pc, mem,         \
                  mem_words, halted, n_instr, n_two, mix, n_cycles, n_lanes, \
                  seg_steps)
  if (mode == flexifault::TRANSIENT) {
    if (timing) RUN(true, flexifault::TRANSIENT);
    else RUN(false, flexifault::TRANSIENT);
  } else if (mode == flexifault::STUCK) {
    if (timing) RUN(true, flexifault::STUCK);
    else RUN(false, flexifault::STUCK);
  } else {
    if (timing) RUN(true, flexifault::DEAD);
    else RUN(false, flexifault::DEAD);
  }
}
"""

_MODES = {"transient": 1, "stuck": 2, "dead": 3}
_TARGETS = {"regs": 0, "mem": 1, "pc": 2}
P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_SPEC_ARGS = [I, U, I, I, I, I, I, P, P]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "flexifault.cuh cannot be compiled here")
    d = tmp_path_factory.mktemp("flexifault_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libflexifault_host.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                           "-I", str(CSRC), "-o", str(so),
                           str(d / "shim.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.apply_tile.argtypes = _SPEC_ARGS + [P, P, P, I, P, P, P, I]
    lib.apply_tile.restype = None
    lib.run_segment_host.argtypes = _SPEC_ARGS + [
        P, I, I, P, P, P, I, P, P, P, P, P, I, P, P, P, P, P, I, I]
    lib.run_segment_host.restype = None
    return lib


def _spec_args(spec, keys, epoch):
    tg = [_TARGETS[t] for t in spec.targets] + [0, 0]
    keys = np.ascontiguousarray(keys, np.uint32)
    epoch = np.ascontiguousarray(epoch, np.int32)
    return (_MODES[spec.mode], spec.threshold, int(spec.always),
            len(spec.targets), *tg[:3], keys.ctypes.data,
            epoch.ctypes.data), (keys, epoch)


_HOST_CASES = ([("transient", r, t) for r in (0.3, 1.0)
                for t in (("regs",), ("mem",), ("pc",),
                          ("regs", "mem", "pc"))]
               + [(m, r, ("regs",)) for m in ("stuck", "dead")
                  for r in (0.5, 1.0)])


@pytest.mark.parametrize("mode,rate,targets", _HOST_CASES)
def test_host_transform_matches_reference(host_lib, mode, rate, targets):
    """The header's transform over a random lane tile (the gate, per-lane
    memory bounds, drawn epochs and counters) equals the reference's
    `apply_fault_arrays` in every word."""
    rng = np.random.default_rng(100 + _HOST_CASES.index(
        (mode, rate, targets)))
    n, m = 301, 37
    key = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    epoch = rng.integers(0, 2**31, n).astype(np.int32)
    regs = rng.integers(-2**31, 2**31, (n, 16)).astype(np.int32)
    pc = rng.integers(-2**31, 2**31, n).astype(np.int32)
    mem = rng.integers(-2**31, 2**31, (n, m)).astype(np.int32)
    n_instr = rng.integers(0, 2**31, n).astype(np.int32)
    gate = rng.random(n) < 0.8
    mlen = rng.integers(1, m + 1, n).astype(np.int32)
    rspec = rf.FaultSpec(rate=rate, targets=targets, mode=mode)
    # read the reference's result before the host build writes the
    # arrays in place (JAX may share a numpy buffer and compute later)
    want = [np.asarray(x) for x in rf.apply_fault_arrays(
        rspec, jnp.asarray(key), jnp.asarray(epoch), jnp.asarray(regs),
        jnp.asarray(pc), jnp.asarray(mem), jnp.asarray(n_instr),
        jnp.asarray(gate), mem_len=jnp.asarray(mlen))]
    regs, pc, mem = regs.copy(), pc.copy(), mem.copy()
    args, keep = _spec_args(pf.FaultSpec(rate=rate, targets=targets,
                                         mode=mode), key, epoch)
    g8 = gate.astype(np.uint8)
    host_lib.apply_tile(*args, regs.ctypes.data, pc.ctypes.data,
                        mem.ctypes.data, m, mlen.ctypes.data,
                        n_instr.ctypes.data, g8.ctypes.data, n)
    for name, a, b in zip(("regs", "pc", "mem"), want, (regs, pc, mem)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def host_segment(lib, spec, keys, epoch, bank, clen, state: PackedState,
                 seg_steps, mem_len, cost=None) -> PackedState:
    """One faulty segment through the host build (numpy in, numpy out)."""
    c = np.ascontiguousarray
    bank, clen, mem_len = c(bank, np.int32), c(clen, np.int32), \
        c(mem_len, np.int32)
    cost_a = c(np.zeros((len(clen), 19), np.int32) if cost is None
               else cost, np.int32)
    out = ISSState(*(c(np.array(x, copy=True)) for x in state.lanes))
    halted = out.halted.astype(np.uint8)
    pid, ms = c(state.prog_id, np.int32), c(state.max_steps, np.int32)
    args, keep = _spec_args(spec, keys, epoch)
    ptr = lambda a: a.ctypes.data  # noqa: E731
    lib.run_segment_host(
        *args, ptr(bank), bank.shape[0], bank.shape[1], ptr(clen),
        ptr(mem_len), ptr(cost_a), int(cost is not None), ptr(pid),
        ptr(ms), ptr(out.regs), ptr(out.pc), ptr(out.mem),
        out.mem.shape[1], ptr(halted), ptr(out.n_instr),
        ptr(out.n_two_stage), ptr(out.mix), ptr(out.n_cycles),
        out.pc.shape[0], seg_steps)
    return PackedState(lanes=out._replace(halted=halted.astype(bool)),
                       prog_id=pid, max_steps=ms)


_SOUP_SPECS = {
    "transient": dict(rate=0.05, seed=3, targets=("regs", "mem", "pc")),
    "stuck": dict(rate=0.5, seed=1, mode="stuck"),
    "dead": dict(rate=0.5, seed=2, mode="dead"),
}


@pytest.mark.parametrize("mode", sorted(_SOUP_SPECS))
def test_host_faulty_segments_match_reference_on_soups(host_lib, mode):
    """Random programs on random lanes, timing on, nonzero epochs: two
    64-step segments of the host build equal the reference's Pallas
    kernel under the same schedule."""
    rng = np.random.default_rng(211 + len(mode))
    n_progs, mem_words, n = 5, 48, 32
    bank, clen = tp.soup_bank(rng, n_progs, 24, mem_words)
    mlen = rng.integers(8, mem_words + 1, n_progs).astype(np.int32)
    cost = tp.soup_cost(rng, n_progs)
    st = tp.soup_state(rng, n, mem_words, n_progs)
    rspec = rf.FaultSpec(**_SOUP_SPECS[mode])
    keys = rf.lane_keys(rspec.seed, n)
    epoch = rng.integers(0, 9, n).astype(np.int32)
    ref = got = st
    for k in range(2):
        ref = tp.ref_segment("pallas", bank, clen, ref, 64, mlen, cost,
                             faults=rspec, lane_key=keys, epoch=epoch)
        got = host_segment(host_lib, pf.FaultSpec(**_SOUP_SPECS[mode]),
                           keys, epoch, bank, clen, got, 64, mlen, cost)
        tp.assert_packed_equal(ref, got, f"{mode} segment {k}")


def test_host_mem_transients_on_edge_soups_match_reference(host_lib):
    """Transients on memory only at a high rate (the transform's word is
    drawn modulo mem_len, so inside [0, mem_len)), on programs that load
    and store at mem_len - 1, at mem_len and at negative word indices,
    timing on, nonzero epochs: two segments equal the reference's Pallas
    kernel under the same schedule, and memory changed."""
    rng = np.random.default_rng(77)
    bank, clen, mlen, st = tp.edge_soup(rng, 40, 48)
    cost = tp.soup_cost(rng, len(clen))
    kw = dict(rate=0.2, seed=9, targets=("mem",))
    rspec = rf.FaultSpec(**kw)
    keys = rf.lane_keys(rspec.seed, 40)
    epoch = rng.integers(0, 9, 40).astype(np.int32)
    ref = got = st
    for k in range(2):
        ref = tp.ref_segment("pallas", bank, clen, ref, 64, mlen, cost,
                             faults=rspec, lane_key=keys, epoch=epoch)
        got = host_segment(host_lib, pf.FaultSpec(**kw), keys, epoch, bank,
                           clen, got, 64, mlen, cost)
        tp.assert_packed_equal(ref, got, f"mem transients segment {k}")
    assert not np.array_equal(got.lanes.mem, st.lanes.mem)


@pytest.mark.parametrize("timing", [False, True])
def test_host_faulty_workloads_match_oracle_to_completion(host_lib, timing):
    """All 11 FlexiBench workloads under a transient schedule over regs,
    mem and pc: the host build runs every lane to its end (halt or
    budget) in 4,096-step segments and each lane equals the PyISS
    FaultOracle's run, tick tally included. Budgets are capped at 60,000
    steps (above every fault-free run): a corrupted loop may never halt."""
    bank, clen, mlen, cost, st = tp.workload_pool(22, seed=6)
    st = st._replace(max_steps=np.minimum(st.max_steps, 60_000))
    cost = cost if timing else None
    spec = pf.FaultSpec(rate=2e-4, seed=11, targets=("regs", "mem", "pc"))
    keys = pf.lane_keys(spec.seed, 22)
    epoch = np.arange(22, dtype=np.int32) % 4
    got = st
    while True:
        live = ~got.lanes.halted & (got.lanes.n_instr < got.max_steps)
        if not live.any():
            break
        got = host_segment(host_lib, spec, keys, epoch, bank, clen, got,
                           4096, mlen, cost)
    ws = all_workloads()
    fired = 0
    for i in range(22):
        w = ws[st.prog_id[i]]
        mw = w.total_mem_words
        p = pyiss.PyISS(w.program.code, mw, init_mem=st.lanes.mem[i][:mw],
                        cost=None if cost is None else cost[st.prog_id[i]])
        o = pf.FaultOracle(spec, int(keys[i]), int(epoch[i]))
        p.post_commit = o
        p.run(int(st.max_steps[i]))
        fired += o.fired
        ln = got.lanes
        ctx = f"lane {i} ({w.key})"
        np.testing.assert_array_equal(
            ln.regs[i], np.array(p.regs, np.int64).astype(np.int32),
            err_msg=ctx)
        np.testing.assert_array_equal(ln.mem[i, :mw], p.mem.astype(np.int32),
                                      err_msg=ctx)
        assert (int(ln.pc[i]), int(ln.n_instr[i]), bool(ln.halted[i])) == \
            (int(np.int64(p.pc).astype(np.int32)), p.n_instr, p.halted), ctx
        if timing:
            assert int(ln.n_cycles[i]) == p.n_cycles, ctx
    assert fired > 0
