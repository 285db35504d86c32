"""The segment kernel's per-lane arithmetic, built for the host.

`repro_torch/kernels/csrc/rv32e_step.cuh` holds the decode/execute/
commit of one lane for the CUDA segment kernel; it compiles as plain C++
when `__CUDACC__` is undefined. This test compiles a small C shim over it
with g++ (a lane loop around the header's `run_lane`, the same body the
kernel runs per thread), loads it with ctypes, and holds it bit-exact
against the reference's segment steppers over the full lane state. The
host build is test-only: nothing in `repro_torch` calls it.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import _torch_parity as tp
from repro_torch import convert
from repro_torch.flexibits import iss
from repro_torch.flexibits.iss import ISSState, PackedState

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "src"
        / "repro_torch" / "kernels" / "csrc")

SHIM = r"""
#include "rv32e_step.cuh"

extern "C" void run_segment_host(
    const int32_t* bank, int n_progs, int bank_width,
    const int32_t* code_len, const int32_t* mem_len, const int32_t* cost,
    int timing, const int32_t* prog_id, const int32_t* max_steps,
    int32_t* regs, int32_t* pc, int32_t* mem, int mem_words,
    uint8_t* halted, int32_t* n_instr, int32_t* n_two, int32_t* mix,
    int32_t* n_cycles, int n_lanes, int seg_steps) {
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
    prog.cost = timing ? cost + p * rv32e::N_COST : nullptr;
    if (timing)
      rv32e::run_lane<true>(s, prog, max_steps[lane], seg_steps);
    else
      rv32e::run_lane<false>(s, prog, max_steps[lane], seg_steps);
    pc[lane] = s.pc;
    halted[lane] = s.halted ? 1 : 0;
    n_instr[lane] = s.n_instr;
    n_two[lane] = s.n_two;
    n_cycles[lane] = s.n_cycles;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "rv32e_step.cuh cannot be compiled here")
    d = tmp_path_factory.mktemp("rv32e_host")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "librv32e_host.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                           "-I", str(CSRC), "-o", str(so),
                           str(d / "shim.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_segment_host.argtypes = [P, I, I, P, P, P, I, P, P, P, P, P, I,
                                     P, P, P, P, P, I, I]
    lib.run_segment_host.restype = None
    return lib


def host_segment(lib, bank, clen, state: PackedState, seg_steps, mem_len,
                 cost=None) -> PackedState:
    """One segment through the host build (numpy in, numpy out)."""
    c = np.ascontiguousarray
    bank, clen, mem_len = c(bank, np.int32), c(clen, np.int32), \
        c(mem_len, np.int32)
    cost_a = c(np.zeros((len(clen), 19), np.int32) if cost is None
               else cost, np.int32)
    ln = state.lanes
    out = ISSState(*(c(np.array(x, copy=True)) for x in ln))
    halted = out.halted.astype(np.uint8)
    pid, ms = c(state.prog_id, np.int32), c(state.max_steps, np.int32)
    ptr = lambda a: a.ctypes.data  # noqa: E731
    lib.run_segment_host(
        ptr(bank), bank.shape[0], bank.shape[1], ptr(clen), ptr(mem_len),
        ptr(cost_a), int(cost is not None), ptr(pid), ptr(ms),
        ptr(out.regs), ptr(out.pc), ptr(out.mem), out.mem.shape[1],
        ptr(halted), ptr(out.n_instr), ptr(out.n_two_stage), ptr(out.mix),
        ptr(out.n_cycles), out.pc.shape[0], seg_steps)
    return PackedState(lanes=out._replace(halted=halted.astype(bool)),
                       prog_id=pid, max_steps=ms)


@pytest.mark.parametrize("timing", [False, True])
def test_host_step_matches_reference_on_soups(host_lib, timing):
    """Random RV32E programs (odd f3/f7 fields and a few non-RV32E
    opcodes included) on random lanes with mixed per-program memory
    bounds: three segments of 64 steps, full state bit-exact with the
    reference's Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(101 + timing)
    n_progs, mem_words = 5, 48
    bank, clen = tp.soup_bank(rng, n_progs, 24, mem_words)
    mlen = rng.integers(8, mem_words + 1, n_progs).astype(np.int32)
    cost = tp.soup_cost(rng, n_progs) if timing else None
    st = tp.soup_state(rng, 32, mem_words, n_progs)
    ref = st
    for k in range(3):
        ref = tp.ref_segment("pallas", bank, clen, ref, 64, mlen, cost)
        st = host_segment(host_lib, bank, clen, st, 64, mlen, cost)
        tp.assert_packed_equal(ref, st, f"soup segment {k}")


@pytest.mark.parametrize("timing", [False, True])
def test_host_step_matches_reference_on_workloads(host_lib, timing):
    """All 11 FlexiBench workloads in one pool (mixed memory bounds,
    dynamic cost rows of three cores): the host build runs to completion
    and matches the reference's XLA stepper after every segment."""
    bank, clen, mlen, cost, st = tp.workload_pool(22, seed=3)
    cost = cost if timing else None
    ref = st
    for k in range(3):
        ref = tp.ref_segment("xla", bank, clen, ref, 256, mlen, cost)
        st = host_segment(host_lib, bank, clen, st, 256, mlen, cost)
        tp.assert_packed_equal(ref, st, f"workload segment {k}")
    # and to the end: every lane halts with the reference's final state
    ref = tp.ref_segment("xla", bank, clen, ref, 70_000, mlen, cost)
    st = host_segment(host_lib, bank, clen, st, 70_000, mlen, cost)
    assert st.lanes.halted.all()
    tp.assert_packed_equal(ref, st, "workloads to completion")


def plain_segment(bank, clen, state, seg_steps, mem_len, cost=None):
    """The port's plain stepper on the CPU, numpy in and out."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    out = iss.run_segment_lanes_banked(
        t(bank), t(clen), convert.packed_to_torch(state, "cpu"), seg_steps,
        None, t(mem_len), None if cost is None else t(cost))
    return convert.packed_to_numpy(out)


@pytest.mark.parametrize("timing", [False, True])
def test_host_step_matches_reference_on_edge_soups(host_lib, timing):
    """Random and edge programs with mixed mem_len (loads and stores at
    mem_len - 1, at mem_len and at negative word indices), halted and
    over-budget lanes: two 64-step segments equal the reference's Pallas kernel (interpret mode) and the port's
    plain stepper over the full state."""
    rng = np.random.default_rng(31 + timing)
    bank, clen, mlen, st = tp.edge_soup(rng, 48, 48)
    cost = tp.soup_cost(rng, len(clen)) if timing else None
    ref = plain = got = st
    for k in range(2):
        ref = tp.ref_segment("pallas", bank, clen, ref, 64, mlen, cost)
        plain = plain_segment(bank, clen, plain, 64, mlen, cost)
        got = host_segment(host_lib, bank, clen, got, 64, mlen, cost)
        tp.assert_packed_equal(ref, got, f"edge segment {k} vs reference")
        tp.assert_packed_equal(plain, got, f"edge segment {k} vs plain")


def test_host_step_workloads_with_parked_lanes_match_reference(host_lib):
    """The 11 FlexiBench workloads (mem_len 64 to 2,824 words) with
    halted and over-budget lanes mixed in: two segments equal the
    reference's Pallas kernel and the plain stepper, and the parked lanes
    are left as they were."""
    bank, clen, mlen, cost, st = tp.parked_workload_pool(33, seed=8)
    parked = st.lanes.halted | (st.lanes.n_instr >= st.max_steps)
    assert 0 < parked.sum() < 33
    ref = plain = got = st
    for k in range(2):
        ref = tp.ref_segment("pallas", bank, clen, ref, 96, mlen, cost)
        plain = plain_segment(bank, clen, plain, 96, mlen, cost)
        got = host_segment(host_lib, bank, clen, got, 96, mlen, cost)
        tp.assert_packed_equal(ref, got, f"workload segment {k} vs ref")
        tp.assert_packed_equal(plain, got, f"workload segment {k} vs plain")
    np.testing.assert_array_equal(got.lanes.n_instr[parked],
                                  st.lanes.n_instr[parked])
    np.testing.assert_array_equal(got.lanes.mem[parked],
                                  st.lanes.mem[parked])
