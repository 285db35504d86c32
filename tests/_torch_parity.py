"""Shared inputs and comparisons for the port's parity tests.

Everything here is numpy plus the port's own copies of the ISA and the
FlexiBench workloads, so the card's tests (which run where JAX is not
installed) can use it too. The reference is reached only inside the
`ref_*` functions, which import it on call.

States are `PackedState`s of numpy arrays in the reference's layout;
`repro_torch.convert` carries them onto the port's tensors and back.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.flexibench.base import all_workloads
from repro_torch.flexibits import isa
from repro_torch.flexibits.cycles import CORES, MIX_CLASSES, cost_row
from repro_torch.flexibits.iss import ISSState, PackedState, pack_programs

N_MIX = len(MIX_CLASSES)
_OPCODES = (isa.OP_LUI, isa.OP_AUIPC, isa.OP_JAL, isa.OP_JALR,
            isa.OP_BRANCH, isa.OP_LOAD, isa.OP_STORE, isa.OP_IMM,
            isa.OP_REG, isa.OP_SYSTEM)
_MEM_OPS = ("lb", "lh", "lw", "lbu", "lhu", "sb", "sh", "sw")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain path steps small tensors, where torch's intra-op
    threads cost more than they give (and the suite runs in parallel
    worker processes): one thread while a module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_word(rng, mem_words: int) -> int:
    """One instruction word: mostly an encoded RV32E instruction with
    random fields, sometimes a word whose opcode is RV32E but whose other
    bits are random (odd f3/f7: never-taken branches, clipped load and
    store widths), rarely an opcode outside RV32E."""
    r = rng.random()
    if r < 0.3:
        op = int(rng.choice(_OPCODES[:-1]))   # no SYSTEM: halt rarely
        return op | int(rng.integers(0, 1 << 25)) << 7
    if r < 0.33:
        op = int(rng.integers(0, 128))
        while op in _OPCODES:
            op = int(rng.integers(0, 128))
        return op | int(rng.integers(0, 1 << 25)) << 7
    name = str(rng.choice(isa.ALL_OPS))
    while name in ("ecall", "ebreak") and rng.random() < 0.8:
        name = str(rng.choice(isa.ALL_OPS))   # halt rarely: longer runs
    rd, rs1, rs2 = (int(x) for x in rng.integers(0, 16, 3))
    imm = int(rng.integers(-2048, 2048))
    if name in isa.SHIFT_OPS:
        imm = int(rng.integers(0, 32))
    elif name in isa.B_OPS or name == "jal":
        imm = int(rng.integers(-16, 16)) * 4
    elif name in ("lui", "auipc"):
        imm = int(rng.integers(0, 1 << 20))
    elif name in _MEM_OPS:
        imm = int(rng.integers(0, mem_words * 4 + 64))
    return isa.encode(name, rd=rd, rs1=rs1, rs2=rs2, imm=imm) & 0xFFFFFFFF


def soup_bank(rng, n_progs: int, length: int, mem_words: int):
    """A bank of random programs of 1..length words: (bank, code_len)."""
    progs = [np.array([random_word(rng, mem_words)
                       for _ in range(int(rng.integers(1, length + 1)))],
                      np.uint32) for _ in range(n_progs)]
    return pack_programs(progs)


def soup_state(rng, n_lanes: int, mem_words: int, n_progs: int,
               max_steps: int = 1 << 30) -> PackedState:
    """Random lanes: registers biased toward small non-negative values
    (memory addresses in and just past range), random memory, random
    program rows and a few parked lanes."""
    regs = rng.integers(-2**31, 2**31, (n_lanes, 16)).astype(np.int64)
    small = rng.random((n_lanes, 16)) < 0.7
    regs = np.where(small, np.abs(regs) % (mem_words * 8), regs)
    regs[:, 0] = 0
    z = np.zeros(n_lanes, np.int32)
    return PackedState(
        lanes=ISSState(
            regs=regs.astype(np.int32),
            pc=z.copy(),
            mem=rng.integers(-2**31, 2**31, (n_lanes, mem_words)
                             ).astype(np.int32),
            halted=rng.random(n_lanes) < 0.1,
            n_instr=z.copy(), n_two_stage=z.copy(),
            mix=np.zeros((n_lanes, N_MIX), np.int32),
            n_cycles=z.copy()),
        prog_id=rng.integers(0, n_progs, n_lanes).astype(np.int32),
        max_steps=np.full(n_lanes, max_steps, np.int32))


def soup_cost(rng, n_progs: int) -> np.ndarray:
    """Random non-negative cost rows (every entry exercised)."""
    return rng.integers(0, 200, (n_progs, 19)).astype(np.int32)


def workload_pool(n_lanes: int, seed: int = 0):
    """A pool running all 11 FlexiBench workloads, lane i on workload
    i % 11, each on its inputs drawn from `seed`; memory padded to the
    largest workload's. Returns (bank, code_len, mem_len, cost, state)
    with `dynamic` cost rows of SERV, QERV and HERV in turn."""
    ws = all_workloads()
    bank, clen = pack_programs([w.program.code for w in ws])
    mlen = np.array([w.total_mem_words for w in ws], np.int32)
    cores = [CORES[c] for c in ("SERV", "QERV", "HERV")]
    cost = np.stack([cost_row(cores[i % 3], dynamic=True)
                     for i in range(len(ws))]).astype(np.int32)
    mem_words = int(mlen.max())
    pids = (np.arange(n_lanes) % len(ws)).astype(np.int32)
    mems = np.zeros((n_lanes, mem_words), np.int32)
    for i, p in enumerate(pids):
        w = ws[p]
        x = w.gen_inputs(np.random.default_rng([seed, i]), 1)[0]
        m = w.initial_memory(x)
        mems[i, :len(m)] = m
    z = np.zeros(n_lanes, np.int32)
    state = PackedState(
        lanes=ISSState(regs=np.zeros((n_lanes, 16), np.int32), pc=z.copy(),
                       mem=mems, halted=np.zeros(n_lanes, bool),
                       n_instr=z.copy(), n_two_stage=z.copy(),
                       mix=np.zeros((n_lanes, N_MIX), np.int32),
                       n_cycles=z.copy()),
        prog_id=pids,
        max_steps=np.array([ws[p].max_steps for p in pids], np.int32))
    return bank, clen, mlen, cost, state


def skew_program():
    """Counting loop: iterates mem[0] times, stores the count at mem[1]
    (the program of `benchmarks/fleet.py::skew_program`, built with the
    port's assembler)."""
    from repro_torch.flexibits.asm import Asm
    a = Asm(vm_reserved=32)
    a.lw(a.t0, a.zero, 0)
    a.li(a.t1, 0)
    a.label("loop")
    a.addi(a.t1, a.t1, 1)
    a.blt(a.t1, a.t0, "loop")
    a.sw(a.t1, a.zero, 4)
    a.halt()
    return a.assemble()


def skew_mems(prog, n_items: int, short_iters: int, long_iters: int,
              long_frac: float, seed: int) -> np.ndarray:
    """Memory images with a skewed halt-time distribution (the idiom of
    `benchmarks/fleet.py::skew_fleet`)."""
    rng = np.random.default_rng(seed)
    iters = np.where(rng.random(n_items) < long_frac, long_iters,
                     short_iters).astype(np.int32)
    mems = np.tile(prog.initial_memory(32), (n_items, 1))
    mems[:, 0] = iters
    return mems


def skew_groups(mod, max_steps_b: int = 200):
    """Two groups of the skew program with 40 and 24 items (the resident
    tests' plan); group b's budget cuts its long items off, so its items
    end by budget, not by halting. `mod` is the engine module (the
    reference's or the port's) whose PackedGroup/array_source to use."""
    prog = skew_program()
    mems_a = skew_mems(prog, 40, 8, 400, 0.2, 13)
    mems_b = skew_mems(prog, 24, 16, 300, 0.3, 14)
    return [
        mod.PackedGroup(code=prog.code, source=mod.array_source(mems_a),
                        n_items=40, max_steps=100_000, mem_words=32,
                        out_addr=1),
        mod.PackedGroup(code=prog.code, source=mod.array_source(mems_b),
                        n_items=24, max_steps=max_steps_b, mem_words=32,
                        out_addr=1),
    ]


RESULT_FIELDS = ("n_instr", "n_two_stage", "halted", "out", "mix", "mems",
                 "regs", "pc", "mix_items", "n_cycles")


def assert_results_equal(refs, gots, ctx: str = "") -> None:
    """Per-group FleetResults: every per-item field and the final state."""
    for g, (a, b) in enumerate(zip(refs, gots)):
        assert a.n_items == b.n_items
        for f in RESULT_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f"{ctx} group {g}: {f}"
            if x is not None:
                np.testing.assert_array_equal(
                    np.asarray(x), np.asarray(y),
                    err_msg=f"{ctx} group {g}: {f}")


def assert_packed_equal(a, b, ctx: str = "") -> None:
    """Every field of two PackedStates (numpy or array-likes) equal."""
    for f in ISSState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a.lanes, f)),
                                      np.asarray(getattr(b.lanes, f)),
                                      err_msg=f"{ctx}: lanes.{f}")
    for f in ("prog_id", "max_steps"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{ctx}: {f}")


@functools.lru_cache(maxsize=None)
def _ref_segment_fn(kind: str, seg_steps: int, subset, timing: bool):
    import jax
    from repro.flexibits import iss as riss
    from repro.kernels.iss_stepper import iss_segment_banked

    def seg(bank, clen, ps, mem_len, cost):
        cost = cost if timing else None
        if kind == "xla":
            return riss.run_segment_lanes_banked(bank, clen, ps, seg_steps,
                                                 subset, mem_len, cost)
        return iss_segment_banked(bank, clen, ps, seg_steps=seg_steps,
                                  subset=subset, mem_len=mem_len, cost=cost)
    return jax.jit(seg)


def ref_segment(kind: str, bank, clen, state: PackedState, seg_steps: int,
                mem_len, cost=None, subset=None) -> PackedState:
    """One segment of the reference: its XLA stepper
    (`iss.run_segment_lanes_banked`, kind="xla") or its Pallas kernel in
    interpret mode (`iss_stepper.iss_segment_banked`, kind="pallas").
    numpy in, numpy out; `cost=None` turns the tick tally off."""
    import jax.numpy as jnp
    from repro.flexibits import iss as riss

    ps = riss.PackedState(
        lanes=riss.ISSState(*(jnp.asarray(x) for x in state.lanes)),
        prog_id=jnp.asarray(state.prog_id),
        max_steps=jnp.asarray(state.max_steps))
    timing = cost is not None
    co = jnp.asarray(cost if timing else np.zeros((len(clen), 19), np.int32))
    fn = _ref_segment_fn(kind, seg_steps,
                         None if subset is None else frozenset(subset),
                         timing)
    out = fn(jnp.asarray(bank), jnp.asarray(clen), ps, jnp.asarray(mem_len),
             co)
    return PackedState(
        lanes=ISSState(*(np.asarray(x) for x in out.lanes)),
        prog_id=np.asarray(out.prog_id), max_steps=np.asarray(out.max_steps))
