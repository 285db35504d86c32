"""Lane-vectorized RV32E simulator in plain PyTorch.

The port of the reference's branchless, banked lane stepper
(`repro/flexibits/iss.py`): a pool of lanes, each running its own row of
a padded program bank against its own memory image and step budget. It
is the plain version of the two CUDA kernels in
`repro_torch/kernels/iss_stepper.py` (`run_segment_lanes_banked` for
`iss_segment_banked`, `refill_lanes` for `iss_refill`), which the tests
hold against the reference and the kernels are held against on the card.

With a `faults.FaultSpec`, each step ends in the post-commit fault
transform (`faults.apply_faults`, DESIGN.md §9.14) under each lane's key
and epoch: the plain version of the segment kernel's `faults` variant.

The memory ports are an indexed gather and scatter (the reference's TPU
kernel used one-hot reductions for the same thing): reads clamp the word
index into `[0, mem_len - 1]` of the lane's OWN program, and a store
whose word index lies outside `[0, mem_len)` is dropped. The fetch
clamps the pc to the lane's own program (`fetch_banked`).

All state is int32 (bool for `halted`) and every sum wraps modulo 2**32
as in the reference; the uint32 reinterpretations go through
`repro_torch._u32`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import _u32
from repro_torch.flexibits import faults as flexifault
from repro_torch.flexibits import isa
from repro_torch.flexibits.cycles import (MIX_CLASSES, SHIFT_IDX,
                                          SUBWORD_IDX, TAKEN_IDX)

I32 = torch.int32

_MIX_IDX = {c: i for i, c in enumerate(MIX_CLASSES)}

_OPCODES = (isa.OP_LUI, isa.OP_AUIPC, isa.OP_JAL, isa.OP_JALR,
            isa.OP_BRANCH, isa.OP_LOAD, isa.OP_STORE, isa.OP_IMM,
            isa.OP_REG, isa.OP_SYSTEM)
FULL_SUBSET = frozenset(_OPCODES)


class ISSState(NamedTuple):
    """Lane-batched architectural state (leading lane axis)."""
    regs: torch.Tensor         # (L, 16) int32
    pc: torch.Tensor           # (L,) int32 byte address
    mem: torch.Tensor          # (L, M) int32 word-addressed RAM
    halted: torch.Tensor       # (L,) bool
    n_instr: torch.Tensor      # (L,) int32
    n_two_stage: torch.Tensor  # (L,) int32
    mix: torch.Tensor          # (L, 8) int32 retired counts per class
    n_cycles: torch.Tensor     # (L,) int32 timing ticks


class PackedState(NamedTuple):
    """A lane pool running a bank of programs: each lane carries its bank
    row (`prog_id`) and its own retirement budget (`max_steps`)."""
    lanes: ISSState
    prog_id: torch.Tensor      # (L,) int32
    max_steps: torch.Tensor    # (L,) int32


def pack_programs(codes) -> "tuple[np.ndarray, np.ndarray]":
    """Pad programs into a (n_progs, max_len) int32 bank + length vector.
    The pad words are unreachable: every fetch clamps to the row's own
    `code_len`."""
    rows = [np.asarray(c) for c in codes]
    rows = [r.view(np.int32) if r.dtype.itemsize == 4 else
            r.astype(np.uint32).view(np.int32) for r in rows]
    max_len = max(len(r) for r in rows)
    bank = np.zeros((len(rows), max_len), np.int32)
    for i, r in enumerate(rows):
        bank[i, :len(r)] = r
    return bank, np.array([len(r) for r in rows], np.int32)


def fresh_lanes(mems: torch.Tensor) -> ISSState:
    """Zeroed lanes over the given (L, M) memory images."""
    n = mems.shape[0]
    dev = mems.device
    return ISSState(
        regs=torch.zeros((n, 16), dtype=I32, device=dev),
        pc=torch.zeros(n, dtype=I32, device=dev),
        mem=mems.to(I32),
        halted=torch.zeros(n, dtype=torch.bool, device=dev),
        n_instr=torch.zeros(n, dtype=I32, device=dev),
        n_two_stage=torch.zeros(n, dtype=I32, device=dev),
        mix=torch.zeros((n, len(MIX_CLASSES)), dtype=I32, device=dev),
        n_cycles=torch.zeros(n, dtype=I32, device=dev))


def fetch_banked(bank: torch.Tensor, code_len: torch.Tensor,
                 prog_id: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Instruction words (int32 bit patterns) per lane: word index
    `(uint32)pc >> 2`, clamped to the lane's own program length (a
    negative pc is a huge unsigned address and clamps high)."""
    pid = prog_id.long()
    pword = _u32.srl(pc, 2)
    pword = torch.minimum(torch.clamp(pword, min=0), code_len[pid] - 1)
    return bank[pid, pword.long()]


class DecodedInstr(NamedTuple):
    op: torch.Tensor
    rd: torch.Tensor
    f3: torch.Tensor
    rs1: torch.Tensor
    rs2: torch.Tensor
    sub_bit: torch.Tensor
    imm_i: torch.Tensor
    imm_s: torch.Tensor
    imm_b: torch.Tensor
    imm_u: torch.Tensor
    imm_j: torch.Tensor


def decode_fields(ii: torch.Tensor) -> DecodedInstr:
    """Bit-op decode of fetched words (int32 bit patterns). Each field is
    a masked arithmetic shift, so the sign of `ii` never leaks in."""
    sx = _u32.sx
    return DecodedInstr(
        op=ii & 0x7F,
        rd=(ii >> 7) & 0xF,
        f3=(ii >> 12) & 0x7,
        rs1=(ii >> 15) & 0xF,
        rs2=(ii >> 20) & 0xF,
        sub_bit=(ii >> 30) & 1,
        imm_i=sx((ii >> 20) & 0xFFF, 12),
        imm_s=sx(((ii >> 25) & 0x7F) << 5 | ((ii >> 7) & 0x1F), 12),
        imm_b=sx(((ii >> 31) & 1) << 12 | ((ii >> 7) & 1) << 11
                 | ((ii >> 25) & 0x3F) << 5 | ((ii >> 8) & 0xF) << 1, 13),
        imm_u=ii & -4096,
        imm_j=sx(((ii >> 31) & 1) << 20 | ((ii >> 12) & 0xFF) << 12
                 | ((ii >> 20) & 1) << 11 | ((ii >> 21) & 0x3FF) << 1, 21),
    )


def _select(conds, vals, default):
    """`jnp.select`: the value of the FIRST true condition, else default."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def alu_result(a, y, f3, is_sub, is_sra):
    """Shared OP-IMM/OP-REG ALU. Shifts use `y & 31`; sll/srl are
    logical on the uint32 pattern, sra arithmetic."""
    sh = y & 31
    return _select(
        [f3 == 0, f3 == 1, f3 == 2, f3 == 3, f3 == 4, f3 == 5, f3 == 6],
        [torch.where(is_sub, _u32.wsub(a, y), _u32.wadd(a, y)),
         _u32.sll(a, sh),
         (a < y).to(I32),
         _u32.ult(a, y).to(I32),
         a ^ y,
         torch.where(is_sra, a >> sh, _u32.srl(a, sh)),
         a | y], a & y)


def branch_taken(a, b, f3):
    """BRANCH condition (f3 in {2, 3} is never taken)."""
    false = torch.zeros_like(a, dtype=torch.bool)
    return _select(
        [f3 == 0, f3 == 1, f3 == 2, f3 == 3, f3 == 4, f3 == 5, f3 == 6],
        [a == b, a != b, false, false, a < b, a >= b, _u32.ult(a, b)],
        _u32.uge(a, b))


def load_value(word, addr, f3):
    """Sub-word load extraction; f3 clips to [0, 5] as in the reference."""
    sh8 = (addr & 3) * 8
    sh16 = (addr & 2) * 8
    byte = _u32.srl(word, sh8) & 0xFF
    half = _u32.srl(word, sh16) & 0xFFFF
    lf3 = torch.clamp(f3, 0, 5)
    return _select([lf3 == 0, lf3 == 1, lf3 == 4, lf3 == 5],
                   [_u32.sx(byte, 8), _u32.sx(half, 16), byte, half], word)


def store_word(word, addr, b, f3):
    """Read-modify-write merge of a store; f3 clips to [0, 2]."""
    sh8 = (addr & 3) * 8
    sh16 = (addr & 2) * 8
    bmask = _u32.sll(0xFF, sh8)
    hmask = _u32.sll(0xFFFF, sh16)
    sf3 = torch.clamp(f3, 0, 2)
    return _select(
        [sf3 == 0, sf3 == 1],
        [(word & ~bmask) | (_u32.sll(b & 0xFF, sh8) & bmask),
         (word & ~hmask) | (_u32.sll(b & 0xFFFF, sh16) & hmask)], b)


def branchless_commits(d: DecodedInstr, a, b, pc, subset, live, *,
                       read_word, write_word, cost=None):
    """Opcode-gated commit pipeline, ported from the reference.

    Returns (next_pc, wr, writes_rd, mem, halt, two_stage, mix_idx,
    ticks). `subset` drops opcode classes the bank cannot fetch; an
    opcode outside RV32E retires as a no-op that writes 0 to rd != 0.
    `mem` is None when the subset holds no stores, `ticks` None when
    `cost` is None.
    """
    sub = FULL_SUBSET if subset is None else frozenset(subset)

    def on(*ops):
        return any(o in sub for o in ops)

    op, rd, f3 = d.op, d.rd, d.f3
    pc4 = _u32.wadd(pc, 4)
    false = torch.zeros_like(live)
    zero = torch.zeros_like(pc)

    is_load = (op == isa.OP_LOAD) if on(isa.OP_LOAD) else false
    is_store = ((op == isa.OP_STORE) & live) if on(isa.OP_STORE) else false

    # one memory word port serves loads and stores; the word index is
    # the int32 address shifted arithmetically (a negative address is a
    # negative index: the read clamps it to 0, a store to it drops)
    mem_val = zero
    mem = None
    if on(isa.OP_LOAD, isa.OP_STORE):
        addr = _u32.wadd(a, torch.where(is_store, d.imm_s, d.imm_i))
        widx = torch.where(is_load | is_store, addr >> 2, 0)
        word = read_word(widx)
        if on(isa.OP_LOAD):
            mem_val = load_value(word, addr, f3)
        if on(isa.OP_STORE):
            mem = write_word(widx, word, store_word(word, addr, b, f3),
                             is_store)

    alu_res = zero
    if on(isa.OP_IMM, isa.OP_REG):
        is_reg = (op == isa.OP_REG) if on(isa.OP_REG) else false
        y = torch.where(is_reg, b, d.imm_i)
        alu_res = alu_result(a, y, f3,
                             is_sub=is_reg & (d.sub_bit == 1),
                             is_sra=(f3 == 5) & (d.sub_bit == 1))

    next_pc = pc4
    if on(isa.OP_BRANCH):
        next_pc = torch.where(
            op == isa.OP_BRANCH,
            torch.where(branch_taken(a, b, f3), _u32.wadd(pc, d.imm_b), pc4),
            next_pc)
    if on(isa.OP_JAL):
        next_pc = torch.where(op == isa.OP_JAL, _u32.wadd(pc, d.imm_j),
                              next_pc)
    if on(isa.OP_JALR):
        next_pc = torch.where(op == isa.OP_JALR,
                              _u32.wadd(a, d.imm_i) & ~1, next_pc)

    wr = zero
    if on(isa.OP_LUI):
        wr = torch.where(op == isa.OP_LUI, d.imm_u, wr)
    if on(isa.OP_AUIPC):
        wr = torch.where(op == isa.OP_AUIPC, _u32.wadd(pc, d.imm_u), wr)
    if on(isa.OP_JAL, isa.OP_JALR):
        wr = torch.where((op == isa.OP_JAL) | (op == isa.OP_JALR), pc4, wr)
    if on(isa.OP_LOAD):
        wr = torch.where(is_load, mem_val, wr)
    if on(isa.OP_IMM, isa.OP_REG):
        wr = torch.where((op == isa.OP_IMM) | (op == isa.OP_REG),
                         alu_res, wr)

    writes_rd = (op != isa.OP_BRANCH) & (op != isa.OP_STORE) \
        & (op != isa.OP_SYSTEM) & (rd != 0) & live
    halt = (op == isa.OP_SYSTEM) if on(isa.OP_SYSTEM) else false
    two_stage, mix_idx = classify(op, f3)
    ticks = None
    if cost is not None:
        taken, shamt, subword = dynamic_terms(op, f3, a, b, d.imm_i, subset)
        ticks = timing_ticks(cost, two_stage, mix_idx, taken, shamt,
                             subword)
    return next_pc, wr, writes_rd, mem, halt, two_stage, mix_idx, ticks


def classify(op, f3):
    """(two_stage, mix_idx) per instruction: the paper's bit-serial
    timing classes and Fig. 2a mix categories."""
    is_shift_imm = (op == isa.OP_IMM) & ((f3 == 1) | (f3 == 5))
    is_shift_reg = (op == isa.OP_REG) & ((f3 == 1) | (f3 == 5))
    is_slt = ((op == isa.OP_IMM) | (op == isa.OP_REG)) \
        & ((f3 == 2) | (f3 == 3))
    two_stage = ((op == isa.OP_LOAD) | (op == isa.OP_STORE)
                 | (op == isa.OP_BRANCH) | (op == isa.OP_JAL)
                 | (op == isa.OP_JALR) | is_shift_imm | is_shift_reg
                 | is_slt)
    mix_idx = _select(
        [op == isa.OP_LOAD, op == isa.OP_STORE, op == isa.OP_BRANCH,
         (op == isa.OP_JAL) | (op == isa.OP_JALR),
         is_shift_imm | is_shift_reg,
         (op == isa.OP_IMM) | (op == isa.OP_LUI) | (op == isa.OP_AUIPC),
         op == isa.OP_REG],
        [_MIX_IDX["loads"], _MIX_IDX["stores"], _MIX_IDX["branches"],
         _MIX_IDX["jumps"], _MIX_IDX["shifts"], _MIX_IDX["I-type"],
         _MIX_IDX["R-type"]],
        torch.full_like(op, _MIX_IDX["system"]))
    return two_stage, mix_idx


def dynamic_terms(op, f3, a, b, imm_i, subset: frozenset = None):
    """Per-instruction dynamic timing events: a taken BRANCH, the shift
    amount of a serial shift, and a subword load/store (f3 clipped as in
    `load_value`/`store_word`)."""
    sub = FULL_SUBSET if subset is None else frozenset(subset)

    def on(*ops):
        return any(o in sub for o in ops)

    false = torch.zeros_like(op, dtype=torch.bool)
    zero = torch.zeros_like(op)

    taken = ((op == isa.OP_BRANCH) & branch_taken(a, b, f3)) \
        if on(isa.OP_BRANCH) else false

    shamt = zero
    if on(isa.OP_IMM, isa.OP_REG):
        is_shift = (((op == isa.OP_IMM) | (op == isa.OP_REG))
                    & ((f3 == 1) | (f3 == 5)))
        shamt = torch.where(
            is_shift, torch.where(op == isa.OP_REG, b, imm_i) & 31, 0)

    subword = false
    if on(isa.OP_LOAD):
        lf3 = torch.clamp(f3, 0, 5)
        subword = subword | ((op == isa.OP_LOAD) & (lf3 != 2) & (lf3 != 3))
    if on(isa.OP_STORE):
        sf3 = torch.clamp(f3, 0, 2)
        subword = subword | ((op == isa.OP_STORE) & (sf3 != 2))
    return taken, shamt, subword


def timing_ticks(cost, two_stage, mix_idx, taken, shamt, subword):
    """Ticks retired per instruction under per-lane cost rows (L, 19):
    the (stage, class) base entry plus the dynamic terms, summed modulo
    2**32."""
    n = len(MIX_CLASSES)
    col = mix_idx.long() + n * two_stage.long()
    base = cost.gather(1, col[:, None])[:, 0].to(torch.int64)
    t = (base + taken.to(torch.int64) * cost[:, TAKEN_IDX]
         + shamt.to(torch.int64) * cost[:, SHIFT_IDX]
         + subword.to(torch.int64) * cost[:, SUBWORD_IDX])
    return _u32.wrap(t)


def opcode_subset(code) -> frozenset:
    """The opcode classes present in a program's text (text mode: only
    words in `code` are ever fetched, so the set is sound)."""
    words = np.asarray(code)
    words = words.view(np.uint32) if words.dtype.itemsize == 4 \
        else words.astype(np.uint32)
    present = {int(o) for o in np.unique(words & np.uint32(0x7F))}
    return frozenset(o for o in _OPCODES if o in present)


def step_lanes_banked(bank: torch.Tensor, code_len: torch.Tensor,
                      states: ISSState, prog_id: torch.Tensor,
                      subset: frozenset = None,
                      active: Optional[torch.Tensor] = None,
                      mem_len: Optional[torch.Tensor] = None,
                      cost: Optional[torch.Tensor] = None, faults=None,
                      lane_key: Optional[torch.Tensor] = None,
                      epoch: Optional[torch.Tensor] = None) -> ISSState:
    """One branchless step of every lane, each on its own program.

    `active=False` freezes a lane; `mem_len` (per LANE) bounds the memory
    ports at the lane's own word count (None: the pool width); `cost`
    (per-LANE (L, 19) rows) turns on the tick tally; `faults` (with
    per-lane int32 `lane_key` bits and `epoch`) applies the post-commit
    fault transform to lanes that were live and did not halt.
    """
    n_lanes, mem_words = states.mem.shape
    live = torch.ones(n_lanes, dtype=torch.bool, device=states.pc.device) \
        if active is None else active
    mlen = torch.full_like(states.pc, mem_words) if mem_len is None \
        else mem_len
    d = decode_fields(fetch_banked(bank, code_len, prog_id, states.pc))
    a = states.regs.gather(1, d.rs1.long()[:, None])[:, 0]
    b = states.regs.gather(1, d.rs2.long()[:, None])[:, 0]

    def read_word(widx):
        ridx = torch.minimum(torch.clamp(widx, min=0), mlen - 1)
        return states.mem.gather(1, ridx.long()[:, None])[:, 0]

    def write_word(widx, word, neww, is_store):
        # a store outside [0, mem_len) drops; every other lane writes
        # word 0 back onto itself, so one scatter serves the pool
        ok = is_store & (widx >= 0) & (widx < mlen)
        idx = torch.where(ok, widx, 0).long()[:, None]
        val = torch.where(ok, neww, states.mem[:, 0])[:, None]
        return states.mem.scatter(1, idx, val)

    next_pc, wr, writes_rd, mem, halt, two_stage, mix_idx, ticks = \
        branchless_commits(d, a, b, states.pc, subset, live,
                           read_word=read_word, write_word=write_word,
                           cost=cost)
    rd = d.rd.long()[:, None]
    old_rd = states.regs.gather(1, rd)[:, 0]
    one = live.to(I32)
    out = ISSState(
        regs=states.regs.scatter(
            1, rd, torch.where(writes_rd, wr, old_rd)[:, None]),
        pc=torch.where(live, next_pc, states.pc),
        mem=states.mem if mem is None else mem,
        halted=states.halted | (halt & live),
        n_instr=states.n_instr + one,
        n_two_stage=states.n_two_stage + (two_stage & live).to(I32),
        mix=states.mix.scatter_add(1, mix_idx.long()[:, None], one[:, None]),
        n_cycles=states.n_cycles if ticks is None
        else _u32.wadd(states.n_cycles, ticks * one))
    return flexifault.apply_faults(faults, lane_key, epoch, out, live=live,
                                   mem_len=mlen)


def run_segment_lanes_banked(bank: torch.Tensor, code_len: torch.Tensor,
                             ps: PackedState, seg_steps: int,
                             subset: frozenset = None,
                             mem_len: Optional[torch.Tensor] = None,
                             cost: Optional[torch.Tensor] = None,
                             faults=None,
                             lane_key: Optional[torch.Tensor] = None,
                             epoch: Optional[torch.Tensor] = None
                             ) -> PackedState:
    """Up to `seg_steps` banked steps for every lane (the plain version
    of the `iss_segment_banked` kernel).

    A lane steps while it is live: not halted and under its own budget.
    `mem_len` and `cost` are per-PROGRAM, like `code_len`; `faults` (with
    per-LANE `lane_key`/`epoch`: schedules belong to the physical lane)
    turns on the post-commit fault transform. The pool loop
    stops early once no lane is live (one host read per step), which
    changes nothing: a lane that is not live stays so.
    """
    pid = ps.prog_id.long()
    lane_mlen = None if mem_len is None else mem_len[pid]
    lane_cost = None if cost is None else cost[pid]
    st = ps.lanes
    for _ in range(seg_steps):
        act = (~st.halted) & (st.n_instr < ps.max_steps)
        if not bool(act.any()):
            break
        st = step_lanes_banked(bank, code_len, st, ps.prog_id, subset,
                               active=act, mem_len=lane_mlen, cost=lane_cost,
                               faults=faults, lane_key=lane_key, epoch=epoch)
    return PackedState(lanes=st, prog_id=ps.prog_id, max_steps=ps.max_steps)


def retire_mask(ps: PackedState, item_slot: torch.Tensor) -> torch.Tensor:
    """Occupied lanes (`item_slot >= 0`) that halted or spent their own
    budget."""
    return (item_slot >= 0) & (ps.lanes.halted
                               | (ps.lanes.n_instr >= ps.max_steps))


def refill_take(free: torch.Tensor, n_staged: torch.Tensor):
    """Staged->lane assignment: free lanes ranked in lane order (a
    cumsum), the first `n_staged` take staged rows 0..n_staged-1.
    Returns (take, src); `src` is clipped for lanes that do not take."""
    rank = torch.cumsum(free.to(I32), 0, dtype=I32) - 1
    take = free & (rank < n_staged)
    src = torch.clamp(rank, 0, free.shape[0] - 1)
    return take, src


def refill_lanes(ps: PackedState, take: torch.Tensor, src: torch.Tensor,
                 staged_mems: torch.Tensor, staged_prog: torch.Tensor,
                 staged_ms: torch.Tensor) -> PackedState:
    """Swap fresh items into `take` lanes from staged rows `src` (the
    plain version of the `iss_refill` kernel). Gathers clamp `src` into
    the staged batch, as the reference's do."""
    s = torch.clamp(src, 0, staged_mems.shape[0] - 1).long()
    t1 = take[:, None]
    lanes = ps.lanes
    return PackedState(
        lanes=ISSState(
            regs=torch.where(t1, 0, lanes.regs),
            pc=torch.where(take, 0, lanes.pc),
            mem=torch.where(t1, staged_mems[s], lanes.mem),
            halted=torch.where(take, False, lanes.halted),
            n_instr=torch.where(take, 0, lanes.n_instr),
            n_two_stage=torch.where(take, 0, lanes.n_two_stage),
            mix=torch.where(t1, 0, lanes.mix),
            n_cycles=torch.where(take, 0, lanes.n_cycles)),
        prog_id=torch.where(take, staged_prog[s], ps.prog_id),
        max_steps=torch.where(take, staged_ms[s], ps.max_steps))
