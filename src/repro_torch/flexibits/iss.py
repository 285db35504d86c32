"""Lane-vectorized RV32E simulator in plain PyTorch.

The port of the reference's `repro/flexibits/iss.py`: every stepper
takes a pool of lanes (a leading lane axis on every state field; the
single-item entry points `run`, `step`, `step_branchless`, `run_segment`
and `run_segment_banked` also take one item's state without it).

- The banked branchless stepper (`step_lanes_banked`,
  `run_segment_lanes_banked`): each lane runs its own row of a padded
  program bank against its own memory image and step budget. With the
  default `edges="kernel"` it is the plain version of the two CUDA
  kernels in `repro_torch/kernels/iss_stepper.py`
  (`run_segment_lanes_banked` for `iss_segment_banked`, `refill_lanes`
  for `iss_refill`), which the tests hold against the reference's TPU
  kernel and the kernels are held against on the card.
- The reference's baseline steppers, plain torch on the caller's device:
  the branchless `step_branchless`/`step_lanes`/`run_segment_lanes`
  (and the banked stepper with `edges="xla"`), and the `lax.switch`
  interpreter `step` with `run`, `run_segment`, `run_segment_banked` and
  `run_fleet`. `step` computes every opcode's result and selects one per
  lane with `torch.where`, as the reference's vmapped switch does.

One commit pipeline (`branchless_commits`) serves every branchless
stepper; only its memory ports differ. The kernel's ports clamp a read's
word index into `[0, mem_len - 1]` of the lane's OWN program and drop a
store outside `[0, mem_len)`. The reference's XLA ports (`edges="xla"`,
and `step`) index the way its gathers and scatters do: a negative word
index counts from the row's end (a read clamps what is still out of
range, a write drops it), so a store to a negative word index wraps to
the row's end; with a per-lane `mem_len` a read clamps into the lane's
bound first, and the branchless stepper's one scatter writes a load's
clamped word back at the load's own index, which for a load past
`mem_len` lands in the pad. `step` keeps the reference's per-branch
ports: its loads never write. On programs that stay inside their memory
(every FlexiBench workload) all of them agree.

With a `faults.FaultSpec`, each step ends in the post-commit fault
transform (`faults.apply_faults`, DESIGN.md §9.14) under each lane's key
and epoch: the plain version of the segment kernel's `faults` variant.
The fetch clamps the pc to the lane's own program (`fetch_banked`).

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
    """Architectural state of a lane pool (a leading lane axis on every
    field, as below), or of one item (the same fields without it)."""
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


def init_state(mem: torch.Tensor) -> ISSState:
    """Zeroed state over memory image(s) `mem`: one item's for an (M,)
    image, a pool of lanes for (L, M) images."""
    lead = tuple(mem.shape[:-1])
    dev = mem.device

    def z(*shape, dtype=I32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)
    return ISSState(regs=z(16), pc=z(), mem=mem.to(I32),
                    halted=z(dtype=torch.bool), n_instr=z(),
                    n_two_stage=z(), mix=z(len(MIX_CLASSES)), n_cycles=z())


def fresh_lanes(mems: torch.Tensor) -> ISSState:
    """Zeroed lanes over the given (L, M) memory images."""
    return init_state(mems)


def _as_lanes(s: ISSState) -> "tuple[ISSState, bool]":
    """`s` with a lane axis, and whether one was added (one item's
    state: `pc` has no lane axis)."""
    if s.pc.dim() == 0:
        return ISSState(*(x.unsqueeze(0) for x in s)), True
    return s, False


def _drop_lanes(s: ISSState, added: bool) -> ISSState:
    return ISSState(*(x.squeeze(0) for x in s)) if added else s


def _per_lane(x, n: int, dev: torch.device) -> Optional[torch.Tensor]:
    """An optional per-lane operand as an (n,) tensor (a scalar is
    shared by every lane)."""
    if x is None:
        return None
    t = torch.as_tensor(x, device=dev)
    return t.expand(n) if t.dim() == 0 else t


def _cost_rows(cost, n: int) -> Optional[torch.Tensor]:
    """Cost row(s) as (n, 19): one shared (19,) row or per-lane rows."""
    if cost is None:
        return None
    return cost.expand(n, -1) if cost.dim() == 1 else cost


def _fetch(code: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """One program's instruction words at each lane's pc: word index
    `(uint32)pc >> 2`, clamped to the program's last word."""
    pword = torch.clamp(_u32.srl(pc, 2), max=code.shape[0] - 1)
    return code.to(I32)[pword.long()]


def _select_lanes(act: torch.Tensor, new: ISSState, old: ISSState
                  ) -> ISSState:
    """`new` on the lanes of `act`, `old` elsewhere."""
    return ISSState(*(torch.where(act.view((-1,) + (1,) * (x.dim() - 1)),
                                  y, x) for x, y in zip(old, new)))


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


EDGES = ("kernel", "xla")


def _gather(mem: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return mem.gather(1, idx.long()[:, None])[:, 0]


def _xla_index(mem: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """A word index as the reference's gathers and scatters read it: a
    negative index counts from the row's end."""
    return torch.where(widx < 0, widx + mem.shape[1], widx)


def _xla_read(mem: torch.Tensor, widx: torch.Tensor,
              mlen: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's memory read: clamped into [0, mem_len - 1] with a
    per-lane bound, else a negative index counts from the row's end and
    what is still out of range clamps."""
    if mlen is not None:
        return _gather(mem, torch.minimum(torch.clamp(widx, min=0),
                                          mlen - 1))
    return _gather(mem, torch.clamp(_xla_index(mem, widx), 0,
                                    mem.shape[1] - 1))


def _xla_write(mem: torch.Tensor, widx: torch.Tensor, val: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """The reference's one-word scatter on the lanes of `mask`: a
    negative index counts from the row's end, what is still out of range
    drops (those lanes write word 0 back onto itself)."""
    w = _xla_index(mem, widx)
    ok = mask & (w >= 0) & (w < mem.shape[1])
    return mem.scatter(1, torch.where(ok, w, 0).long()[:, None],
                       torch.where(ok, val, mem[:, 0])[:, None])


def _branchless_step(states: ISSState, instr: torch.Tensor, subset,
                     live: torch.Tensor, mem_len: Optional[torch.Tensor],
                     cost: Optional[torch.Tensor], faults, lane_key, epoch,
                     edges: str) -> ISSState:
    """One branchless step of a lane pool on fetched words `instr`,
    through `branchless_commits` with the memory ports of `edges`."""
    mem0 = states.mem
    if edges == "kernel":
        mlen = torch.full_like(states.pc, mem0.shape[1]) \
            if mem_len is None else mem_len

        def read_word(widx):
            return _gather(mem0, torch.minimum(torch.clamp(widx, min=0),
                                               mlen - 1))

        def write_word(widx, word, neww, is_store):
            # a store outside [0, mem_len) drops; every other lane writes
            # word 0 back onto itself, so one scatter serves the pool
            ok = is_store & (widx >= 0) & (widx < mlen)
            idx = torch.where(ok, widx, 0).long()[:, None]
            val = torch.where(ok, neww, mem0[:, 0])[:, None]
            return mem0.scatter(1, idx, val)
    elif edges == "xla":
        mlen = mem_len

        def read_word(widx):
            return _xla_read(mem0, widx, mlen)

        def write_word(widx, word, neww, is_store):
            # every lane scatters: a store its merged word (dropped past
            # its own bound), any other lane the word it read, back at
            # its own index (a no-op but for a load past mem_len)
            if mlen is not None:
                is_store = is_store & (widx < mlen)
            return _xla_write(mem0, widx, torch.where(is_store, neww, word),
                              torch.ones_like(is_store))
    else:
        raise ValueError(f"edges must be one of {EDGES}, got {edges!r}")

    d = decode_fields(instr)
    a = states.regs.gather(1, d.rs1.long()[:, None])[:, 0]
    b = states.regs.gather(1, d.rs2.long()[:, None])[:, 0]
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
        mem=mem0 if mem is None else mem,
        halted=states.halted | (halt & live),
        n_instr=states.n_instr + one,
        n_two_stage=states.n_two_stage + (two_stage & live).to(I32),
        mix=states.mix.scatter_add(1, mix_idx.long()[:, None], one[:, None]),
        n_cycles=states.n_cycles if ticks is None
        else _u32.wadd(states.n_cycles, ticks * one))
    return flexifault.apply_faults(faults, lane_key, epoch, out, live=live,
                                   mem_len=mlen)


def step_lanes_banked(bank: torch.Tensor, code_len: torch.Tensor,
                      states: ISSState, prog_id: torch.Tensor,
                      subset: frozenset = None,
                      active: Optional[torch.Tensor] = None,
                      mem_len: Optional[torch.Tensor] = None,
                      cost: Optional[torch.Tensor] = None, faults=None,
                      lane_key: Optional[torch.Tensor] = None,
                      epoch: Optional[torch.Tensor] = None,
                      edges: str = "kernel") -> ISSState:
    """One branchless step of every lane, each on its own program.

    `active=False` freezes a lane; `mem_len` (per LANE) bounds the memory
    ports at the lane's own word count (None: the pool width); `cost`
    (per-LANE (L, 19) rows) turns on the tick tally; `faults` (with
    per-lane int32 `lane_key` bits and `epoch`) applies the post-commit
    fault transform to lanes that were live and did not halt. `edges`
    picks the memory ports: the kernel's, or the reference's XLA
    stepper's (see the module docstring).
    """
    live = torch.ones(states.pc.shape[0], dtype=torch.bool,
                      device=states.pc.device) if active is None else active
    return _branchless_step(
        states, fetch_banked(bank, code_len, prog_id, states.pc), subset,
        live, mem_len, cost, faults, lane_key, epoch, edges)


def run_segment_lanes_banked(bank: torch.Tensor, code_len: torch.Tensor,
                             ps: PackedState, seg_steps: int,
                             subset: frozenset = None,
                             mem_len: Optional[torch.Tensor] = None,
                             cost: Optional[torch.Tensor] = None,
                             faults=None,
                             lane_key: Optional[torch.Tensor] = None,
                             epoch: Optional[torch.Tensor] = None,
                             edges: str = "kernel") -> PackedState:
    """Up to `seg_steps` banked steps for every lane: with the default
    `edges="kernel"` the plain version of the `iss_segment_banked`
    kernel, with `edges="xla"` the reference's XLA stepper (the engine's
    `stepper="branchless"`).

    A lane steps while it is live: not halted and under its own budget.
    `mem_len` and `cost` are per-PROGRAM, like `code_len`; `faults` (with
    per-LANE `lane_key`/`epoch`: schedules belong to the physical lane)
    turns on the post-commit fault transform. The pool loop
    stops early once no lane is live (one host read per step), as the
    reference's while_loop does; a lane that is not live stays so.
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
                               faults=faults, lane_key=lane_key, epoch=epoch,
                               edges=edges)
    return PackedState(lanes=st, prog_id=ps.prog_id, max_steps=ps.max_steps)


def step_branchless(code: torch.Tensor, s: ISSState,
                    subset: frozenset = None, active=None, *,
                    instr=None, mem_len=None,
                    cost: Optional[torch.Tensor] = None, faults=None,
                    lane_key=None, epoch=None) -> ISSState:
    """One branchless step on one program `code` (the reference's
    `step_branchless`, with its XLA memory ports): bit-exact with `step`
    on RV32E programs. `s` is one item's state or a lane pool;
    `active=False` freezes a lane; `instr` overrides the fetch; `mem_len`
    (per lane, or one shared bound) bounds the memory ports at the
    lane's own word count; `cost` is one shared (19,) row or per-lane
    rows; `faults` (with per-lane `lane_key`/`epoch`) applies the
    post-commit fault transform."""
    st, added = _as_lanes(s)
    n, dev = st.pc.shape[0], st.pc.device
    live = torch.ones(n, dtype=torch.bool, device=dev) if active is None \
        else _per_lane(active, n, dev)
    ii = _fetch(code, st.pc) if instr is None \
        else _per_lane(instr, n, dev).to(I32)
    out = _branchless_step(st, ii, subset, live, _per_lane(mem_len, n, dev),
                           _cost_rows(cost, n), faults,
                           _per_lane(lane_key, n, dev),
                           _per_lane(epoch, n, dev), "xla")
    return _drop_lanes(out, added)


def step_lanes(code: torch.Tensor, states: ISSState,
               subset: frozenset = None,
               active: Optional[torch.Tensor] = None,
               cost: Optional[torch.Tensor] = None, faults=None,
               lane_key: Optional[torch.Tensor] = None,
               epoch: Optional[torch.Tensor] = None) -> ISSState:
    """Branchless step over a lane pool on one program (the reference's
    `step_lanes`): `cost` is one shared (19,) row, `faults` takes
    per-lane `lane_key`/`epoch`."""
    return step_branchless(code, states, subset, active, cost=cost,
                           faults=faults, lane_key=lane_key, epoch=epoch)


def run_segment_lanes(code: torch.Tensor, states: ISSState, seg_steps: int,
                      max_steps: int, subset: frozenset = None,
                      unroll: int = 1,
                      cost: Optional[torch.Tensor] = None, faults=None,
                      lane_key: Optional[torch.Tensor] = None,
                      epoch: Optional[torch.Tensor] = None) -> ISSState:
    """Up to `seg_steps` branchless steps for every lane of a
    one-program pool under one `max_steps` budget (the reference's
    `run_segment_lanes`). `unroll` is accepted for the reference's
    signature: its masked sub-steps change no result, so the loop steps
    once a trip."""
    st = states
    for _ in range(seg_steps):
        act = (~st.halted) & (st.n_instr < max_steps)
        if not bool(act.any()):
            break
        st = step_lanes(code, st, subset, act, cost, faults, lane_key, epoch)
    return st


def retire_mask(ps: PackedState, item_slot: torch.Tensor) -> torch.Tensor:
    """Occupied lanes (`item_slot >= 0`) that halted or spent their own
    budget."""
    return (item_slot >= 0) & (ps.lanes.halted
                               | (ps.lanes.n_instr >= ps.max_steps))


def refill_take(free: torch.Tensor, n_staged: torch.Tensor):
    """Staged->lane assignment: free lanes ranked in lane order (a
    cumsum), the first `n_staged` take staged rows 0..n_staged-1.
    Returns (take, src); `src` is clipped for lanes that do not take.
    The rank runs along the last axis, so (shards, lanes) masks with
    (shards, 1) counts rank each shard's lanes on their own."""
    rank = torch.cumsum(free.to(I32), -1, dtype=I32) - 1
    take = free & (rank < n_staged)
    src = torch.clamp(rank, 0, free.shape[-1] - 1)
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


# ---------------------------------------------------------------------------
# The reference's lax.switch interpreter and its loops


_SORTED_OPS = tuple(sorted(_OPCODES))


def step(code: torch.Tensor, s: ISSState, *, instr=None, mem_len=None,
         cost: Optional[torch.Tensor] = None, faults=None, lane_key=None,
         epoch=None) -> ISSState:
    """One step of the reference's `lax.switch` interpreter (`iss.step`)
    for one item's state or a lane pool.

    Every opcode's result is computed and one is selected per lane, as
    the reference's vmapped switch does, with its per-branch memory
    ports: a load reads, a store reads and writes (a negative word index
    counts from the row's end; with `mem_len`, reads clamp into the
    lane's bound and a store past it writes the word back). A word whose
    opcode is outside RV32E dispatches as the reference's clamped
    `searchsorted` does, to the next opcode up. `instr` overrides the
    fetch; `mem_len` (per lane, or shared), `cost` (one (19,) row or
    per-lane rows) and `faults` (with per-lane `lane_key`/`epoch`) as
    in `step_branchless`.
    """
    st, added = _as_lanes(s)
    n, dev = st.pc.shape[0], st.pc.device
    ml = _per_lane(mem_len, n, dev)
    ii = _fetch(code, st.pc) if instr is None \
        else _per_lane(instr, n, dev).to(I32)
    d = decode_fields(ii)
    op, f3, pc = d.op, d.f3, st.pc
    a = st.regs.gather(1, d.rs1.long()[:, None])[:, 0]
    b = st.regs.gather(1, d.rs2.long()[:, None])[:, 0]
    pc4 = _u32.wadd(pc, 4)

    # the switch's case: the first opcode >= op, else the last
    case = torch.full_like(op, _SORTED_OPS[-1])
    for o in reversed(_SORTED_OPS):
        case = torch.where(op <= o, o, case)

    # LOAD: read only
    laddr = _u32.wadd(a, d.imm_i)
    lval = load_value(_xla_read(st.mem, laddr >> 2, ml), laddr, f3)
    # STORE: read, merge, write (the word back past the lane's bound)
    saddr = _u32.wadd(a, d.imm_s)
    swidx = saddr >> 2
    neww = store_word(_xla_read(st.mem, swidx, ml), saddr, b, f3)
    if ml is not None:
        neww = torch.where(swidx < ml, neww, _xla_read(st.mem, swidx, None))
    mem = _xla_write(st.mem, swidx, neww, case == isa.OP_STORE)
    # OP-IMM / OP-REG
    is_reg = case == isa.OP_REG
    alu = alu_result(a, torch.where(is_reg, b, d.imm_i), f3,
                     is_sub=is_reg & (d.sub_bit == 1),
                     is_sra=(f3 == 5) & (d.sub_bit == 1))

    zero = torch.zeros_like(pc)
    wr = _select(
        [case == isa.OP_LUI, case == isa.OP_AUIPC,
         (case == isa.OP_JAL) | (case == isa.OP_JALR),
         case == isa.OP_LOAD, (case == isa.OP_IMM) | is_reg],
        [d.imm_u, _u32.wadd(pc, d.imm_u), pc4, lval, alu], zero)
    next_pc = _select(
        [case == isa.OP_JAL, case == isa.OP_JALR, case == isa.OP_BRANCH],
        [_u32.wadd(pc, d.imm_j), _u32.wadd(a, d.imm_i) & ~1,
         torch.where(branch_taken(a, b, f3), _u32.wadd(pc, d.imm_b), pc4)],
        pc4)
    halt = case == isa.OP_SYSTEM

    writes_rd = (op != isa.OP_BRANCH) & (op != isa.OP_STORE) \
        & (op != isa.OP_SYSTEM) & (d.rd != 0)
    rd = d.rd.long()[:, None]
    old_rd = st.regs.gather(1, rd)[:, 0]
    two_stage, mix_idx = classify(op, f3)
    n_cycles = st.n_cycles
    if cost is not None:
        taken, shamt, subword = dynamic_terms(op, f3, a, b, d.imm_i)
        n_cycles = _u32.wadd(n_cycles, timing_ticks(
            _cost_rows(cost, n), two_stage, mix_idx, taken, shamt, subword))
    out = ISSState(
        regs=st.regs.scatter(1, rd,
                             torch.where(writes_rd, wr, old_rd)[:, None]),
        pc=next_pc, mem=mem, halted=st.halted | halt,
        n_instr=st.n_instr + 1,
        n_two_stage=st.n_two_stage + two_stage.to(I32),
        mix=st.mix.scatter_add(1, mix_idx.long()[:, None],
                               torch.ones_like(mix_idx)[:, None]),
        n_cycles=n_cycles)
    out = flexifault.apply_faults(faults, _per_lane(lane_key, n, dev),
                                  _per_lane(epoch, n, dev), out, mem_len=ml)
    return _drop_lanes(out, added)


def _switch_loop(st: ISSState, seg_steps: Optional[int], max_steps,
                 step_fn) -> ISSState:
    """Step every lane while it is not halted, under its `max_steps` and
    within `seg_steps` (None: no bound) steps: the reference's
    while_loop, vmapped over the lanes (a lane that stops keeps its
    state; the loop ends once none steps)."""
    k = 0
    while seg_steps is None or k < seg_steps:
        act = (~st.halted) & (st.n_instr < max_steps)
        if not bool(act.any()):
            break
        st = _select_lanes(act, step_fn(st), st)
        k += 1
    return st


def run_fleet(code: torch.Tensor, mems: torch.Tensor, max_steps: int,
              cost: Optional[torch.Tensor] = None) -> ISSState:
    """Run every item of (L, M) `mems` on one program to its ecall or
    `max_steps` retirements (the reference's vmapped `run`)."""
    return _switch_loop(init_state(mems), None, max_steps,
                        lambda st: step(code, st, cost=cost))


def run(code: torch.Tensor, mem: torch.Tensor, max_steps: int,
        cost: Optional[torch.Tensor] = None) -> ISSState:
    """Run one item (an (M,) image) to its ecall or `max_steps`."""
    return _drop_lanes(run_fleet(code, mem[None], max_steps, cost), True)


def run_segment(code: torch.Tensor, s: ISSState, seg_steps: int,
                max_steps: int, cost: Optional[torch.Tensor] = None
                ) -> ISSState:
    """Resume one item's state or a lane pool for up to `seg_steps`
    further steps of `step`: run to the end segment by segment, it
    retires exactly what `run` does."""
    st, added = _as_lanes(s)
    out = _switch_loop(st, seg_steps, max_steps,
                       lambda x: step(code, x, cost=cost))
    return _drop_lanes(out, added)


def run_segment_banked(bank: torch.Tensor, code_len: torch.Tensor,
                       prog_id, max_steps, s: ISSState, seg_steps: int,
                       mem_len: Optional[torch.Tensor] = None,
                       cost: Optional[torch.Tensor] = None, faults=None,
                       lane_key=None, epoch=None) -> ISSState:
    """Banked `run_segment` (the engine's `stepper="switch"`): each lane
    fetches from its bank row `prog_id` under its own `max_steps`;
    `mem_len` and `cost` are per-PROGRAM, `faults` takes per-lane
    `lane_key`/`epoch`. One item's state with scalar `prog_id` and
    `max_steps`, or a lane pool with per-lane ones."""
    st, added = _as_lanes(s)
    n, dev = st.pc.shape[0], st.pc.device
    pid = _per_lane(prog_id, n, dev)
    ms = _per_lane(max_steps, n, dev)
    ml = None if mem_len is None else mem_len[pid.long()]
    cr = None if cost is None else cost[pid.long()]
    key, ep = _per_lane(lane_key, n, dev), _per_lane(epoch, n, dev)

    def one(x):
        return step(bank, x, instr=fetch_banked(bank, code_len, pid, x.pc),
                    mem_len=ml, cost=cr, faults=faults, lane_key=key,
                    epoch=ep)
    return _drop_lanes(_switch_loop(st, seg_steps, ms, one), added)
