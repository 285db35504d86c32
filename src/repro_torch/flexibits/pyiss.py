"""Pure-Python RV32E instruction-set simulator — the oracle for the JAX ISS
property tests (spike-equivalent for our subset).

Also the *cycle* oracle for the timing layer (DESIGN.md §9.10): every
step records core-independent timing events (`events`, the dual of
`cycles.cost_row`) — per-(stage, mix-class) retirements, taken
branches, total serial shift amount, subword memory ops — so one
profiling run prices a program on any core via a dot product. With a
`cost` row the oracle additionally accumulates `n_cycles` exactly as
the JAX steppers do, int32 wrap included.

Memory follows the JAX steppers' out-of-range contract: reads clamp to
the last word, writes past the end drop (the jax gather/scatter
semantics every stepper reproduces). Word indices are computed through
the same int32 reinterpretation the steppers use, so the differential
tests can compare the two bit-for-bit on OOB-touching programs
(addresses with bit 31 set are outside the contract, as in iss.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.flexibits import isa
from repro_torch.flexibits.asm import disasm
from repro_torch.flexibits.cycles import (MIX_CLASSES, N_COST,
                                          SHIFT_IDX, SUBWORD_IDX, TAKEN_IDX)

_MIX_IDX = {c: i for i, c in enumerate(MIX_CLASSES)}
_N_MIX = len(MIX_CLASSES)
_SUBWORD_NAMES = frozenset(("lb", "lh", "lbu", "lhu", "sb", "sh"))


def _sx(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _u32(v: int) -> int:
    return v & 0xFFFFFFFF


def _s32(v: int) -> int:
    return _sx(v, 32)


class PyISS:
    def __init__(self, code: np.ndarray, mem_words: int = 4096,
                 init_mem: Optional[np.ndarray] = None,
                 cost: Optional[np.ndarray] = None,
                 trace_len: int = 0):
        self.code = np.asarray(code, np.uint32)
        self.mem = np.zeros(mem_words, np.int64)
        if init_mem is not None:
            self.mem[:len(init_mem)] = np.asarray(init_mem, np.int64)
        self.regs = [0] * 16
        self.pc = 0
        self.halted = False
        self.n_instr = 0
        self.mix: Dict[str, int] = {}
        self.n_two_stage = 0
        self.max_sp_used = None
        self.events = np.zeros(N_COST, np.int64)
        self.cost = None if cost is None else np.asarray(cost, np.int64)
        self.n_cycles = 0
        # FlexiLint cross-validation (DESIGN.md §9.11): every retired
        # word index, plus an optional ring of the last `trace_len`
        # (pc, word) pairs for disassembled trace dumps
        self.visited: set = set()
        self._trace_len = int(trace_len)
        self.trace: list = []
        # FlexiFault oracle hook (DESIGN.md §9.14): called with `self`
        # after every retired instruction that did not halt the machine
        # — the exact point the JAX steppers apply their post-commit
        # fault transform (faults.apply_fault_arrays)
        self.post_commit = None

    def _widx(self, addr: int) -> int:
        # the steppers' word index: uint32 address reinterpreted int32,
        # then arithmetic >> 2
        return _s32(addr) >> 2

    def _load_word(self, addr: int) -> int:
        widx = max(0, min(self._widx(addr), len(self.mem) - 1))
        return _s32(int(self.mem[widx]))

    def _store_word(self, addr: int, val: int):
        widx = self._widx(addr)
        if 0 <= widx < len(self.mem):
            self.mem[widx] = _s32(val)

    def _load_sub(self, addr: int, nbytes: int, signed: bool) -> int:
        w = _u32(self._load_word(addr & ~3))
        # halfword ports are aligned to addr & ~1, as in the steppers
        # (the serial cores have no misaligned-access machinery)
        sh = ((addr & 3) if nbytes == 1 else (addr & 2)) * 8
        v = (w >> sh) & ((1 << (nbytes * 8)) - 1)
        return _sx(v, nbytes * 8) if signed else v

    def _store_sub(self, addr: int, nbytes: int, val: int):
        w = _u32(self._load_word(addr & ~3))
        sh = ((addr & 3) if nbytes == 1 else (addr & 2)) * 8
        mask = ((1 << (nbytes * 8)) - 1) << sh
        w = (w & ~mask) | ((_u32(val) << sh) & mask)
        self._store_word(addr & ~3, w)

    def format_trace(self) -> str:
        """Disassembled dump of the retired-instruction ring (requires
        trace_len > 0 at construction)."""
        return "\n".join(f"pc={pc:#07x} word {pc >> 2:4d}: {disasm(w)}"
                         for pc, w in self.trace)

    def step(self):
        # clamp-on-read fetch, mirroring jax gather semantics in the jnp
        # steppers (only reachable with a faulted pc — §9.14; fault-free
        # programs never leave the code image)
        widx = self.pc >> 2
        widx = 0 if widx < 0 else min(widx, len(self.code) - 1)
        self.visited.add(widx)
        instr = int(self.code[widx])
        if self._trace_len:
            self.trace.append((self.pc, instr))
            if len(self.trace) > self._trace_len:
                del self.trace[0]
        op = instr & 0x7F
        rd = (instr >> 7) & 0x1F
        f3 = (instr >> 12) & 0x7
        rs1 = (instr >> 15) & 0x1F
        rs2 = (instr >> 20) & 0x1F
        f7 = (instr >> 25) & 0x7F
        imm_i = _sx(instr >> 20, 12)
        imm_s = _sx(((instr >> 25) << 5) | ((instr >> 7) & 0x1F), 12)
        imm_b = _sx((((instr >> 31) & 1) << 12) | (((instr >> 7) & 1) << 11)
                    | (((instr >> 25) & 0x3F) << 5)
                    | (((instr >> 8) & 0xF) << 1), 13)
        imm_u = _s32(instr & 0xFFFFF000)
        imm_j = _sx((((instr >> 31) & 1) << 20)
                    | (((instr >> 12) & 0xFF) << 12)
                    | (((instr >> 20) & 1) << 11)
                    | (((instr >> 21) & 0x3FF) << 1), 21)
        a = _s32(self.regs[rs1 & 0xF])
        b = _s32(self.regs[rs2 & 0xF])
        next_pc = self.pc + 4
        wr = None
        name = "?"
        taken = False          # branch condition held (dynamic timing)
        shamt = 0              # serial shift amount (dynamic timing)

        if op == isa.OP_LUI:
            wr, name = imm_u, "lui"
        elif op == isa.OP_AUIPC:
            wr, name = _s32(self.pc + imm_u), "auipc"
        elif op == isa.OP_JAL:
            wr, name = self.pc + 4, "jal"
            next_pc = self.pc + imm_j
        elif op == isa.OP_JALR:
            wr, name = self.pc + 4, "jalr"
            next_pc = _u32(a + imm_i) & ~1
        elif op == isa.OP_BRANCH:
            cond = {0: a == b, 1: a != b, 4: a < b, 5: a >= b,
                    6: _u32(a) < _u32(b), 7: _u32(a) >= _u32(b)}[f3]
            name = {0: "beq", 1: "bne", 4: "blt", 5: "bge", 6: "bltu",
                    7: "bgeu"}[f3]
            taken = bool(cond)
            if cond:
                next_pc = self.pc + imm_b
        elif op == isa.OP_LOAD:
            addr = _u32(a + imm_i)
            if f3 == 0:
                wr, name = self._load_sub(addr, 1, True), "lb"
            elif f3 == 1:
                wr, name = self._load_sub(addr, 2, True), "lh"
            elif f3 == 2:
                wr, name = self._load_word(addr), "lw"
            elif f3 == 4:
                wr, name = self._load_sub(addr, 1, False), "lbu"
            elif f3 == 5:
                wr, name = self._load_sub(addr, 2, False), "lhu"
        elif op == isa.OP_STORE:
            addr = _u32(a + imm_s)
            if f3 == 0:
                self._store_sub(addr, 1, b)
                name = "sb"
            elif f3 == 1:
                self._store_sub(addr, 2, b)
                name = "sh"
            else:
                self._store_word(addr, b)
                name = "sw"
        elif op == isa.OP_IMM:
            if f3 == 0:
                wr, name = _s32(a + imm_i), "addi"
            elif f3 == 1:
                shamt = imm_i & 31
                wr, name = _s32(a << shamt), "slli"
            elif f3 == 2:
                wr, name = int(a < imm_i), "slti"
            elif f3 == 3:
                wr, name = int(_u32(a) < _u32(imm_i)), "sltiu"
            elif f3 == 4:
                wr, name = _s32(a ^ imm_i), "xori"
            elif f3 == 5:
                shamt = imm_i & 31
                if f7 & 0x20:
                    wr, name = a >> shamt, "srai"
                else:
                    wr, name = _s32(_u32(a) >> shamt), "srli"
            elif f3 == 6:
                wr, name = _s32(a | imm_i), "ori"
            elif f3 == 7:
                wr, name = _s32(a & imm_i), "andi"
        elif op == isa.OP_REG:
            sub = bool(f7 & 0x20)
            if f3 == 0:
                wr, name = _s32(a - b if sub else a + b), \
                    ("sub" if sub else "add")
            elif f3 == 1:
                shamt = b & 31
                wr, name = _s32(a << shamt), "sll"
            elif f3 == 2:
                wr, name = int(a < b), "slt"
            elif f3 == 3:
                wr, name = int(_u32(a) < _u32(b)), "sltu"
            elif f3 == 4:
                wr, name = _s32(a ^ b), "xor"
            elif f3 == 5:
                shamt = b & 31
                if sub:
                    wr, name = a >> shamt, "sra"
                else:
                    wr, name = _s32(_u32(a) >> shamt), "srl"
            elif f3 == 6:
                wr, name = _s32(a | b), "or"
            elif f3 == 7:
                wr, name = _s32(a & b), "and"
        elif op == isa.OP_SYSTEM:
            name = "ecall"
            self.halted = True
        else:
            raise ValueError(f"bad opcode {op:#x} at pc={self.pc}")

        if wr is not None and (rd & 0xF) != 0:
            self.regs[rd & 0xF] = _s32(wr)
        self.pc = next_pc
        self.n_instr += 1
        self.mix[name] = self.mix.get(name, 0) + 1
        two = name in isa.TWO_STAGE
        if two:
            self.n_two_stage += 1

        # ---- timing events (mirror of iss.dynamic_terms/timing_ticks)
        subword = name in _SUBWORD_NAMES
        cls = (_N_MIX if two else 0) + _MIX_IDX[isa.MIX_CATEGORY[name]]
        self.events[cls] += 1
        if taken:
            self.events[TAKEN_IDX] += 1
        self.events[SHIFT_IDX] += shamt
        if subword:
            self.events[SUBWORD_IDX] += 1
        if self.cost is not None:
            ticks = int(self.cost[cls])
            if taken:
                ticks += int(self.cost[TAKEN_IDX])
            ticks += shamt * int(self.cost[SHIFT_IDX])
            if subword:
                ticks += int(self.cost[SUBWORD_IDX])
            # the steppers tally in int32; wrap identically
            self.n_cycles = _s32(self.n_cycles + ticks)

        if self.post_commit is not None and not self.halted:
            self.post_commit(self)

    def ticks(self, cost: np.ndarray) -> int:
        """Total ticks under `cost` from the recorded events (exact,
        no wrap) — prices one run on any core after the fact."""
        return int(np.asarray(cost, np.int64) @ self.events)

    def run(self, max_steps: int = 10_000_000):
        while not self.halted and self.n_instr < max_steps:
            self.step()
        return self
