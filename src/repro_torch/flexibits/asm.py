"""RV32E assembler eDSL.

The paper compiles C with the RISC-V GNU toolchain; this container has no
offline toolchain, so FlexiBench workloads are written against this small
assembler instead (DESIGN.md §8.2). It provides labels, pseudo-ops and the
software multiply/divide routines (RV32E has no M extension — multiplies are
shift-add loops, exactly the behavior the paper characterizes in §3.2.2).

Memory map (word-addressed data RAM, byte addresses):
  0x0000.. : data RAM (inputs, globals, scratch)    [VM]
  ROM      : program words + constant words          [NVM]
Constants are placed in a read-only segment appended after the data image;
`Program.nvm_words`/`vm_bytes` feed the Table-3 memory profile.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.flexibits import isa

# Canonical RV32E register display names, indexed by register number.
REG_NAMES = ("zero", "ra", "sp", "gp", "tp", "t0", "t1", "t2",
             "s0", "s1", "a0", "a1", "a2", "a3", "a4", "a5")

# A decoded instruction word in *canonical operand form*: the exact
# (name, rd, rs1, rs2, imm) tuple that `isa.encode` accepts, chosen so
# `isa.encode(*d) == word` for every decodable word (register fields not
# used by the format are zeroed; immediates are sign-extended the way the
# steppers see them; shift immediates are the 5-bit shamt).
Decoded = collections.namedtuple("Decoded", "name rd rs1 rs2 imm")

_R_BY_KEY = {(f3, f7): n for n, (_, f3, f7) in isa.R_OPS.items()}
_SHIFT_BY_KEY = {(f3, f7): n for n, (_, f3, f7) in isa.SHIFT_OPS.items()}
_I_BY_KEY = {(op, f3): n for n, (op, f3) in isa.I_OPS.items()}
_S_BY_F3 = {f3: n for n, (_, f3) in isa.S_OPS.items()}
_B_BY_F3 = {f3: n for n, (_, f3) in isa.B_OPS.items()}
_LOAD_NAMES = frozenset(("lb", "lh", "lw", "lbu", "lhu"))


def _sx(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def decode(word: int) -> Optional[Decoded]:
    """Word -> canonical `Decoded`, or None for words outside the ISA
    (unknown opcode, non-canonical funct3/funct7). Round-trip property:
    `isa.encode(*decode(w)) == w` whenever decode(w) is not None."""
    w = int(word) & 0xFFFFFFFF
    op = w & 0x7F
    rd = (w >> 7) & 0x1F
    f3 = (w >> 12) & 0x7
    rs1 = (w >> 15) & 0x1F
    rs2 = (w >> 20) & 0x1F
    f7 = (w >> 25) & 0x7F
    if op == isa.OP_REG:
        name = _R_BY_KEY.get((f3, f7))
        return None if name is None else Decoded(name, rd, rs1, rs2, 0)
    if op == isa.OP_IMM and f3 in (1, 5):
        name = _SHIFT_BY_KEY.get((f3, f7))
        # shamt lives in the rs2 field
        return None if name is None else Decoded(name, rd, rs1, 0, rs2)
    if op in (isa.OP_IMM, isa.OP_JALR, isa.OP_LOAD):
        name = _I_BY_KEY.get((op, f3))
        return None if name is None \
            else Decoded(name, rd, rs1, 0, _sx(w >> 20, 12))
    if op == isa.OP_STORE:
        name = _S_BY_F3.get(f3)
        return None if name is None \
            else Decoded(name, 0, rs1, rs2, _sx(((w >> 25) << 5) | rd, 12))
    if op == isa.OP_BRANCH:
        name = _B_BY_F3.get(f3)
        if name is None:
            return None
        imm = _sx((((w >> 31) & 1) << 12) | (((w >> 7) & 1) << 11)
                  | (((w >> 25) & 0x3F) << 5) | (((w >> 8) & 0xF) << 1), 13)
        return Decoded(name, 0, rs1, rs2, imm)
    if op == isa.OP_LUI:
        return Decoded("lui", rd, 0, 0, (w >> 12) & 0xFFFFF)
    if op == isa.OP_AUIPC:
        return Decoded("auipc", rd, 0, 0, (w >> 12) & 0xFFFFF)
    if op == isa.OP_JAL:
        imm = _sx((((w >> 31) & 1) << 20) | (((w >> 12) & 0xFF) << 12)
                  | (((w >> 20) & 1) << 11) | (((w >> 21) & 0x3FF) << 1), 21)
        return Decoded("jal", rd, 0, 0, imm)
    if op == isa.OP_SYSTEM:
        if w == isa.encode("ecall"):
            return Decoded("ecall", 0, 0, 0, 0)
        if w == isa.encode("ebreak"):
            return Decoded("ebreak", 0, 0, 0, 0)
        return None
    return None


def _reg(r: int) -> str:
    return REG_NAMES[r] if r < len(REG_NAMES) else f"x{r}"


def disasm(word: int) -> str:
    """Word -> one-line mnemonic/operand string (FlexiLint diagnostics,
    PyISS trace dumps). Undecodable words render as `.word 0x........`."""
    d = decode(word)
    if d is None:
        return f".word 0x{int(word) & 0xFFFFFFFF:08x}"
    n = d.name
    if n in isa.R_OPS:
        return f"{n} {_reg(d.rd)}, {_reg(d.rs1)}, {_reg(d.rs2)}"
    if n in isa.SHIFT_OPS:
        return f"{n} {_reg(d.rd)}, {_reg(d.rs1)}, {d.imm}"
    if n in _LOAD_NAMES or n == "jalr":
        return f"{n} {_reg(d.rd)}, {d.imm}({_reg(d.rs1)})"
    if n in isa.I_OPS:
        return f"{n} {_reg(d.rd)}, {_reg(d.rs1)}, {d.imm}"
    if n in isa.S_OPS:
        return f"{n} {_reg(d.rs2)}, {d.imm}({_reg(d.rs1)})"
    if n in isa.B_OPS:
        return f"{n} {_reg(d.rs1)}, {_reg(d.rs2)}, pc{d.imm:+d}"
    if n in ("lui", "auipc"):
        return f"{n} {_reg(d.rd)}, 0x{d.imm:05x}"
    if n == "jal":
        return f"jal {_reg(d.rd)}, pc{d.imm:+d}"
    return n                                    # ecall / ebreak


@dataclasses.dataclass
class Program:
    code: np.ndarray            # uint32 instruction words
    names: List[str]            # mnemonic per instruction (for mix stats)
    ro_base: int                # byte address where constants start
    ro_words: np.ndarray        # int32 read-only constant words
    vm_reserved: int            # bytes of RAM reserved (inputs+globals)
    labels: Dict[str, int]
    # word index of a loop header -> max executions of that header per
    # program entry (FlexiLint WCET annotations, DESIGN.md §9.11)
    loop_bounds: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def nvm_bytes(self) -> int:
        """Program + constants (paper: .text + .rodata)."""
        return 4 * (len(self.code) + len(self.ro_words))

    def initial_memory(self, mem_words: int) -> np.ndarray:
        mem = np.zeros(mem_words, np.int32)
        ro = self.ro_base // 4
        assert ro + len(self.ro_words) <= mem_words, "constants overflow RAM"
        mem[ro:ro + len(self.ro_words)] = self.ro_words
        return mem


class Asm:
    """Builder: emit instructions, labels, and constant data."""

    def __init__(self, vm_reserved: int = 0):
        self._instrs: List[Tuple] = []       # (name, rd, rs1, rs2, imm|label)
        self._labels: Dict[str, int] = {}
        self._consts: List[int] = []
        self._vm_reserved = vm_reserved
        self._uniq = 0
        self._loop_bounds: Dict[str, int] = {}   # label -> max executions

    def loop_bound(self, label: str, max_iters: int):
        """Annotate `label` (a loop header) with its maximum number of
        executions per program entry. FlexiLint uses these bounds for
        loops whose trip count it cannot infer from counter idioms
        (DESIGN.md §9.11); unannotated uninferable loops make the WCET
        unbounded."""
        assert max_iters >= 1, max_iters
        self._loop_bounds[label] = int(max_iters)

    # ---- registers by ABI name
    def __getattr__(self, item):
        if item in isa.ABI:
            return isa.ABI[item]
        raise AttributeError(item)

    def uniq(self, prefix="L") -> str:
        self._uniq += 1
        return f"{prefix}_{self._uniq}"

    def label(self, name: str):
        self._labels[name] = len(self._instrs)

    def emit(self, name, rd=0, rs1=0, rs2=0, imm=0):
        self._instrs.append((name, rd, rs1, rs2, imm))

    # ---- raw instructions
    def add(self, rd, rs1, rs2):
        self.emit("add", rd, rs1, rs2)

    def sub(self, rd, rs1, rs2):
        self.emit("sub", rd, rs1, rs2)

    def sll(self, rd, rs1, rs2):
        self.emit("sll", rd, rs1, rs2)

    def srl(self, rd, rs1, rs2):
        self.emit("srl", rd, rs1, rs2)

    def sra(self, rd, rs1, rs2):
        self.emit("sra", rd, rs1, rs2)

    def slt(self, rd, rs1, rs2):
        self.emit("slt", rd, rs1, rs2)

    def sltu(self, rd, rs1, rs2):
        self.emit("sltu", rd, rs1, rs2)

    def xor(self, rd, rs1, rs2):
        self.emit("xor", rd, rs1, rs2)

    def or_(self, rd, rs1, rs2):
        self.emit("or", rd, rs1, rs2)

    def and_(self, rd, rs1, rs2):
        self.emit("and", rd, rs1, rs2)

    def addi(self, rd, rs1, imm):
        assert -2048 <= imm < 2048, imm
        self.emit("addi", rd, rs1, imm=imm)

    def slti(self, rd, rs1, imm):
        self.emit("slti", rd, rs1, imm=imm)

    def xori(self, rd, rs1, imm):
        self.emit("xori", rd, rs1, imm=imm)

    def ori(self, rd, rs1, imm):
        self.emit("ori", rd, rs1, imm=imm)

    def andi(self, rd, rs1, imm):
        self.emit("andi", rd, rs1, imm=imm)

    def slli(self, rd, rs1, imm):
        self.emit("slli", rd, rs1, imm=imm)

    def srli(self, rd, rs1, imm):
        self.emit("srli", rd, rs1, imm=imm)

    def srai(self, rd, rs1, imm):
        self.emit("srai", rd, rs1, imm=imm)

    def lw(self, rd, rs1, imm=0):
        self.emit("lw", rd, rs1, imm=imm)

    def sw(self, rs2, rs1, imm=0):
        self.emit("sw", 0, rs1, rs2, imm)

    def lui(self, rd, imm):
        self.emit("lui", rd, imm=imm)

    def beq(self, rs1, rs2, label):
        self.emit("beq", 0, rs1, rs2, label)

    def bne(self, rs1, rs2, label):
        self.emit("bne", 0, rs1, rs2, label)

    def blt(self, rs1, rs2, label):
        self.emit("blt", 0, rs1, rs2, label)

    def bge(self, rs1, rs2, label):
        self.emit("bge", 0, rs1, rs2, label)

    def bltu(self, rs1, rs2, label):
        self.emit("bltu", 0, rs1, rs2, label)

    def bgeu(self, rs1, rs2, label):
        self.emit("bgeu", 0, rs1, rs2, label)

    def jal(self, rd, label):
        self.emit("jal", rd, imm=label)

    def jalr(self, rd, rs1, imm=0):
        self.emit("jalr", rd, rs1, imm=imm)

    def ecall(self):
        self.emit("ecall")

    # ---- pseudo-ops
    def li(self, rd, value: int):
        value &= 0xFFFFFFFF
        if value >= 0x80000000:
            value -= 1 << 32
        if -2048 <= value < 2048:
            self.addi(rd, 0, value)
            return
        upper = (value + 0x800) >> 12
        lower = value - (upper << 12)
        self.lui(rd, upper & 0xFFFFF)
        if lower:
            self.addi(rd, rd, lower)

    def mv(self, rd, rs):
        self.addi(rd, rs, 0)

    def j(self, label):
        self.jal(0, label)

    def call(self, label):
        self.jal(1, label)          # ra = x1

    def ret(self):
        self.jalr(0, 1, 0)

    def halt(self):
        self.ecall()

    # ---- constant data segment
    def const_words(self, values) -> int:
        """Append int32 words to the read-only segment; returns word offset
        within the segment (byte address resolved at assembly)."""
        off = len(self._consts)
        self._consts.extend(int(v) for v in np.asarray(values, np.int64))
        return off

    def la_const(self, rd, word_offset: int):
        """Load address of constant segment + word offset (resolved late)."""
        self.emit("__la_const", rd, imm=word_offset)

    # ---- software multiply: a0 = a0 * a1 (signed, 32-bit wrap)
    # Registers t0..t2 clobbered. Shift-add, ~32 iterations.
    def emit_mul_routine(self):
        self.label("__mul")
        self.mv(self.t0, self.a0)       # multiplicand
        self.mv(self.t1, self.a1)       # multiplier
        self.li(self.a0, 0)
        loop = "__mul_loop"
        done = "__mul_done"
        skip = "__mul_skip"
        # 32 multiplier bits + the final zero-test pass
        self.loop_bound(loop, 33)
        self.label(loop)
        self.beq(self.t1, self.zero, done)
        self.andi(self.t2, self.t1, 1)
        self.beq(self.t2, self.zero, skip)
        self.add(self.a0, self.a0, self.t0)
        self.label(skip)
        self.slli(self.t0, self.t0, 1)
        self.srli(self.t1, self.t1, 1)
        self.j(loop)
        self.label(done)
        self.ret()

    def mul(self, rd, rs1, rs2):
        """Call the software multiply (must emit_mul_routine once)."""
        self.mv(self.a0, rs1)
        self.mv(self.a1, rs2)
        self.call("__mul")
        if rd != isa.ABI["a0"]:
            self.mv(rd, self.a0)

    # ---- assemble
    def assemble(self, ro_base: Optional[int] = None) -> Program:
        if ro_base is None:
            ro_base = self._vm_reserved
        ro_base = -(-ro_base // 4) * 4
        code = []
        names = []
        resolved: List[Tuple] = []
        # first expand __la_const into li (needs final addresses — two-pass
        # with fixed expansion size: li = lui+addi always (2 instrs))
        expanded: List[Tuple] = []
        label_pos: Dict[str, int] = {}
        # pass 1: compute positions with fixed sizes
        pos = 0
        pending = dict(self._labels)
        # labels were recorded by instruction index; recompute by walking
        idx2pos: List[int] = []
        for ins in self._instrs:
            idx2pos.append(pos)
            pos += 2 if ins[0] == "__la_const" else 1
        final_labels = {k: idx2pos[v] if v < len(idx2pos) else pos
                        for k, v in pending.items()}
        # pass 2: emit
        for name, rd, rs1, rs2, imm in self._instrs:
            if name == "__la_const":
                addr = ro_base + 4 * imm
                upper = ((addr + 0x800) >> 12) & 0xFFFFF
                lower = addr - ((addr + 0x800) >> 12 << 12)
                expanded.append(("lui", rd, 0, 0, upper))
                expanded.append(("addi", rd, rd, 0, lower))
            else:
                expanded.append((name, rd, rs1, rs2, imm))
        for i, (name, rd, rs1, rs2, imm) in enumerate(expanded):
            if isinstance(imm, str):
                target = final_labels[imm]
                offset = (target - i) * 4
                imm = offset
            if name in ("addi",) and not (-2048 <= imm < 2048):
                raise ValueError(f"addi imm out of range at {i}: {imm}")
            code.append(isa.encode(name, rd, rs1, rs2, imm))
            names.append(name)
        loop_bounds = {final_labels[lbl]: b
                       for lbl, b in self._loop_bounds.items()
                       if lbl in final_labels}
        return Program(
            code=np.asarray(code, np.uint32),
            names=names,
            ro_base=ro_base,
            ro_words=np.asarray(self._consts, np.int32),
            vm_reserved=self._vm_reserved,
            labels=final_labels,
            loop_bounds=loop_bounds,
        )
