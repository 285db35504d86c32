"""RV32E instruction encoding/decoding tables.

RV32E = RV32I with 16 registers (x0..x15). We implement the full base
integer set the paper's workloads use (no M/F/D extensions — multiplies are
software shift-add routines, as in the paper §3.2.1).

Instruction classes for the bit-serial cycle model (paper §4.2):
  one-stage: R-type, most I-type ALU ops         (32/w + a_w cycles)
  two-stage: loads/stores/jumps/branches/shifts/slt (64/w + b_w cycles)
"""
from __future__ import annotations

from typing import Dict, Tuple

# opcode constants
OP_LUI = 0b0110111
OP_AUIPC = 0b0010111
OP_JAL = 0b1101111
OP_JALR = 0b1100111
OP_BRANCH = 0b1100011
OP_LOAD = 0b0000011
OP_STORE = 0b0100011
OP_IMM = 0b0010011
OP_REG = 0b0110011
OP_SYSTEM = 0b1110011

ABI = {
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
    "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
    "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
}

# name -> (opcode, funct3, funct7 or None)
R_OPS = {
    "add": (OP_REG, 0b000, 0b0000000), "sub": (OP_REG, 0b000, 0b0100000),
    "sll": (OP_REG, 0b001, 0b0000000), "slt": (OP_REG, 0b010, 0b0000000),
    "sltu": (OP_REG, 0b011, 0b0000000), "xor": (OP_REG, 0b100, 0b0000000),
    "srl": (OP_REG, 0b101, 0b0000000), "sra": (OP_REG, 0b101, 0b0100000),
    "or": (OP_REG, 0b110, 0b0000000), "and": (OP_REG, 0b111, 0b0000000),
}
I_OPS = {
    "addi": (OP_IMM, 0b000), "slti": (OP_IMM, 0b010),
    "sltiu": (OP_IMM, 0b011), "xori": (OP_IMM, 0b100),
    "ori": (OP_IMM, 0b110), "andi": (OP_IMM, 0b111),
    "jalr": (OP_JALR, 0b000),
    "lb": (OP_LOAD, 0b000), "lh": (OP_LOAD, 0b001), "lw": (OP_LOAD, 0b010),
    "lbu": (OP_LOAD, 0b100), "lhu": (OP_LOAD, 0b101),
}
SHIFT_OPS = {
    "slli": (OP_IMM, 0b001, 0b0000000),
    "srli": (OP_IMM, 0b101, 0b0000000),
    "srai": (OP_IMM, 0b101, 0b0100000),
}
S_OPS = {"sb": (OP_STORE, 0b000), "sh": (OP_STORE, 0b001),
         "sw": (OP_STORE, 0b010)}
B_OPS = {"beq": (OP_BRANCH, 0b000), "bne": (OP_BRANCH, 0b001),
         "blt": (OP_BRANCH, 0b100), "bge": (OP_BRANCH, 0b101),
         "bltu": (OP_BRANCH, 0b110), "bgeu": (OP_BRANCH, 0b111)}

# two-stage instruction names (paper §4.2): loads, stores, jumps, branches,
# shifts, set-less-than.
TWO_STAGE = (set(S_OPS) | set(B_OPS) | set(SHIFT_OPS)
             | {"lb", "lh", "lw", "lbu", "lhu", "jal", "jalr",
                "slt", "sltu", "slti", "sltiu", "sll", "srl", "sra"})

# instruction-mix categories for the Fig. 2a reproduction
MIX_CATEGORY = {}
for _n in R_OPS:
    MIX_CATEGORY[_n] = "shifts" if _n in ("sll", "srl", "sra") else "R-type"
for _n in ("addi", "slti", "sltiu", "xori", "ori", "andi"):
    MIX_CATEGORY[_n] = "I-type"
for _n in SHIFT_OPS:
    MIX_CATEGORY[_n] = "shifts"
for _n in ("lb", "lh", "lw", "lbu", "lhu"):
    MIX_CATEGORY[_n] = "loads"
for _n in S_OPS:
    MIX_CATEGORY[_n] = "stores"
for _n in B_OPS:
    MIX_CATEGORY[_n] = "branches"
for _n in ("jal", "jalr"):
    MIX_CATEGORY[_n] = "jumps"
MIX_CATEGORY["lui"] = "I-type"
MIX_CATEGORY["auipc"] = "I-type"
MIX_CATEGORY["ecall"] = "system"


def _imm_i(v: int) -> int:
    return (v & 0xFFF) << 20


def encode(name: str, rd=0, rs1=0, rs2=0, imm=0) -> int:
    if name in R_OPS:
        op, f3, f7 = R_OPS[name]
        return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) \
            | (rd << 7) | op
    if name in SHIFT_OPS:
        op, f3, f7 = SHIFT_OPS[name]
        return (f7 << 25) | ((imm & 0x1F) << 20) | (rs1 << 15) | (f3 << 12) \
            | (rd << 7) | op
    if name in I_OPS:
        op, f3 = I_OPS[name]
        return _imm_i(imm) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op
    if name in S_OPS:
        op, f3 = S_OPS[name]
        lo = imm & 0x1F
        hi = (imm >> 5) & 0x7F
        return (hi << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) \
            | (lo << 7) | op
    if name in B_OPS:
        op, f3 = B_OPS[name]
        b12 = (imm >> 12) & 1
        b11 = (imm >> 11) & 1
        b10_5 = (imm >> 5) & 0x3F
        b4_1 = (imm >> 1) & 0xF
        return (b12 << 31) | (b10_5 << 25) | (rs2 << 20) | (rs1 << 15) \
            | (f3 << 12) | (b4_1 << 8) | (b11 << 7) | op
    if name == "lui":
        return ((imm & 0xFFFFF) << 12) | (rd << 7) | OP_LUI
    if name == "auipc":
        return ((imm & 0xFFFFF) << 12) | (rd << 7) | OP_AUIPC
    if name == "jal":
        b20 = (imm >> 20) & 1
        b10_1 = (imm >> 1) & 0x3FF
        b11 = (imm >> 11) & 1
        b19_12 = (imm >> 12) & 0xFF
        return (b20 << 31) | (b10_1 << 21) | (b11 << 20) | (b19_12 << 12) \
            | (rd << 7) | OP_JAL
    if name == "ecall":
        return OP_SYSTEM
    if name == "ebreak":
        return (1 << 20) | OP_SYSTEM
    raise ValueError(f"unknown instruction {name!r}")


ALL_OPS: Tuple[str, ...] = tuple(
    list(R_OPS) + list(I_OPS) + list(SHIFT_OPS) + list(S_OPS) + list(B_OPS)
    + ["lui", "auipc", "jal", "ecall", "ebreak"])
