"""uint32 arithmetic over int32 tensors.

The reference keeps RV32E state in int32 and reinterprets it as uint32
(`iss._u`) for logical shifts, unsigned compares and wrapping products.
torch has no general uint32 arithmetic, and its `>>` on int32 is an
arithmetic shift (`-1 >> 1 == -1`), so the port spells those operations
out here. Every helper takes and returns int32 tensors holding the same
32-bit patterns the reference holds. Sums and products are formed in
int64, where they cannot overflow, and narrowed back to int32: signed
overflow is undefined behaviour in C++, but narrowing an integer keeps
its low 32 bits (modular under GCC, Clang and NVCC, and guaranteed from
C++20 on), so no result depends on how a backend treats overflow.
"""
from __future__ import annotations

import torch

I32 = torch.int32
_MASK = 0xFFFFFFFF
_SIGN = 1 << 31


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int32 holding its low 32 bits."""
    return x.to(I32)


def wadd(a, b) -> torch.Tensor:
    """a + b modulo 2**32 (RV32E add; int32 in, int32 out)."""
    return wrap(torch.as_tensor(a).to(torch.int64) + b)


def wsub(a, b) -> torch.Tensor:
    """a - b modulo 2**32."""
    return wrap(torch.as_tensor(a).to(torch.int64) - b)


def wmul(a, b) -> torch.Tensor:
    """a * b modulo 2**32 (an int32 x int32 product fits int64)."""
    return wrap(torch.as_tensor(a).to(torch.int64) * b)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of an int32 bit pattern, as int64."""
    return x.to(torch.int64) & _MASK


def srl(x: torch.Tensor, sh) -> torch.Tensor:
    """Logical right shift of the uint32 pattern by `sh` (0..31)."""
    return wrap(as_u32(x) >> sh)


def sll(x, sh) -> torch.Tensor:
    """Left shift modulo 2**32 by `sh` (0..31)."""
    return wrap(torch.as_tensor(x).to(torch.int64) << sh)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b: flipping the sign bit maps uint32 order onto
    int32 order."""
    return (a ^ -_SIGN) < (b ^ -_SIGN)


def uge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a >= b."""
    return ~ult(a, b)


def sx(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Sign-extend the low `bits` bits of `v`, for 0 <= v < 2**bits
    (every caller passes an extracted bit field)."""
    return v - ((v >> (bits - 1)) & 1) * (1 << bits)
