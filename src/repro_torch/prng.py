"""JAX's threefry2x32 random bits, reproduced in torch without JAX.

The reference draws its Monte Carlo scenarios with `jax.random` under
JAX's default PRNG (`threefry2x32`, `jax_threefry_partitionable` on).
The port reproduces those bits exactly, so the two packages sweep the
same scenarios:

- `prng_key(seed, x64)` is `jax.random.PRNGKey(seed)`. The key depends
  on whether JAX runs with x64: without it the seed is an int32 and the
  key is `(0, seed mod 2**32)`; with it (every float64 sweep) the seed
  is an int64 and the key is its two 32-bit halves.
- `fold_in(key, data)` is `jax.random.fold_in`: `threefry2x32(key,
  (0, data))`, vectorised over a tensor of `data`.
- `uniform(key, n, dtype)` is `jax.random.uniform(key, (n,), dtype)`,
  vectorised over a batch of keys: the uniform at flat index `i` hashes
  the counter `(i >> 32, i & 0xffffffff)` and keeps the top mantissa
  bits (float32: 23 bits of `w0 ^ w1`; float64: 52 bits of
  `w0 << 32 | w1`) over an exponent of 1, minus 1.0.

uint32 words are held in int64 tensors and masked after every add and
shift (the idiom of `_u32.py`), so nothing depends on how a backend
treats integer overflow. The same functions serve any per-lane key
(the fault schedules' `lane_keys` is `fold_in` of a seed key by lane).
"""
from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE = 0x3F800000
_F64_ONE = 0x3FF0000000000000

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> Key:
    """The Threefry-2x32 hash (20 rounds) of counters (x0, x1) under key
    (k0, k1); all four are uint32 values held in int64 (tensors that
    broadcast, or ints). Returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & _MASK
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, x64: bool) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)` as two uint32 words. `x64` says whether
    JAX would run with 64-bit types (as every float64 sweep does)."""
    seed = int(seed)
    if x64:
        return (seed >> 32) & _MASK, seed & _MASK
    return 0, seed & _MASK


def fold_in(key, data: torch.Tensor) -> Key:
    """`jax.random.fold_in(key, d)` for every d in `data` (integers in
    [0, 2**32)): one key, as two int64 word tensors, per element."""
    k0, k1 = key
    data = torch.as_tensor(data).to(torch.int64) & _MASK
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def uniform(key: Key, n: int, dtype: torch.dtype) -> torch.Tensor:
    """`jax.random.uniform(k, (n,), dtype)` in [0, 1) for each key k of a
    batch: `key` is two word tensors of one shape S, the result has shape
    S + (n,). Reshape it to a (…, n // m, m) draw row by row, as JAX
    lays out a shaped draw."""
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64)[..., None] for k in key)
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    w0, w1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    if dtype == torch.float32:
        bits = ((w0 ^ w1) >> 9) | _F32_ONE
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # the top 52 of the 64 bits w0 << 32 | w1, formed without
        # shifting past bit 62 of an int64
        bits = (w0 << 20) | (w1 >> 12) | _F64_ONE
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"uniform draws are float32 or float64, not {dtype}")
