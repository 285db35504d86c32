"""Bit-plane matmul: the CUDA kernel, its wrapper and its plain version.

`bitplane_matmul` (csrc/bitplane_matmul.cu) replaces the TPU kernel
`repro/kernels/bitplane_matmul.py::bitplane_matmul`, FLEXIBITS' bit-serial
datapath as bit-plane decomposition: weights quantized to B bits are
stored as B binary int8 planes (B, K, N) plus per-column scales, and

    x @ W = s * (sum_b 2^b (x @ u_b) - 2^(B-1) * rowsum(x)) = s * (x @ W_q)

with a float32 accumulator, the output in x's dtype. The kernel and the
plain version reassemble W_q from the planes (exact) and multiply once,
as the reference's oracle does; the TPU kernel runs one pass per plane.

`bitplane_matmul_plain` runs in eager torch (any device). The wrapper
takes `device=None` (meaning "cuda"): on a CUDA device it launches the
kernel on the current stream or raises; only for CPU tensors does it run
the plain version. It counts `.launches` and `.plain_calls`;
`reset_counts()` zeroes both.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build
from repro_torch.kernels.iss_stepper import _check, _raise_on
from repro_torch.kernels.ref import bitplane_matmul_ref

_DTYPES = (torch.float32, torch.bfloat16)

bitplane_matmul_plain = bitplane_matmul_ref


def bitplane_matmul(x, planes, scales, *, bits: int, tm: int = 128,
                    tn: int = 128, tk: int = 128,
                    device: DeviceLike = None) -> torch.Tensor:
    """x: (M, K) float; planes: (B, K, N) int8 of {0,1}; scales: (N,).

    Returns (M, N) in x.dtype. M/K/N must divide by the tile sizes (the
    TPU kernel's grid; the CUDA kernel masks ragged edges itself)."""
    dev = resolve(device)
    m, k = x.shape
    bts, kk, n = planes.shape
    if bts != bits or kk != k:
        raise ValueError(f"planes {tuple(planes.shape)} do not match "
                         f"bits = {bits}, K = {k}")
    if m % tm or n % tn or k % tk:
        raise ValueError(f"M, N, K = {m}, {n}, {k} must divide by the "
                         f"tiles {tm}, {tn}, {tk}")
    if dev.type == "cpu":
        for name, t in (("x", x), ("planes", planes), ("scales", scales)):
            if t.device.type != "cpu":
                raise ValueError(f"{name} is on {t.device}, expected cpu")
        bitplane_matmul.plain_calls += 1
        return bitplane_matmul_plain(x, planes, scales, bits=bits)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}: float32 or bfloat16")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits = {bits}: the kernel takes 1 to 8")
    for name, t, dtype, shape in (
            ("x", x, x.dtype, (m, k)), ("planes", planes, torch.int8,
                                        (bits, k, n)),
            ("scales", scales, torch.float32, (n,))):
        _check(name, t, dev, dtype, shape)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    fn = getattr(_build.load("bitplane_matmul"), "bitplane_matmul_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(x.dtype == torch.bfloat16), x.data_ptr(),
                planes.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n,
                bits, stream)
    _raise_on(rc, "bitplane_matmul launch")
    bitplane_matmul.launches += 1
    return out


def reset_counts() -> None:
    """Zero the wrapper's launch and plain-call counts."""
    bitplane_matmul.launches = 0
    bitplane_matmul.plain_calls = 0


reset_counts()
