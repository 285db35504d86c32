"""Bit-plane matmul: the CUDA kernel, its wrapper and its plain version.

`bitplane_matmul` (csrc/bitplane_matmul.cu) replaces the TPU kernel
`repro/kernels/bitplane_matmul.py::bitplane_matmul`, FLEXIBITS' bit-serial
datapath as bit-plane decomposition: weights quantized to B bits are
stored as B binary int8 planes (B, K, N) plus per-column scales, and

    x @ W = s * (sum_b 2^b (x @ u_b) - 2^(B-1) * rowsum(x)) = s * (x @ W_q)

with a float32 accumulator, the output in x's dtype. The kernel and the
plain version reassemble W_q from the planes (exact) and multiply once,
as the reference's oracle does; the TPU kernel runs one pass per plane.
For bfloat16 x the kernel runs in two phases, one launch of the C entry:
`bitplane_repack` writes W_q as bfloat16 (exact, |W_q| <= 128) to a
scratch this wrapper allocates, and `bitplane_gemm` multiplies x by it
on the tensor cores; both are also callable alone, with their plain
versions, for the tests and the timings. For float32 x it is one kernel
on the CUDA cores.

`*_plain` run in eager torch (any device). Each wrapper takes
`device=None` (meaning "cuda"): on a CUDA device it launches its kernel
on the current stream or raises; only for CPU tensors does it run the
plain version. The plain versions are differentiable; on the card a
`bitplane_matmul` launch whose x or scales need a gradient goes through
`_grad.NoBackward`, so a backward through it raises NotImplementedError
(no model trains through the bit planes). Each counts `.launches` and
`.plain_calls`; `reset_counts()` zeroes them all.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build
from repro_torch.kernels._grad import NoBackward, needs_grad
from repro_torch.kernels.iss_stepper import _check, _on_cpu, _raise_on
from repro_torch.kernels.ref import bitplane_matmul_ref

F32 = torch.float32
NO_BACKWARD = ("bitplane_matmul has no backward kernel: the bit planes "
               "serve quantized weights and no model trains through them")
_DTYPES = (F32, torch.bfloat16)

bitplane_matmul_plain = bitplane_matmul_ref


def bitplane_repack_plain(planes, *, bits: int) -> torch.Tensor:
    """W_q = sum_b 2^b u_b - 2^(B-1) as bfloat16 (K, N), exact."""
    u = torch.zeros(planes.shape[1:], dtype=torch.int32, device=planes.device)
    for b in range(bits):
        u += planes[b].to(torch.int32) << b
    return (u - 2 ** (bits - 1)).to(torch.bfloat16)


def bitplane_gemm_plain(x, w_q, scales) -> torch.Tensor:
    """(x @ W_q) * s in float32, rounded to x's type."""
    return ((x.to(F32) @ w_q.to(F32)) * scales[None, :]).to(x.dtype)


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits = {bits}: the kernel takes 1 to 8")


def _check_tma(k: int, n: int) -> None:
    if k % 8 or n % 8:
        raise ValueError(f"K, N = {k}, {n}: the bfloat16 kernel's TMA loads "
                         f"need multiples of 8 (16-byte rows)")


def _launch(sym: str, dev, *args) -> None:
    fn = getattr(_build.load("bitplane_matmul"), sym)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    _raise_on(rc, sym.replace("_launch", " launch"))


def bitplane_repack(planes, *, bits: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """planes (B, K, N) int8 -> W_q (K, N) bfloat16: the bfloat16 path's
    first phase alone."""
    dev = resolve(device)
    bts, k, n = planes.shape
    if bts != bits:
        raise ValueError(f"planes {tuple(planes.shape)} do not match "
                         f"bits = {bits}")
    if dev.type == "cpu":
        _on_cpu(planes=planes)
        bitplane_repack.plain_calls += 1
        return bitplane_repack_plain(planes, bits=bits)
    _check_bits(bits)
    _check("planes", planes, dev, torch.int8, (bits, k, n))
    w_q = torch.empty((k, n), dtype=torch.bfloat16, device=dev)
    _launch("bitplane_repack_launch", dev, planes.data_ptr(), w_q.data_ptr(),
            k, n, bits)
    bitplane_repack.launches += 1
    return w_q


def bitplane_gemm(x, w_q, scales, *, device: DeviceLike = None
                  ) -> torch.Tensor:
    """x (M, K) bfloat16 @ W_q (K, N) bfloat16, times scales (N,) ->
    (M, N) bfloat16: the bfloat16 path's second phase alone."""
    dev = resolve(device)
    m, k = x.shape
    n = w_q.shape[1]
    if dev.type == "cpu":
        _on_cpu(x=x, w_q=w_q, scales=scales)
        bitplane_gemm.plain_calls += 1
        return bitplane_gemm_plain(x, w_q, scales)
    _check_tma(k, n)
    for name, t, dtype, shape in (
            ("x", x, torch.bfloat16, (m, k)),
            ("w_q", w_q, torch.bfloat16, (k, n)),
            ("scales", scales, F32, (n,))):
        _check(name, t, dev, dtype, shape)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    _launch("bitplane_gemm_launch", dev, x.data_ptr(), w_q.data_ptr(),
            scales.data_ptr(), out.data_ptr(), m, k, n)
    bitplane_gemm.launches += 1
    return out


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
        _on_cpu(x=x, planes=planes, scales=scales)
        bitplane_matmul.plain_calls += 1
        return bitplane_matmul_plain(x, planes, scales, bits=bits)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}: float32 or bfloat16")
    _check_bits(bits)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _check_tma(k, n)
    for name, t, dtype, shape in (
            ("x", x, x.dtype, (m, k)), ("planes", planes, torch.int8,
                                        (bits, k, n)),
            ("scales", scales, F32, (n,))):
        _check(name, t, dev, dtype, shape)

    def launch(x, scales):
        out = torch.empty((m, n), dtype=x.dtype, device=dev)
        # the repacked weight, scratch of the bfloat16 path's two phases
        w_q = torch.empty((k, n) if bf16 else (0,), dtype=torch.bfloat16,
                          device=dev)
        _launch("bitplane_matmul_launch", dev, int(bf16), x.data_ptr(),
                planes.data_ptr(), scales.data_ptr(), w_q.data_ptr(),
                out.data_ptr(), m, k, n, bits)
        bitplane_matmul.launches += 1
        return out

    if needs_grad(x, scales):
        return NoBackward.apply(NO_BACKWARD, launch, x, scales)
    return launch(x, scales)


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-call counts."""
    for fn in (bitplane_matmul, bitplane_repack, bitplane_gemm):
        fn.launches = 0
        fn.plain_calls = 0


reset_counts()
