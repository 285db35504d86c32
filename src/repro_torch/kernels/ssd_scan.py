"""Mamba2 SSD chunked scan: the CUDA kernel, its wrapper and its plain
version.

`ssd_scan` (csrc/ssd_scan.cu) replaces the TPU kernel
`repro/kernels/ssd_scan.py::ssd_scan`: per (batch, head) row and chunk
of q steps, the decay-masked intra-chunk `C B^T` term plus the
contribution of the (N, P) state carried across the chunks in order,
reset at chunk 0. Beside y it returns the carried state after the last
chunk (the TPU kernel's scratch at its end), which prefill hands to
decode. The D residual and the gating stay outside. With bfloat16
inputs the kernel multiplies on the tensor cores, with C B^T formed once
for the heads of a group that a block runs; with float32 inputs on the
CUDA cores (see the source's header).

Layout: a (BH,), x (BH, L, P), dt (BH, L), b, c (BH // rep, L, N): row
bh reads B and C row bh // rep, so the heads of a group share their
group's rows (with rep = 1 this is the TPU kernel's per-head layout).

`ssd_scan_plain` is the TPU kernel's per-chunk arithmetic in eager torch
(any device). The wrapper takes `device=None` (meaning "cuda"): on a
CUDA device it launches the kernel on the current stream or raises;
only for CPU tensors does it run the plain version. The plain version is
differentiable; on the card a launch whose inputs need a gradient goes
through `_grad.NoBackward`, so a backward through it raises
NotImplementedError (no backward kernel yet, open item 13b-ii) instead
of leaving the parameters upstream without a gradient. It counts
`.launches` and `.plain_calls`; `reset_counts()` zeroes both.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build
from repro_torch.kernels._grad import NoBackward, needs_grad
from repro_torch.kernels.iss_stepper import _check, _raise_on

F32 = torch.float32
_DTYPES = (torch.float32, torch.bfloat16)
NO_BACKWARD = ("ssd_scan has no backward kernel yet: a loss through the "
               "scan trains on the CPU only (ROADMAP.md, open item 13b-ii)")


def ssd_scan_plain(a, x, dt, b, c, *, q: int = 64, rep: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's chunk step, batched over BH, chunk by chunk.
    Returns (y (BH, L, P) in x's dtype, state (BH, N, P) float32)."""
    bh, l, p = x.shape
    n = b.shape[-1]
    dev = x.device
    bf = b.repeat_interleave(rep, dim=0) if rep > 1 else b
    cf = c.repeat_interleave(rep, dim=0) if rep > 1 else c
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    neg_inf = torch.full((), float("-inf"), device=dev)
    state = torch.zeros((bh, n, p), dtype=F32, device=dev)
    av = a.to(F32)[:, None]
    ys = []
    for ci in range(l // q):
        sl = slice(ci * q, (ci + 1) * q)
        xs = x[:, sl].to(F32)                             # (BH, Q, P)
        dts = dt[:, sl].to(F32)                           # (BH, Q)
        bm = bf[:, sl].to(F32)                            # (BH, Q, N)
        cm = cf[:, sl].to(F32)
        cum = torch.cumsum(dts * av, dim=-1)              # (BH, Q)
        seg_end = cum[:, -1:]
        decay = cum[:, :, None] - cum[:, None, :]         # (BH, Q, Q)
        lmat = torch.exp(torch.where(causal, decay, neg_inf))
        w = (cm @ bm.transpose(1, 2)) * lmat * dts[:, None, :]
        y = w @ xs
        y = y + torch.exp(cum)[:, :, None] * (cm @ state)
        wstate = torch.exp(seg_end - cum) * dts           # (BH, Q)
        s_new = (bm * wstate[:, :, None]).transpose(1, 2) @ xs
        state = state * torch.exp(seg_end)[:, :, None] + s_new
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), state


def ssd_scan(a, x, dt, b, c, *, q: int = 64, rep: int = 1,
             device: DeviceLike = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (BH,) per-head A; x: (BH, L, P); dt: (BH, L); b, c:
    (BH // rep, L, N). Returns (y (BH, L, P) in x's dtype, final state
    (BH, N, P) float32). L must divide by q."""
    dev = resolve(device)
    bh, l, p = x.shape
    n = b.shape[-1]
    if l % q:
        raise ValueError(f"L = {l} must divide by q = {q}")
    if rep < 1 or bh % rep:
        raise ValueError(f"BH = {bh} must divide by rep = {rep}")
    if dev.type == "cpu":
        for name, t in (("a", a), ("x", x), ("dt", dt), ("b", b), ("c", c)):
            if t.device.type != "cpu":
                raise ValueError(f"{name} is on {t.device}, expected cpu")
        ssd_scan.plain_calls += 1
        return ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep)
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}: float32 or bfloat16")
    if not (1 <= p <= 128 and 1 <= n <= 128):
        raise ValueError(f"P = {p}, N = {n}: the kernel takes 1 to 128")
    for name, t, dtype, shape in (
            ("a", a, F32, (bh,)), ("x", x, x.dtype, (bh, l, p)),
            ("dt", dt, F32, (bh, l)), ("b", b, x.dtype, (bh // rep, l, n)),
            ("c", c, x.dtype, (bh // rep, l, n))):
        _check(name, t, dev, dtype, shape)

    def launch(a, x, dt, b, c):
        y = torch.empty_like(x)
        s_final = torch.empty((bh, n, p), dtype=F32, device=dev)
        fn = getattr(_build.load("ssd_scan"), "ssd_scan_launch")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(int(x.dtype == torch.bfloat16), a.data_ptr(),
                    x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                    y.data_ptr(), s_final.data_ptr(), bh, l, p, n, q, rep,
                    stream)
        _raise_on(rc, "ssd_scan launch")
        ssd_scan.launches += 1
        return y, s_final

    if needs_grad(a, x, dt, b, c):
        return NoBackward.apply(NO_BACKWARD, launch, a, x, dt, b, c)
    return launch(a, x, dt, b, c)


def reset_counts() -> None:
    """Zero the wrapper's launch and plain-call counts."""
    ssd_scan.launches = 0
    ssd_scan.plain_calls = 0


reset_counts()
