"""Flash attention: the CUDA kernel, its wrapper and its plain version.

`flash_attention` (csrc/flash_attention.cu) replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention`: causal or full
online-softmax attention over heads flattened into the batch, q, k, v
(BH, L, D), float32 arithmetic, the output in q's type. For a causal
mask the TPU kernel reads, for query tile qi of tq rows, the KV tiles of
tk keys below clamp((qi + 1) tq // tk, 1, L // tk), and inside them the
keys kpos <= qpos: the kernel and the plain version keep that bound.
The GQA grouping is done by `kernels/ops.py` before flattening. For
bfloat16 the kernel multiplies on the tensor cores, with float32 scores,
softmax and accumulator, and rounds P to bfloat16 for the P v product:
the one rounding the plain version lacks (within a bfloat16 step).

`flash_attention_plain` is the TPU kernel's arithmetic tile by tile in
eager torch (any device). The wrapper takes `device=None` (meaning
"cuda"): on a CUDA device it launches the kernel on the current stream
or raises; only for CPU tensors does it run the plain version. It
counts `.launches` and `.plain_calls`; `reset_counts()` zeroes both.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build
from repro_torch.kernels.iss_stepper import _check, _raise_on

NEG_INF = -1e30
F32 = torch.float32
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True, tq: int = 128,
                          tk: int = 128) -> torch.Tensor:
    """The TPU kernel's tiles, running max, denominator and accumulator,
    tile by tile, batched over BH."""
    bh, l, d = q.shape
    scale = d ** -0.5
    qf = q.to(F32) * scale
    kf, vf = k.to(F32), v.to(F32)
    n_kv = l // tk
    dev = q.device
    out = torch.empty((bh, l, d), dtype=q.dtype, device=dev)
    for qi in range(l // tq):
        qt = qf[:, qi * tq:(qi + 1) * tq]
        m = torch.full((bh, tq, 1), NEG_INF, dtype=F32, device=dev)
        den = torch.zeros((bh, tq, 1), dtype=F32, device=dev)
        acc = torch.zeros((bh, tq, d), dtype=F32, device=dev)
        upper = min(max((qi + 1) * tq // tk, 1), n_kv) if causal else n_kv
        for ki in range(upper):
            kt = kf[:, ki * tk:(ki + 1) * tk]
            vt = vf[:, ki * tk:(ki + 1) * tk]
            s = qt @ kt.transpose(1, 2)
            if causal:
                qpos = qi * tq + torch.arange(tq, device=dev)[:, None]
                kpos = ki * tk + torch.arange(tk, device=dev)[None, :]
                s = torch.where(kpos <= qpos, s,
                                torch.full((), NEG_INF, device=dev))
            m2 = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2)
            den = den * corr + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * corr + p @ vt
            m = m2
        out[:, qi * tq:(qi + 1) * tq] = (
            acc / torch.clamp_min(den, 1e-30)).to(q.dtype)
    return out


def flash_attention(q, k, v, *, causal: bool = True, tq: int = 128,
                    tk: int = 128, device: DeviceLike = None
                    ) -> torch.Tensor:
    """q, k, v: (BH, L, D), heads pre-flattened into the batch dim.

    Returns (BH, L, D) in q's dtype. L must divide by tq and tk."""
    dev = resolve(device)
    bh, l, d = q.shape
    if l % tq or l % tk:
        raise ValueError(f"L = {l} must divide by tq = {tq} and tk = {tk}")
    if dev.type == "cpu":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device.type != "cpu":
                raise ValueError(f"{name} is on {t.device}, expected cpu")
        flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, causal=causal, tq=tq, tk=tk)
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}: float32 or bfloat16")
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes 1 to 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev, q.dtype, (bh, l, d))
    o = torch.empty_like(q)
    fn = getattr(_build.load("flash_attention"), "flash_attention_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), bh, l, d, int(causal), tq, tk,
                d ** -0.5, stream)
    _raise_on(rc, "flash_attention launch")
    flash_attention.launches += 1
    return o


def reset_counts() -> None:
    """Zero the wrapper's launch and plain-call counts."""
    flash_attention.launches = 0
    flash_attention.plain_calls = 0


reset_counts()
