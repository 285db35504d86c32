"""Public wrappers around the LM kernels (shape plumbing, GQA grouping,
plane packing), in the reference's layouts: (B, L, H, D) for attention,
(Bt, H, L, P) for the SSD scan. Each takes `device=None` (the card) and
passes it to its kernel's wrapper, which runs the plain version only on
the CPU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike
from repro_torch.kernels import ref as R
from repro_torch.kernels.bitplane_matmul import bitplane_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan


def quantized_linear(x, w, *, bits: int = 8, tm: int = 128, tn: int = 128,
                     tk: int = 128, device: DeviceLike = None):
    """x: (..., K) @ w: (K, N) through the bit-plane kernel."""
    planes, scales, _ = R.quantize_weights(w, bits)
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    m = xm.shape[0]
    pad = (-m) % tm
    if pad:
        xm = F.pad(xm, (0, 0, 0, pad))
    out = bitplane_matmul(xm.contiguous(), planes, scales, bits=bits, tm=tm,
                          tn=tn, tk=tk, device=device)
    return out[:m].reshape(*lead, w.shape[1])


def gqa_flash_attention(q, k, v, *, causal: bool = True, tq: int = 128,
                        tk: int = 128, window: int = 0,
                        device: DeviceLike = None):
    """q: (B, L, H, D); k/v: (B, L, Hkv, D) -> (B, L, H, D); `window`: the
    sliding window of a local layer (0: none)."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, l, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, l, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, l, d).contiguous()
    o = flash_attention(qf, kf, vf, causal=causal, tq=min(tq, l),
                        tk=min(tk, l), window=window, device=device)
    return o.reshape(b, h, l, d).transpose(1, 2)


def ssd(x, dt, A, B, C, *, q: int = 64, return_state: bool = False,
        device: DeviceLike = None):
    """x: (Bt, H, L, P); dt: (Bt, H, L); A: (H,); B/C: (Bt, G, L, N) with
    G dividing H. Returns y: (Bt, H, L, P), and with `return_state` also
    the state after the last step, (Bt, H, N, P) float32."""
    bt, h, l, p = x.shape
    g, n = B.shape[1], B.shape[-1]
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    y, state = ssd_scan(
        A.to(torch.float32).repeat(bt),
        x.reshape(bt * h, l, p).contiguous(),
        dt.to(torch.float32).reshape(bt * h, l).contiguous(),
        B.reshape(bt * g, l, n).contiguous(),
        C.reshape(bt * g, l, n).contiguous(),
        q=min(q, l), rep=h // g, device=device)
    y = y.reshape(bt, h, l, p)
    if return_state:
        return y, state.reshape(bt, h, n, p)
    return y
