"""Plain torch oracles of the LM kernels (the reference's `kernels/ref.py`):
the targets the kernels and their plain versions are held to."""
from __future__ import annotations

import torch

F32 = torch.float32


# ------------------------------------------------------- bitplane matmul

def quantize_weights(w: torch.Tensor, bits: int):
    """Symmetric per-output-channel quantization. w: (K, N) float.

    Returns (planes (B, K, N) int8 of {0,1}, scales (N,) float32,
    w_q (K, N) int32)."""
    amax = torch.amax(torch.abs(w), dim=0)
    qmax = max(2.0 ** (bits - 1) - 1, 1.0)   # bits=1: levels {-1, 0}
    scales = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w / scales), -(2 ** (bits - 1)),
                      2 ** (bits - 1) - 1).to(torch.int32)
    u = w_q + 2 ** (bits - 1)                  # in [0, 2^bits): no sign
    planes = torch.stack([((u >> b) & 1).to(torch.int8)
                          for b in range(bits)])
    return planes, scales.to(F32), w_q


def bitplane_matmul_ref(x, planes, scales, *, bits: int):
    """Oracle: reassemble W_q from planes, dense matmul, scale."""
    weights = torch.zeros(planes.shape[1:], dtype=F32, device=x.device)
    for b in range(bits):
        weights += (2.0 ** b) * planes[b].to(F32)
    weights -= 2.0 ** (bits - 1)
    out = (x.to(F32) @ weights) * scales[None, :]
    return out.to(x.dtype)


# ------------------------------------------------------- flash attention

def attention_ref(q, k, v, *, causal: bool = True):
    """q,k,v: (B, H, L, D). fp32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) * (d ** -0.5)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        mask = torch.tril(torch.ones((lq, lk), dtype=torch.bool,
                                     device=s.device))
        s = torch.where(mask, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)


# ------------------------------------------------------------- ssd scan

def ssd_ref(x, dt, A, B, C):
    """Sequential SSD recurrence oracle. x: (Bt, H, L, P); dt: (Bt, H, L);
    A: (H,); B, C: (Bt, H, L, N). Returns (y, final_state (Bt,H,N,P))."""
    bt, h, l, p = x.shape
    n = B.shape[-1]
    s = torch.zeros((bt, h, n, p), dtype=F32, device=x.device)
    ys = []
    xf, dtf, Bf, Cf = x.to(F32), dt.to(F32), B.to(F32), C.to(F32)
    A = A.to(F32)
    for t in range(l):
        da = torch.exp(dtf[:, :, t] * A[None, :])
        s = s * da[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhnp", dtf[:, :, t], Bf[:, :, t], xf[:, :, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, :, t], s))
    y = torch.stack(ys, dim=2)                    # (bt,h,l,p)
    return y.to(x.dtype), s
