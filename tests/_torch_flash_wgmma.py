"""A rounding model of the bfloat16 flash forward kernel for head dims
above 128 (`flash_fwd_wgmma` in csrc/flash_attention.cu), in eager torch
on any device, with no JAX: `tests/test_torch_flash_wgmma.py` holds it
to the plain version and to the reference on the CPU,
`tests/test_torch_gpu.py` holds the kernel to it on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as pfa

F32, BF16 = torch.float32, torch.bfloat16
LOG2E = 1.4426950408889634
ROWS, HALF, KEYS = 128, 64, 64  # a block's query rows, a warpgroup's, a tile's keys


def key_limit(qp, l, causal, tq, tk):
    """The TPU kernel's upper key limit of query row qp (0 past L)."""
    if qp >= l:
        return 0
    if not causal:
        return l
    up = min(max((qp // tq + 1) * tq // tk, 1), l // tk)
    return min(qp + 1, up * tk)


def key_lower(qp, window, tq, tk):
    """The lower key limit of query row qp under a sliding window."""
    if not window:
        return 0
    return max(qp - window + 1, max(qp // tq - window // tk, 0) * tk)


def flash_wgmma_emulation(q, k, v, *, causal=True, tq=128, tk=128,
                          window=0, return_lse=False):
    """o (and the log-sum-exp) as the kernel computes them: q, k, v
    zero-padded to a multiple of 8 columns by the wrapper's own
    `wgmma_operand`, the scale the true D's; blocks of 128 query rows,
    each half of 64 rows walking its own 64-key tiles from the one
    holding its first row's lower key limit to its last row's upper one;
    per tile float32 S = q k^T of the bfloat16 values, masked outside
    each row's limits, the running max, P = exp2(S scale log2 e - m scale
    log2 e) in float32 against it, the denominator from float32 P, P
    rounded to bfloat16 for P v, float32 sums; o = acc / max(den, 1e-30)
    in q's type, sliced back to D."""
    bh, l, d = q.shape
    sl2 = d ** -0.5 * LOG2E
    qf, kf, vf = (pfa.wgmma_operand(t).to(F32) for t in (q, k, v))
    out = torch.zeros((bh, l, qf.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, l), dtype=F32, device=q.device)
    for q0 in range(0, l, ROWS):
        for r0 in range(q0, min(q0 + ROWS, l), HALF):
            rows = range(r0, min(r0 + HALF, l))
            sl = slice(r0, rows.stop)
            lim = torch.tensor([key_limit(r, l, causal, tq, tk)
                                for r in rows], device=q.device)[:, None]
            lo = torch.tensor([key_lower(r, window, tq, tk) for r in rows],
                              device=q.device)[:, None]
            m = torch.full((bh, len(rows), 1), -math.inf, device=q.device)
            den = torch.zeros((bh, len(rows), 1), device=q.device)
            acc = torch.zeros((bh, len(rows), qf.shape[-1]), device=q.device)
            for k0 in range(int(lo[0]) // KEYS * KEYS, int(lim[-1]), KEYS):
                kt, vt = kf[:, k0:k0 + KEYS], vf[:, k0:k0 + KEYS]
                s = qf[:, sl] @ kt.transpose(1, 2)
                keys = k0 + torch.arange(kt.shape[1], device=q.device)
                s = torch.where((keys < lim) & (keys >= lo), s,
                                torch.full((), -math.inf, device=q.device))
                m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                base = torch.where(m2 == -math.inf, 0.0, m2 * sl2)
                corr = torch.exp2(m * sl2 - base)
                p = torch.exp2(s * sl2 - base)
                den = den * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + p.to(BF16).to(F32) @ vt
                m = m2
            den = den.clamp_min(1e-30)
            out[:, sl] = (acc / den).to(q.dtype)
            lse[:, sl] = ((m * sl2 + torch.log2(den)) * math.log(2))[..., 0]
    out = out[..., :d]
    return (out, lse) if return_lse else out
