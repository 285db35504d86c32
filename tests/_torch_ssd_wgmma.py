"""Rounding model of the bfloat16 scan forward on wgmma
(csrc/ssd_scan.cu's `ssd_fwd_wgmma`), in eager torch on any device, with
no JAX: `tests/test_torch_ssd_wgmma.py` and
`tests/test_torch_lm_tensor_cores.py` hold it to the plain version and to
the reference on the CPU, `tests/test_torch_gpu.py` holds the kernel to
it on the card.
"""
from __future__ import annotations

import torch

F32, BF16 = torch.float32, torch.bfloat16
LOG2E = 1.4426950408889634
TILE = 64  # rows of a chunk's tile


def _bf16(t):
    return t.to(BF16).to(F32)


def ssd_wgmma_emulation(a, x, dt, b, c, *, q, rep=1, return_states=False):
    """(y in x's type, final state float32[, states]) as the kernel
    computes them: every head through its chunks; per chunk log2 e times
    the cumsum of dt a (each exponential an exp2) and w_j = 2^(cum_Q -
    cum_j) dt_j; per 64-row tile i of the chunk y = 2^cum_i (C_i S_b) with
    S_b the state rounded to bfloat16 (none at chunk 0), then per 64-row
    tile j <= i: G = C_i B_j^T in float32, W = G 2^(cum_i - cum_j) dt_j
    (j <= i on the diagonal tile) rounded to bfloat16, y += W x_j; then
    the state S <- 2^cum_Q S + sum_j (B_j w_j rounded to bfloat16)^T x_j,
    float32 over the chunks, and with `return_states` S before each chunk
    c >= 1 (BH, L // q - 1, N, P). Float32 sums. The kernel's 64-column
    slices of P and the wrapper's zero columns change nothing here."""
    bh, l, p = x.shape
    n = b.shape[-1]
    dev = x.device
    bm = b.to(F32).repeat_interleave(rep, dim=0)
    cm = c.to(F32).repeat_interleave(rep, dim=0)
    xf, dtf, af = x.to(F32), dt.to(F32), a.to(F32)
    y = torch.empty((bh, l, p), dtype=x.dtype, device=dev)
    state = torch.zeros((bh, n, p), dtype=F32, device=dev)
    states = []
    for c0 in range(0, l, q):
        if c0:
            states.append(state)
        rows = slice(c0, c0 + q)
        d = dtf[:, rows]
        cum = torch.cumsum(d * af[:, None], dim=-1) * LOG2E       # (BH, Q)
        cq = cum[:, -1:]
        sb = _bf16(state)
        for i0 in range(0, q, TILE):
            ri = slice(i0, min(i0 + TILE, q))
            ci = cm[:, c0 + ri.start:c0 + ri.stop]
            if c0:
                acc = torch.exp2(cum[:, ri])[:, :, None] * (ci @ sb)
            else:
                acc = torch.zeros((bh, ri.stop - i0, p), device=dev)
            for j0 in range(0, i0 + 1, TILE):
                rj = slice(j0, min(j0 + TILE, q))
                g = ci @ bm[:, c0 + rj.start:c0 + rj.stop].transpose(1, 2)
                arg = cum[:, ri, None] - cum[:, None, rj]
                if j0 == i0:        # the diagonal tile: j <= i
                    keep = (torch.arange(rj.start, rj.stop, device=dev)[None]
                            <= torch.arange(ri.start, ri.stop,
                                            device=dev)[:, None])
                    arg = torch.where(keep, arg, torch.zeros((), device=dev))
                    w = torch.where(keep, g * torch.exp2(arg)
                                    * d[:, None, rj], 0.0)
                else:
                    w = g * torch.exp2(arg) * d[:, None, rj]
                acc = acc + _bf16(w) @ xf[:, c0 + rj.start:c0 + rj.stop]
            y[:, c0 + ri.start:c0 + ri.stop] = acc.to(x.dtype)
        w_st = torch.exp2(cq - cum) * d                          # (BH, Q)
        upd = torch.zeros_like(state)
        for j0 in range(0, q, TILE):
            rj = slice(c0 + j0, c0 + min(j0 + TILE, q))
            bw = _bf16(bm[:, rj] * w_st[:, j0:j0 + TILE, None])
            upd = upd + bw.transpose(1, 2) @ xf[:, rj]
        state = (state * torch.exp2(cq)[:, :, None] if c0 else state) + upd
    if not return_states:
        return y, state
    saved = (torch.stack(states, dim=1) if states else
             torch.zeros((bh, 0, n, p), dtype=F32, device=dev))
    return y, state, saved
