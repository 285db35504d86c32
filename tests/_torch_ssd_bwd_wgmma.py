"""A rounding model of the bfloat16 SSD scan backward kernel
(`ssd_bwd_wgmma` in csrc/ssd_scan.cu), in eager torch on any device, with
no JAX: `tests/test_torch_ssd_bwd_wgmma.py` holds it to the plain version
and to the reference on the CPU, `tests/test_torch_gpu.py` holds the
kernel to it on the card.
"""
from __future__ import annotations

import torch

F32, BF16 = torch.float32, torch.bfloat16
LOG2E = 1.4426950408889634


def _rb(t):
    """One bfloat16 step of t's value, back in float32."""
    return t.to(BF16).to(F32)


def _split(t):
    """t as two bfloat16 terms, hi + lo (about 2^-16 of its value)."""
    hi = _rb(t)
    return hi + _rb(t - hi)


def ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, ds, q, rep,
                            heads_per_block):
    """(da, dx, ddt, db, dc) as the bfloat16 backward kernel computes
    them. Blocks of `heads_per_block` heads of one group (ceil(rep /
    heads_per_block) blocks a group, the last taking the rest); the chunks
    from the last to the first; the cumsum kept times log2 e (each
    exponential an exp2); float32 everywhere but the roundings the
    source's header lists: W as the operand of W^T dy; the block's heads'
    dG summed in float32 (in head order) and rounded once for dG^T C and
    dG B; w_j x_j and dS for dB's state term; 2^cum_i dy_i and S_c for
    dC's; and, as two bfloat16 terms (hi + lo), dS for B dS, S_c for C
    S_c and 2^cum_i C_i for (2^cum_i C_i)^T dy (the products that reach
    ddt and da). dB and dC are a block's sums over its heads, summed over
    a group's blocks in order, then rounded to bfloat16. Inputs as
    `ssd_scan_bwd`'s; `ds` may be None (zero)."""
    bh, l, p = x.shape
    groups, _, n = b.shape
    sets = -(-rep // heads_per_block)
    nh = -(-rep // sets)
    dev = x.device
    dx = torch.empty((bh, l, p), dtype=F32, device=dev)
    ddt = torch.empty((bh, l), dtype=F32, device=dev)
    da = torch.zeros((bh,), dtype=F32, device=dev)
    db = torch.zeros((groups, l, n), dtype=F32, device=dev)
    dc = torch.zeros((groups, l, n), dtype=F32, device=dev)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    for grp in range(groups):
        for st in range(sets):
            heads = [grp * rep + r
                     for r in range(st * nh, min((st + 1) * nh, rep))]
            d_s = {h: (torch.zeros((n, p), dtype=F32, device=dev)
                       if ds is None else ds[h].to(F32)) for h in heads}
            dbp = torch.zeros((l, n), dtype=F32, device=dev)
            dcp = torch.zeros((l, n), dtype=F32, device=dev)
            for ci in reversed(range(l // q)):
                sl = slice(ci * q, (ci + 1) * q)
                bm, cm = b[grp, sl].to(F32), c[grp, sl].to(F32)
                g = cm @ bm.T                   # C_i . B_j, once a block
                dgsum = torch.zeros((q, q), dtype=F32, device=dev)
                dbc = torch.zeros((q, n), dtype=F32, device=dev)
                dcc = torch.zeros((q, n), dtype=F32, device=dev)
                for h in heads:
                    xs, dys = x[h, sl].to(F32), dy[h, sl].to(F32)
                    dts = dt[h, sl].to(F32)
                    cum = torch.cumsum(dts * a[h].to(F32), 0) * LOG2E
                    arg = torch.where(causal, cum[:, None] - cum[None, :], 0.0)
                    lmat = torch.where(causal, torch.exp2(arg), 0.0)
                    w = g * lmat * dts[None, :]
                    dwm = dys @ xs.T
                    dxc = _rb(w).T @ dys
                    dgsum = dgsum + dwm * lmat * dts[None, :]
                    ww = dwm * w
                    dcum = ww.sum(1) - ww.sum(0)
                    ddtc = (dwm * g * lmat).sum(0)
                    # the state update's terms
                    ej = torch.exp2(cum[-1] - cum)
                    wst = ej * dts
                    u = bm @ _split(d_s[h])
                    dxc = dxc + wst[:, None] * u
                    dbc = dbc + _rb(wst[:, None] * xs) @ _rb(d_s[h]).T
                    dw = (u * xs).sum(1)
                    ddtc = ddtc + ej * dw
                    dcum = dcum - wst * dw
                    dcum[-1] += (wst * dw).sum()
                    if ci:
                        sc = states[h, ci - 1].to(F32)
                        ecum = torch.exp2(cum)
                        dcc = dcc + _rb(ecum[:, None] * dys) @ _rb(sc).T
                        dcum = dcum + ecum * (dys * (cm @ _split(sc))).sum(1)
                        eq = torch.exp2(cum[-1])
                        dcum[-1] += eq * (sc * d_s[h]).sum()
                        d_s[h] = (eq * d_s[h]
                                  + _split(ecum[:, None] * cm).T @ dys)
                    dda = torch.flip(torch.cumsum(torch.flip(dcum, (0,)), 0),
                                     (0,))
                    ddt[h, sl] = ddtc + a[h].to(F32) * dda
                    da[h] += (dts * dda).sum()
                    dx[h, sl] = dxc
                dgb = _rb(dgsum)                # the block's sum, rounded once
                dbp[sl] = dbc + dgb.T @ cm
                dcp[sl] = dcc + dgb @ bm
            db[grp] += dbp                      # the group's blocks in order
            dc[grp] += dcp
    return da, dx.to(x.dtype), ddt, db.to(b.dtype), dc.to(c.dtype)
