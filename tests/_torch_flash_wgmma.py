"""Rounding models of the bfloat16 flash kernels on wgmma
(csrc/flash_attention.cu): the forward `flash_fwd_wgmma`
(`flash_wgmma_emulation`) and the backward pair `flash_bwd_dq_wgmma` and
`flash_bwd_dkdv_wgmma` (`flash_bwd_wgmma_emulation`), every bfloat16
head dim, in eager torch on any device, with no JAX:
`tests/test_torch_flash_wgmma.py`, `tests/test_torch_flash_bwd_wgmma.py`
and `tests/test_torch_flash_bwd.py` hold them to the plain versions and
to the reference on the CPU, `tests/test_torch_gpu.py` and
`chip_smoke.py` hold the kernels to them on the card.
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


def _query_tiles(k0, l, causal, tq, tk, window):
    """The 64-query tiles the dK/dV pass walks for keys k0.. k0 + 63:
    from the first whose last row's upper key limit passes k0 to the
    last whose first row's lower limit is below k0 + 64."""
    n_qt = -(-l // KEYS)
    first = 0
    while first < n_qt and key_limit(min((first + 1) * KEYS, l) - 1, l,
                                     causal, tq, tk) <= k0:
        first += 1
    last = n_qt - 1
    while last >= first and key_lower(last * KEYS, window, tq,
                                      tk) >= k0 + KEYS:
        last -= 1
    return range(first, last + 1)


def flash_bwd_wgmma_emulation(q, k, v, o, do, lse, *, causal=True, tq=128,
                              tk=128, window=0):
    """dq, dk, dv as the kernels compute them: q, k, v, o and dO
    zero-padded to a multiple of 8 columns by `wgmma_operand`, the scale
    the true D's; D = rowsum(dO o) in float32. Per 64-key tile, float32
    S = q k^T of the bfloat16 values, P = exp2(S scale log2 e - lse log2
    e) in float32, 0 outside each row's limits, dS = P (dP - D) rounded
    to bfloat16 for dS k. The dQ pass at D <= 128 (the builds of 64 and
    128 columns): blocks of 128 query rows, each warpgroup's 64 summing
    every key of the block's 64-key tiles into one float32 sum; dq =
    scale sum. Past 128: blocks of 64 rows walking the block's tiles,
    each tile in two halves of 32 keys (the warpgroups), each half with
    its own float32 sum; dq = scale (sum_0 + sum_1). The dK/dV pass:
    each 64 keys (a warpgroup's of a 128-key block at D <= 128, a 64-key
    block past it) over their 64-query tiles; P^T in float32 (in the
    warpgroup's registers, or the one warpgroup 0 hands to warpgroup 1),
    rounded to bfloat16 for dV += P^T dO, and dS^T = P^T (dP^T - D) from
    it, rounded for dK += dS^T q; dk = scale dK. A tile outside every
    limit of a warpgroup's rows or keys adds zeros, so the model walks
    only the tiles each 64 rows or keys reach. Outputs in q's type,
    sliced back to D."""
    bh, l, d = q.shape
    dev = q.device
    scale = d ** -0.5
    sl2 = scale * LOG2E
    qf, kf, vf, of, dof = (pfa.wgmma_operand(t).to(F32)
                           for t in (q, k, v, o, do))
    narrow = qf.shape[-1] <= 128
    dsum = (dof * of).sum(-1)
    ls = lse.to(F32) * LOG2E
    lim = torch.tensor([key_limit(r, l, causal, tq, tk) for r in range(l)],
                       device=dev)
    lo = torch.tensor([key_lower(r, window, tq, tk) for r in range(l)],
                      device=dev)
    kpos = torch.arange(l, device=dev)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(qf)
    dv = torch.zeros_like(qf)

    def p_of(s, rows, keys):
        """P of the (rows x keys) scores s, masked."""
        p = torch.exp2(s * sl2 - ls[:, rows, None])
        keep = ((kpos[None, keys] < lim[rows, None])
                & (kpos[None, keys] >= lo[rows, None]))
        return torch.where(keep, p, torch.zeros((), device=dev))

    def ds_k(rows, keys):
        """dS k of the rows against the keys, dS rounded to bfloat16."""
        s = qf[:, rows] @ kf[:, keys].transpose(1, 2)
        ds = p_of(s, rows, keys) * (dof[:, rows] @ vf[:, keys].transpose(1, 2)
                                    - dsum[:, rows, None])
        return ds.to(BF16).to(F32) @ kf[:, keys]

    for q0 in range(0, l, HALF):
        # a warpgroup's 64 rows (D <= 128) or a 64-row block
        rows = slice(q0, min(q0 + HALF, l))
        kend = key_limit(rows.stop - 1, l, causal, tq, tk)
        tiles = range(key_lower(q0, window, tq, tk) // KEYS * KEYS, kend,
                      KEYS)
        if narrow:
            acc = torch.zeros_like(qf[:, rows])
            for k0 in tiles:
                acc += ds_k(rows, slice(k0, min(k0 + KEYS, l)))
        else:
            sums = [torch.zeros_like(qf[:, rows]) for _ in range(2)]
            for k0 in tiles:
                for c in range(2):
                    sums[c] += ds_k(rows, slice(min(k0 + 32 * c, l),
                                                min(k0 + 32 * c + 32, l)))
            acc = sums[0] + sums[1]
        dq[:, rows] = acc * scale
    for k0 in range(0, l, KEYS):
        keys = slice(k0, min(k0 + KEYS, l))
        for t in _query_tiles(k0, l, causal, tq, tk, window):
            rows = slice(t * KEYS, min((t + 1) * KEYS, l))
            st = kf[:, keys] @ qf[:, rows].transpose(1, 2)
            pt = p_of(st.transpose(1, 2), rows, keys).transpose(1, 2)
            dst = pt * (vf[:, keys] @ dof[:, rows].transpose(1, 2)
                        - dsum[:, None, rows])
            dv[:, keys] += pt.to(BF16).to(F32) @ dof[:, rows]
            dk[:, keys] += dst.to(BF16).to(F32) @ qf[:, rows]
    dk = dk * scale
    return tuple(x[..., :d].to(q.dtype) for x in (dq, dk, dv))
