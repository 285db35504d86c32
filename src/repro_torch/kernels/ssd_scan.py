"""Mamba2 SSD chunked scan: the CUDA kernels, their wrappers, their plain
versions and the autograd Function that joins the forward and the
backward.

`ssd_scan` (csrc/ssd_scan.cu) replaces the TPU kernel
`repro/kernels/ssd_scan.py::ssd_scan`: per (batch, head) row and chunk
of q steps, the decay-masked intra-chunk `C B^T` term plus the
contribution of the (N, P) state carried across the chunks in order,
reset at chunk 0. Beside y it returns the carried state after the last
chunk (the TPU kernel's scratch at its end), which prefill hands to
decode. The D residual and the gating stay outside. With bfloat16
inputs the kernel is `ssd_fwd_wgmma`, on Hopper's wgmma and TMA: one
warpgroup a head (and a 64-column slice of P), G = C B^T formed per 64 x
64 tile pair, W = G 2^(cum_i - cum_j) dt_j rounded to bfloat16 for W x,
S's bfloat16 copy for C S and (B w)^T rounded to bfloat16 for the state
update, the float32 state in registers over the chunks; with float32
inputs the CUDA-core kernel (see the source's header). TMA takes
16-byte row strides, so the wrapper hands the bfloat16 kernel x, B and C
zero-padded to a multiple of 8 columns (`wgmma_operand`; no copy at the
models' P 64, N 64 and 128) and slices y and the states back: exact,
since zero columns add nothing and give zero outputs. It takes P, N up
to 128 and a chunk up to what its shared memory holds (`fwd_wgmma_max_q`,
mirroring the source's `fwd_wgmma_smem`); past that it raises
ValueError.

Layout: a (BH,), x (BH, L, P), dt (BH, L), b, c (BH // rep, L, N): row
bh reads B and C row bh // rep, so the heads of a group share their
group's rows (with rep = 1 this is the TPU kernel's per-head layout).

The TPU kernel has no backward: the reference trains through its jnp
`ssd_chunked` and autodiff. The port trains through the kernel, so
`ssd_scan_bwd` is the gradient of the function the forward computes, in
two builds of the same source: for bfloat16 inputs `ssd_bwd_wgmma`, on
Hopper's wgmma and TMA, two warpgroups a block of up to two heads of a
group (`bwd_wgmma_heads`, on a model of its shared memory,
`bwd_wgmma_smem`), G^T = B C^T, dG^T C and dG B formed once for the
block's heads, and each block's dB, dC summed over a group's blocks in
a fixed order by a second small kernel; for float32 inputs `ssd_bwd`,
on the CUDA cores (`heads_a_block`). The bfloat16 build takes x, dy, B
and C zero-padded to a multiple of 8 columns, as the forward does, and
chunks up to `bwd_wgmma_max_q`; past that it raises ValueError. When a
gradient is needed the forward also saves S_c, the float32 state before
each chunk c >= 1, (BH, L // q - 1, N, P), and the backward walks the
chunks in reverse from them (undoing the recurrence would divide by
exp(cum_Q)). `SSDScan` is the autograd Function: on the card the
forward kernel then the backward kernel, on the CPU the plain forward
then `ssd_scan_bwd_plain`, so the CPU tests run the formula the backward
kernel is held to.

`ssd_scan_plain` and `ssd_scan_bwd_plain` are the arithmetic chunk by
chunk in eager torch (any device). The wrappers take `device=None`
(meaning "cuda"): on a CUDA device they launch the kernel on the current
stream or raise; only for CPU tensors do they run the plain version.
Counts on `ssd_scan`: `.launches` and `.plain_calls` (forward),
`.wgmma_launches` (the forward launches that ran `ssd_fwd_wgmma`: every
bfloat16 one, also in `.launches`), `.bwd_launches`,
`.bwd_wgmma_launches` (the backward launches that ran `ssd_bwd_wgmma`:
every bfloat16 one, also in `.bwd_launches`) and `.bwd_plain_calls`;
`reset_counts()` zeroes them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.flash_attention import wgmma_operand
from repro_torch.kernels.iss_stepper import _check, _on_cpu, _raise_on

F32 = torch.float32
_DTYPES = (torch.float32, torch.bfloat16)


def _chunk_inputs(a, x, dt, b, c, sl, rep):
    """Chunk `sl` of every input in float32, B and C repeated per head,
    and the chunk's inclusive cumsum of dt a."""
    bf = b[:, sl].repeat_interleave(rep, dim=0) if rep > 1 else b[:, sl]
    cf = c[:, sl].repeat_interleave(rep, dim=0) if rep > 1 else c[:, sl]
    dts = dt[:, sl].to(F32)
    cum = torch.cumsum(dts * a.to(F32)[:, None], dim=-1)
    return x[:, sl].to(F32), dts, bf.to(F32), cf.to(F32), cum


def _decay(cum, causal):
    """L_ij = exp(cum_i - cum_j) for j <= i, 0 above the diagonal (the
    exponent masked before exp: it is positive there)."""
    decay = cum[:, :, None] - cum[:, None, :]
    neg_inf = torch.full((), float("-inf"), device=cum.device)
    return torch.exp(torch.where(causal, decay, neg_inf))


def ssd_scan_plain(a, x, dt, b, c, *, q: int = 64, rep: int = 1,
                   return_states: bool = False):
    """The TPU kernel's chunk step, batched over BH, chunk by chunk.
    Returns (y (BH, L, P) in x's dtype, state (BH, N, P) float32), and
    with `return_states` also the state before each chunk but the first,
    (BH, L // q - 1, N, P) float32."""
    bh, l, p = x.shape
    n = b.shape[-1]
    dev = x.device
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    state = torch.zeros((bh, n, p), dtype=F32, device=dev)
    ys, states = [], []
    for ci in range(l // q):
        if ci:
            states.append(state)
        xs, dts, bm, cm, cum = _chunk_inputs(a, x, dt, b, c,
                                             slice(ci * q, (ci + 1) * q), rep)
        seg_end = cum[:, -1:]
        w = (cm @ bm.transpose(1, 2)) * _decay(cum, causal) * dts[:, None, :]
        y = w @ xs
        y = y + torch.exp(cum)[:, :, None] * (cm @ state)
        wstate = torch.exp(seg_end - cum) * dts           # (BH, Q)
        s_new = (bm * wstate[:, :, None]).transpose(1, 2) @ xs
        state = state * torch.exp(seg_end)[:, :, None] + s_new
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1)
    if not return_states:
        return y, state
    saved = (torch.stack(states, dim=1) if states else
             torch.zeros((bh, 0, n, p), dtype=F32, device=dev))
    return y, state, saved


def ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, ds_final=None, *,
                       q: int = 64, rep: int = 1):
    """(da, dx, ddt, db, dc), the gradients of `ssd_scan_plain`'s inputs
    (a, x, dt, b, c), from the output's gradient dy (BH, L, P), the
    forward's saved states and the final state's gradient ds_final
    ((BH, N, P) float32, or None for zero): the chunks in reverse with
    dS, the gradient of the state after the chunk, carried. float32 sums;
    dx, db, dc in the inputs' dtypes, ddt and da float32."""
    bh, l, p = x.shape
    n = b.shape[-1]
    dev = x.device
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    ds = (torch.zeros((bh, n, p), dtype=F32, device=dev) if ds_final is None
          else ds_final.to(F32))
    dx = torch.empty((bh, l, p), dtype=F32, device=dev)
    ddt = torch.empty((bh, l), dtype=F32, device=dev)
    db = torch.empty((bh, l, n), dtype=F32, device=dev)
    dc = torch.empty((bh, l, n), dtype=F32, device=dev)
    da = torch.zeros((bh,), dtype=F32, device=dev)
    av = a.to(F32)[:, None]
    for ci in reversed(range(l // q)):
        sl = slice(ci * q, (ci + 1) * q)
        xs, dts, bm, cm, cum = _chunk_inputs(a, x, dt, b, c, sl, rep)
        dys = dy[:, sl].to(F32)
        cq = cum[:, -1:]                                   # (BH, 1)
        lmat = _decay(cum, causal)
        g = cm @ bm.transpose(1, 2)                        # C_i . B_j
        w = g * lmat * dts[:, None, :]
        s_c = (states[:, ci - 1] if ci else
               torch.zeros((bh, n, p), dtype=F32, device=dev))
        ecum = torch.exp(cum)
        wst = torch.exp(cq - cum) * dts                    # w_j
        # intra-chunk: y_i += sum_{j <= i} W_ij x_j
        dwm = dys @ xs.transpose(1, 2)                     # dW = dy x^T
        dxc = w.transpose(1, 2) @ dys
        dg = dwm * lmat * dts[:, None, :]
        dcc = dg @ bm
        dbc = dg.transpose(1, 2) @ cm
        ww = dwm * w
        dcum = ww.sum(-1) - ww.sum(-2)
        ddtc = (dwm * g * lmat).sum(-2)
        # inter-chunk: y_i += exp(cum_i) C_i S_c
        t = dys @ s_c.transpose(1, 2)                      # (BH, Q, N)
        dcc = dcc + ecum[:, :, None] * t
        dcum = dcum + ecum * (cm * t).sum(-1)
        # state update: S' = exp(cum_Q) S_c + sum_j w_j B_j x_j^T
        u = bm @ ds                                        # (BH, Q, P)
        dxc = dxc + wst[:, :, None] * u
        dbc = dbc + wst[:, :, None] * (xs @ ds.transpose(1, 2))
        dw = (u * xs).sum(-1)
        ddtc = ddtc + torch.exp(cq - cum) * dw
        dcum = dcum - wst * dw
        dcum[:, -1] += ((wst * dw).sum(-1)
                        + torch.exp(cq[:, 0]) * (s_c * ds).sum((1, 2)))
        ds = torch.exp(cq)[:, :, None] * ds \
            + (ecum[:, :, None] * cm).transpose(1, 2) @ dys
        # the cumsum: d(da)_k = sum_{i >= k} dcum_i
        dda = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))
        ddt[:, sl] = ddtc + av * dda
        da = da + (dts * dda).sum(-1)
        dx[:, sl], db[:, sl], dc[:, sl] = dxc, dbc, dcc
    if rep > 1:
        db = db.reshape(bh // rep, rep, l, n).sum(1)
        dc = dc.reshape(bh // rep, rep, l, n).sum(1)
    return da, dx.to(x.dtype), ddt, db.to(b.dtype), dc.to(c.dtype)


def _check_shape(bh: int, l: int, q: int, rep: int) -> None:
    if l % q:
        raise ValueError(f"L = {l} must divide by q = {q}")
    if rep < 1 or bh % rep:
        raise ValueError(f"BH = {bh} must divide by rep = {rep}")


def _check_inputs(a, x, dt, b, c, dev, rep):
    """The types, shapes and devices the kernels take; the P, N limit on
    the card only."""
    bh, l, p = x.shape
    n = b.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"x has dtype {x.dtype}: float32 or bfloat16")
    if dev.type == "cuda" and not (1 <= p <= 128 and 1 <= n <= 128):
        raise ValueError(f"P = {p}, N = {n}: the kernel takes 1 to 128")
    for name, t, dtype, shape in (
            ("a", a, F32, (bh,)), ("x", x, x.dtype, (bh, l, p)),
            ("dt", dt, F32, (bh, l)), ("b", b, x.dtype, (bh // rep, l, n)),
            ("c", c, x.dtype, (bh // rep, l, n))):
        _check(name, t, dev, dtype, shape)


# the bfloat16 forward kernel (`ssd_fwd_wgmma`): rows of a tile, its
# rings' slots (C; B and x), shared memory a block may take
_TILE = 64
_FWD_C_SLOTS, _FWD_STAGES = 2, 2
_SMEM_LIMIT = 227 * 1024


def fwd_wgmma_smem(n: int, q: int) -> int:
    """Shared-memory bytes of a bfloat16 forward block at N = n (zero-
    padded to a multiple of 8), chunk q: the same sum as `fwd_wgmma_smem`
    in csrc/ssd_scan.cu (three float32 rows of the chunk, the warps'
    sums and the barriers; 1,024 bytes to align the tiles; two C tiles,
    the (B, x) ring, S's bfloat16 copy and y's tile, a tile 64 rows of 64
    values a box, N in one box or two)."""
    qp = -(-q // _TILE) * _TILE
    box = _TILE * _TILE * 2
    nbytes = (1 if n <= 64 else 2) * box
    tiles = _FWD_C_SLOTS * nbytes + _FWD_STAGES * (nbytes + box) + nbytes \
        + box
    return 4 * (3 * qp + 4) + 8 * (_FWD_C_SLOTS + _FWD_STAGES) + 1024 \
        + tiles


def fwd_wgmma_max_q(n: int) -> int:
    """The longest chunk the bfloat16 forward takes at N = n."""
    fixed = fwd_wgmma_smem(n, 0)
    return (_SMEM_LIMIT - fixed) // (12 * _TILE) * _TILE


def _forward(a, x, dt, b, c, q, rep, dev, with_states):
    """(y, s_final, states or None): the kernel on the card, the plain
    version on the CPU."""
    bh, l, p = x.shape
    n = b.shape[-1]
    _check_shape(bh, l, q, rep)
    if dev.type == "cpu":
        _on_cpu(a=a, x=x, dt=dt, b=b, c=c)
        ssd_scan.plain_calls += 1
        out = ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep,
                             return_states=with_states)
        return out if with_states else (*out, None)
    _check_inputs(a, x, dt, b, c, dev, rep)
    wgmma = x.dtype == torch.bfloat16
    if wgmma:
        if q > fwd_wgmma_max_q(n):
            raise ValueError(f"chunk q = {q} at N = {n}: the bfloat16 "
                             f"kernel's shared memory holds "
                             f"{fwd_wgmma_max_q(n)} steps at most")
        x, b, c = (wgmma_operand(t) for t in (x, b, c))
    pr, nr = x.shape[-1], b.shape[-1]
    y = torch.empty_like(x)
    s_final = torch.empty((bh, nr, pr), dtype=F32, device=dev)
    states = (torch.empty((bh, l // q - 1, nr, pr), dtype=F32, device=dev)
              if with_states else None)
    fn = getattr(_build.load("ssd_scan"), "ssd_scan_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(wgmma), a.data_ptr(), x.data_ptr(), dt.data_ptr(),
                b.data_ptr(), c.data_ptr(), y.data_ptr(), s_final.data_ptr(),
                states.data_ptr() if with_states and l > q else None,
                bh, l, pr, nr, q, rep, stream)
    _raise_on(rc, "ssd_scan launch")
    ssd_scan.launches += 1
    ssd_scan.wgmma_launches += wgmma
    if (pr, nr) != (p, n):          # the zero-padded columns, sliced off
        y = y[..., :p].contiguous()
        s_final = s_final[:, :n, :p].contiguous()
        if states is not None:
            states = states[:, :, :n, :p].contiguous()
    return y, s_final, states


def heads_a_block(bh: int, rep: int, sms: int) -> int:
    """The float32 backward's heads a block: the divisor of rep whose
    grid of bh / hb blocks (one an SM) fills the SMs in the fewest waves
    of the fewest heads, the most heads on a tie (the fewest partial
    sums)."""
    best = None
    for hb in range(1, rep + 1):
        if rep % hb:
            continue
        cost = -(-(bh // hb) // sms) * hb
        if best is None or cost <= best[0]:
            best = (cost, hb)
    return best[1]


# the bfloat16 backward kernel (`ssd_bwd_wgmma`): a 64 x 64 tile's bytes
# in bfloat16 (a TMA box) and float32
_BOX, _F32_TILE = _TILE * _TILE * 2, _TILE * _TILE * 4


def bwd_wgmma_smem(n: int, p: int, q: int, nh: int) -> int:
    """Shared-memory bytes of a bfloat16 backward block of `nh` heads at
    N = n, P = p (each in one 64-column box or two), chunk q: the same sum
    as `bwd_wgmma_smem` in csrc/ssd_scan.cu (1,024 bytes to align the
    tiles; each head's dS as bfloat16 hi and lo; the region the column
    walk (B_j, the heads' x_j, G^T and the dG exchange in float32) and
    the row walks (each head's S_c hi and lo, the float32 staging of a
    dB or dC tile) share; two ring slots (C_i and the heads' dy_i, or a
    tile and a summed dG tile); float32
    rows of the chunk, two a head and three a row of the sums (one a head,
    two for P past 64, whose head both warpgroups run); per head the
    column sums, the dot's partials and da; three barriers)."""
    nb, pb = (2 if n > 64 else 1), (2 if p > 64 else 1)
    state = nb * pb * _BOX
    u = 2 * nh * state
    gt = u + nb * _BOX + nh * pb * _BOX
    stage = max(gt, u + nh * state)
    end = max(gt + 2 * _F32_TILE, u + 2 * nh * state,
              stage + nb * _F32_TILE)
    slot = max((nb + nh * pb) * _BOX, (nb + 1) * _BOX)
    qp = -(-q // _TILE) * _TILE
    hr = 2 if p > 64 else nh   # rows of the per-row sums
    return 1024 + end + 2 * slot + 4 * ((2 * nh + 3 * hr) * qp + 266 * nh) \
        + 24


def bwd_wgmma_heads(p: int, n: int, q: int, rep: int) -> int:
    """The bfloat16 backward's heads a block: two where P <= 64, the
    group has two and their shared memory holds the chunk, else one (the
    same rule as the source's `bwd_wgmma_heads`). Raises ValueError past
    the longest chunk one head's block holds (`bwd_wgmma_max_q`)."""
    for hb in range(2 if p <= 64 and rep >= 2 else 1, 0, -1):
        if bwd_wgmma_smem(n, p, q, hb) <= _SMEM_LIMIT:
            return hb
    raise ValueError(f"chunk q = {q} at P = {p}, N = {n}: the bfloat16 "
                     f"backward's shared memory holds "
                     f"{bwd_wgmma_max_q(n, p)} steps at most")


def bwd_wgmma_max_q(n: int, p: int) -> int:
    """The longest chunk the bfloat16 backward takes at N = n, P = p (one
    head a block: each 64 steps of the chunk cost the same bytes)."""
    fixed = bwd_wgmma_smem(n, p, 0, 1)
    tile = bwd_wgmma_smem(n, p, _TILE, 1) - fixed
    return (_SMEM_LIMIT - fixed) // tile * _TILE


def _bwd_wgmma(a, x, dt, b, c, dy, states, ds_final, q, rep, dev):
    """The bfloat16 backward kernel: (da, dx, ddt, db, dc)."""
    bh, l, p = x.shape
    n = b.shape[-1]
    hb = bwd_wgmma_heads(p, n, q, rep)
    sets = -(-rep // hb)    # blocks, and partials, a group
    groups, nt = bh // rep, -(-q // _TILE)
    x, b, c, dy = (wgmma_operand(t) for t in (x, b, c, dy))
    pr, nr = x.shape[-1], b.shape[-1]
    dx = torch.empty_like(x)
    ddt = torch.empty((bh, l), dtype=F32, device=dev)
    da = torch.empty((bh,), dtype=F32, device=dev)
    # scratch: dS between chunks, each block's summed dG tiles of a chunk,
    # the blocks' partial sums of dB and dC where a group has several
    ds_buf = (torch.empty((bh, n, p), dtype=F32, device=dev) if l > q
              else None)
    dg_buf = torch.empty((groups * sets, nt * (nt + 1) // 2, _TILE, _TILE),
                         dtype=torch.bfloat16, device=dev)
    part = (torch.empty((2, groups * sets, l, nr), dtype=F32, device=dev)
            if sets > 1 else None)
    out = torch.empty((2, groups, l, nr), dtype=torch.bfloat16, device=dev)
    fn = getattr(_build.load("ssd_scan"), "ssd_scan_bwd_wgmma_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                c.data_ptr(), dy.data_ptr(),
                states.data_ptr() if l > q else None,
                None if ds_final is None else ds_final.data_ptr(),
                None if ds_buf is None else ds_buf.data_ptr(),
                dg_buf.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                da.data_ptr(), None if part is None else part.data_ptr(),
                out.data_ptr(), bh, l, p, n, pr, nr, q, rep, hb, stream)
    _raise_on(rc, "ssd_scan_bwd launch")
    ssd_scan.bwd_launches += 1
    ssd_scan.bwd_wgmma_launches += 1
    db, dc = out[0], out[1]
    if (pr, nr) != (p, n):          # the zero-padded columns, sliced off
        dx = dx[..., :p].contiguous()
        db, dc = db[..., :n].contiguous(), dc[..., :n].contiguous()
    return da, dx, ddt, db, dc


def ssd_scan_bwd(a, x, dt, b, c, dy, states, ds_final=None, *, q: int = 64,
                 rep: int = 1, device: DeviceLike = None):
    """(da, dx, ddt, db, dc), the gradients of (a, x, dt, b, c), from
    the forward's inputs, the output's gradient dy ((BH, L, P), x's
    dtype), the forward's saved states ((BH, L // q - 1, N, P) float32)
    and the final state's gradient ds_final ((BH, N, P) float32, or None
    for zero)."""
    dev = resolve(device)
    bh, l, p = x.shape
    n = b.shape[-1]
    _check_shape(bh, l, q, rep)
    _check_inputs(a, x, dt, b, c, dev, rep)
    _check("dy", dy, dev, x.dtype, (bh, l, p))
    _check("states", states, dev, F32, (bh, l // q - 1, n, p))
    if ds_final is not None:
        _check("ds_final", ds_final, dev, F32, (bh, n, p))
    if dev.type == "cpu":
        ssd_scan.bwd_plain_calls += 1
        return ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, ds_final, q=q,
                                  rep=rep)
    if x.dtype == torch.bfloat16:
        return _bwd_wgmma(a, x, dt, b, c, dy, states, ds_final, q, rep, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hb = heads_a_block(bh, rep, sms)
    sets = rep // hb    # blocks, and partials, a group
    dx = torch.empty_like(x)
    ddt = torch.empty((bh, l), dtype=F32, device=dev)
    da = torch.empty((bh,), dtype=F32, device=dev)
    parts = torch.empty((2, bh // rep * sets, l, n), dtype=F32, device=dev)
    fn = getattr(_build.load("ssd_scan"), "ssd_scan_bwd_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                c.data_ptr(), dy.data_ptr(),
                states.data_ptr() if l > q else None,
                None if ds_final is None else ds_final.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(), bh, l, p, n, q,
                rep, hb, stream)
    _raise_on(rc, "ssd_scan_bwd launch")
    ssd_scan.bwd_launches += 1
    # a group's partials of dB and dC summed in a fixed order: the
    # gradient of the repeat of B and C over the group's heads
    db, dc = parts.view(2, bh // rep, sets, l, n).sum(2)
    return da, dx, ddt, db, dc


class SSDScan(torch.autograd.Function):
    """`SSDScan.apply(a, x, dt, b, c, q, rep, device)`: the forward saving
    its chunk-entry states, and `ssd_scan_bwd` as its backward."""

    @staticmethod
    def forward(ctx, a, x, dt, b, c, q, rep, dev):
        ctx.set_materialize_grads(False)
        y, s_final, states = _forward(a, x, dt, b, c, q, rep, dev, True)
        ctx.save_for_backward(a, x, dt, b, c, states)
        ctx.args = (q, rep, dev)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        a, x, dt, b, c, states = ctx.saved_tensors
        q, rep, dev = ctx.args
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if ds_final is not None:
            ds_final = ds_final.contiguous()
        grads = ssd_scan_bwd(a, x, dt, b, c, dy, states, ds_final, q=q,
                             rep=rep, device=dev)
        return (*grads, None, None, None)


def ssd_scan(a, x, dt, b, c, *, q: int = 64, rep: int = 1,
             device: DeviceLike = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a: (BH,) per-head A; x: (BH, L, P); dt: (BH, L); b, c:
    (BH // rep, L, N). Returns (y (BH, L, P) in x's dtype, final state
    (BH, N, P) float32), differentiable in every input. L must divide by
    q."""
    dev = resolve(device)
    if needs_grad(a, x, dt, b, c):
        return SSDScan.apply(a, x, dt, b, c, q, rep, dev)
    return _forward(a, x, dt, b, c, q, rep, dev, False)[:2]


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-call counts."""
    ssd_scan.launches = 0
    ssd_scan.wgmma_launches = 0
    ssd_scan.plain_calls = 0
    ssd_scan.bwd_launches = 0
    ssd_scan.bwd_wgmma_launches = 0
    ssd_scan.bwd_plain_calls = 0


reset_counts()
