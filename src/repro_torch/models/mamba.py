"""Mamba2 (SSD, state-space duality) block: chunked prefill scan + O(1)
decode, a port of the reference's `models/mamba.py` for serving.

  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t + D x_t

Prefill (`mamba_forward`) runs the scan through `kernels/ops.ssd` (the
`ssd_scan` kernel on the card, its plain version on the CPU) and adds
the D residual outside it, as the reference's `ssd_chunked` adds it
after its scan. `ssd_chunked` stays as the model's plain version of the
whole scan. Projections are kept separate (wz/wx/wB/wC/wdt).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm

F32 = torch.float32


def mamba_dims(d_model: int, s: SSMConfig):
    d_inner = s.expand * d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


def softplus(x):
    """jax.nn.softplus: log(1 + exp(x)) without a threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def init_mamba(d_model: int, s: SSMConfig, dtype, generator,
               device) -> Dict[str, torch.Tensor]:
    """Random parameters at the reference's scales (its `init_mamba`),
    drawn from `generator` on `device`."""
    d_inner, n_heads = mamba_dims(d_model, s)
    gn = s.n_groups * s.d_state
    std = d_model ** -0.5

    def mat(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=F32) * scale).to(dtype)

    def zeros(n, dt=dtype):
        return torch.zeros((n,), dtype=dt, device=device)

    return {
        "wz": mat((d_model, d_inner), std),
        "wx": mat((d_model, d_inner), std),
        "wB": mat((d_model, gn), std),
        "wC": mat((d_model, gn), std),
        "wdt": mat((d_model, n_heads), std),
        "conv_x": mat((s.d_conv, d_inner), 0.2),
        "conv_B": mat((s.d_conv, gn), 0.2),
        "conv_C": mat((s.d_conv, gn), 0.2),
        "conv_bx": zeros(d_inner),
        "conv_bB": zeros(gn),
        "conv_bC": zeros(gn),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=F32,
                                          device=device)),
        "dt_bias": zeros(n_heads, F32),
        "D": torch.ones((n_heads,), dtype=F32, device=device),
        "norm_w": zeros(d_inner),
        "out_proj": mat((d_inner, d_model), d_inner ** -0.5),
    }


def _causal_conv(u, w, bias):
    """Depthwise causal conv. u: (B, L, C); w: (K, C)."""
    k = w.shape[0]
    lu = u.shape[1]
    out = torch.zeros(u.shape, dtype=F32, device=u.device)
    for i in range(k):
        shift = k - 1 - i
        pad = F.pad(u, (0, 0, shift, 0))[:, :lu]
        out = out + pad.to(F32) * w[i].to(F32)
    return F.silu(out + bias.to(F32)).to(u.dtype)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, *, return_state=False):
    """The plain SSD scan. x: (Bt,L,H,P); dt:(Bt,L,H); A:(H,);
    B,C:(Bt,L,G,N); D:(H,). Returns y: (Bt,L,H,P) (and the final SSM
    state (Bt,H,N,P) when `return_state`). G divides H."""
    bt, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, l)
    if l % chunk:                    # the reference's assert, kept
        raise AssertionError((l, chunk))
    nc = l // chunk
    rep = h // g
    dev = x.device

    xf = x.to(F32).reshape(bt, nc, chunk, h, p)
    dtf = dt.to(F32).reshape(bt, nc, chunk, h)
    Bf = B.to(F32).reshape(bt, nc, chunk, g, n)
    Cf = C.to(F32).reshape(bt, nc, chunk, g, n)
    Bh = Bf.repeat_interleave(rep, dim=3)               # (bt,nc,Q,h,n)
    Ch = Cf.repeat_interleave(rep, dim=3)

    dA = dtf * A                                        # (bt,nc,Q,h)
    cum = torch.cumsum(dA, dim=2)
    seg_end = cum[:, :, -1:, :]                         # (bt,nc,1,h)

    # mask the decay before exp: exp of the positive masked entries
    # overflows
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (bt,nc,Qi,Qj,h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dev))
    decay = torch.where(causal[None, None, :, :, None], decay,
                        torch.full((), float("-inf"), device=dev))
    lmat = torch.exp(decay)
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    w = cb * lmat * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xf)

    wstate = torch.exp(seg_end - cum) * dtf             # (bt,nc,Q,h)
    s_chunk = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", wstate, Bh, xf)

    seg = torch.exp(seg_end[:, :, 0, :])                # (bt,nc,h)
    s = torch.zeros((bt, h, n, p), dtype=F32, device=dev)
    s_before = []
    for c in range(nc):
        s_before.append(s)
        s = s * seg[:, c, :, None, None] + s_chunk[:, c]
    s_before = torch.stack(s_before, dim=1)             # (bt,nc,h,n,p)

    y_inter = torch.einsum("bcih,bcihn,bchnp->bcihp", torch.exp(cum), Ch,
                           s_before)
    y = (y_intra + y_inter).reshape(bt, l, h, p)
    y = y + D[None, None, :, None] * x.to(F32)
    y = y.to(x.dtype)
    if return_state:
        return y, s
    return y


def _project(params, u):
    return tuple(torch.einsum("bld,de->ble", u, params[k])
                 for k in ("wz", "wx", "wB", "wC", "wdt"))


def mamba_forward(params, u, s: SSMConfig, *, return_state=False):
    """Prefill forward. u: (B, L, D) -> (B, L, D).

    With `return_state`, also returns the decode-ready state dict
    ({'ssm','conv_x','conv_B','conv_C'}) after the last position."""
    d_model = u.shape[-1]
    d_inner, n_heads = mamba_dims(d_model, s)
    z, x_raw, B_raw, C_raw, dt = _project(params, u)

    x = _causal_conv(x_raw, params["conv_x"], params["conv_bx"])
    B = _causal_conv(B_raw, params["conv_B"], params["conv_bB"])
    C = _causal_conv(C_raw, params["conv_C"], params["conv_bC"])

    bt, l, _ = x.shape
    xh = x.reshape(bt, l, n_heads, s.head_dim)
    Bh = B.reshape(bt, l, s.n_groups, s.d_state)
    Ch = C.reshape(bt, l, s.n_groups, s.d_state)
    dtv = softplus(dt.to(F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    chunk = min(s.chunk, l)
    if l % chunk:                    # ssd_chunked's assert, kept
        raise AssertionError((l, chunk))
    out = ops.ssd(xh.transpose(1, 2), dtv.transpose(1, 2), A,
                  Bh.transpose(1, 2), Ch.transpose(1, 2), q=chunk,
                  return_state=return_state, device=u.device)
    y, s_final = out if return_state else (out, None)
    y = y.transpose(1, 2).to(F32) + params["D"][None, None, :, None] \
        * xh.to(F32)
    y = y.to(x.dtype).reshape(bt, l, d_inner)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), params["norm_w"])
    y = torch.einsum("ble,ed->bld", y, params["out_proj"])
    if return_state:
        state = {"ssm": s_final,
                 "conv_x": x_raw[:, -(s.d_conv - 1):],
                 "conv_B": B_raw[:, -(s.d_conv - 1):],
                 "conv_C": C_raw[:, -(s.d_conv - 1):]}
        return y, state
    return y


def mamba_init_state(batch: int, d_model: int, s: SSMConfig, dtype,
                     device) -> Dict[str, torch.Tensor]:
    d_inner, n_heads = mamba_dims(d_model, s)
    gn = s.n_groups * s.d_state
    return {
        "ssm": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                           dtype=F32, device=device),
        "conv_x": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, s.d_conv - 1, gn), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, s.d_conv - 1, gn), dtype=dtype,
                              device=device),
    }


def _conv_step(window, w, bias):
    """window: (B, K, C) raw inputs incl. current; returns (B, C) f32."""
    out = torch.einsum("bkc,kc->bc", window.to(F32), w.to(F32))
    return F.silu(out + bias.to(F32))


def mamba_decode_step(params, u, state, s: SSMConfig):
    """u: (B, 1, D); returns (y (B,1,D), new state)."""
    d_model = u.shape[-1]
    d_inner, n_heads = mamba_dims(d_model, s)
    z, x_new, B_new, C_new, dt = (t[:, 0] for t in _project(params, u))

    wx = torch.cat([state["conv_x"], x_new[:, None]], 1)
    wB = torch.cat([state["conv_B"], B_new[:, None]], 1)
    wC = torch.cat([state["conv_C"], C_new[:, None]], 1)
    x = _conv_step(wx, params["conv_x"], params["conv_bx"])
    B = _conv_step(wB, params["conv_B"], params["conv_bB"])
    C = _conv_step(wC, params["conv_C"], params["conv_bC"])

    b = u.shape[0]
    xh = x.reshape(b, n_heads, s.head_dim)
    rep = n_heads // s.n_groups
    Bh = B.reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, 1)
    Ch = C.reshape(b, s.n_groups, s.d_state).repeat_interleave(rep, 1)
    dtv = softplus(dt.to(F32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    da = torch.exp(dtv * A)                             # (B,H)
    h = state["ssm"] * da[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dtv, Bh.to(F32), xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(F32), h)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype)[:, None],
                 params["norm_w"])
    out = torch.einsum("ble,ed->bld", y, params["out_proj"])
    new_state = {"ssm": h,
                 "conv_x": wx[:, 1:], "conv_B": wB[:, 1:],
                 "conv_C": wC[:, 1:]}
    return out, new_state
