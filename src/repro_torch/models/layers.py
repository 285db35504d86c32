"""Core layers: norms, RoPE, sinusoidal positions, GQA attention (the
plain and chunked plain versions for prefill, the cache version for
decode), the QKV projection with its optional bias, and the SwiGLU MLP
with its initialisation.

A port of the reference's `models/layers.py` for the serving paths. All
attention math accumulates in float32; parameters and activations are
in the config's dtype. Attention avoids materialising repeated KV heads
by computing in the grouped layout (B, Lq, Hkv, G, D).

The reference's `shard_act` calls stand where it has them (q over heads
and k replicated in `attn_qkv`, the MLP's hidden over F), no-ops off a
mesh. Under tensor parallelism the parameters are DTensors: each product
contracts pieces placed alike (`meshctx.align`), the outputs of the
head- and F-contracting products are summed into replicated activations
(`shard_act`), and constants meet them through `sharding.place_like`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.meshctx import align, shard_act
from repro_torch.distributed.sharding import place_like

NEG_INF = -1e30
F32 = torch.float32


def _neg_inf(t: torch.Tensor) -> torch.Tensor:
    return place_like(torch.full((), NEG_INF, dtype=t.dtype,
                                 device=t.device), t)


# ---------------------------------------------------------------- norms/rope

def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(F32))).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., L, H, D); positions: (..., L) int. Rotates the two halves
    of D (not interleaved pairs)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (d/2,)
    ang = positions[..., None].to(F32) * freqs          # (..., L, d/2)
    cos = place_like(torch.cos(ang)[..., None, :], x)   # (..., L, 1, d/2)
    sin = place_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None):
    """(length, dim) float32: sin of each position over 10000^(2i/dim)
    in the first dim/2 columns, cos in the rest (Whisper's)."""
    pos = torch.arange(length, dtype=F32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=F32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- attention

def _grouped(q, n_kv: int):
    """(B, L, H, D) -> (B, L, Hkv, G, D)."""
    b, l, h, d = q.shape
    return q.reshape(b, l, n_kv, h // n_kv, d)


def attention_scores_mask(qpos, kpos, window: int, causal: bool):
    """(Lq, Lk) additive float32 mask."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def plain_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    bidirectional=False):
    """The reference's plain attention: every score at once, in float32.
    q: (B, Lq, H, D), k/v: (B, Lk, Hkv, D)."""
    b, lq, h, d = q.shape
    n_kv = k.shape[2]
    qg = _grouped(q, n_kv).to(F32)
    scores = torch.einsum("blhgd,bmhd->bhglm", qg * d ** -0.5, k.to(F32))
    if not bidirectional:
        qpos = q_offset + torch.arange(lq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        scores = scores + attention_scores_mask(qpos, kpos, window, True)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhglm,bmhd->blhgd", p, v.to(F32))
    return out.reshape(b, lq, h, d).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, chunk=1024):
    """Flash-style online-softmax attention over query and KV chunks with
    a running (max, denom, acc): the plain version of the prefill
    attention (the reference's global path: a masked scan over every KV
    chunk). q: (B, Lq, H, D), k/v: (B, Lk, Hkv, D).

    With a `window` (local attention) each query chunk qi reads only the
    KV chunks from first = max(qi - window // chunk, 0), at most
    window // chunk + 1 of them, under the mask q - k < window (and
    causality), as the reference's window path does: when window % chunk
    > 1 that tile bound drops keys inside the window."""
    b, lq, h, d = q.shape
    n_kv = k.shape[2]
    lk = k.shape[1]
    chunk = min(chunk, lq)
    if lq % chunk or lk % chunk:     # the reference's assert, kept
        raise AssertionError((lq, lk, chunk))
    nq, nk = lq // chunk, lk // chunk
    scale = d ** -0.5
    g = h // n_kv
    dev = q.device
    qg = (_grouped(q, n_kv).to(F32) * scale).reshape(b, nq, chunk, n_kv, g,
                                                     d)
    outs = []
    for qi in range(nq):
        qc = qg[:, qi]                                   # (B,chunk,Hkv,G,D)
        qpos = qi * chunk + torch.arange(chunk, device=dev)
        if window:
            nwin = min(nk, window // chunk + 1)
            first = max(qi - (nwin - 1), 0)
            keys = slice(first * chunk, (first + nwin) * chunk)
            kpos = first * chunk + torch.arange(nwin * chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, k[:, keys].to(F32))
            s = s + attention_scores_mask(qpos, kpos, window, causal)
            p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
            den = torch.sum(p, dim=-1, keepdim=True)
            outs.append(torch.einsum(
                "bhgqk,bkhd->bqhgd", p / torch.clamp_min(den, 1e-30),
                v[:, keys].to(F32)).to(q.dtype))
            continue
        m = torch.full((b, n_kv, g, chunk, 1), NEG_INF, dtype=F32,
                       device=dev)
        den = torch.zeros((b, n_kv, g, chunk, 1), dtype=F32, device=dev)
        acc = torch.zeros((b, chunk, n_kv, g, d), dtype=F32, device=dev)
        for ki in range(nk):
            ks = k[:, ki * chunk:(ki + 1) * chunk].to(F32)
            vs = v[:, ki * chunk:(ki + 1) * chunk].to(F32)
            kpos = ki * chunk + torch.arange(chunk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, ks)
            if causal:
                s = s + torch.where(kpos[None, :] <= qpos[:, None],
                                    0.0, NEG_INF)
            m2 = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2)
            den = den * corr + torch.sum(p, dim=-1, keepdim=True)
            pv = torch.einsum("bhgqk,bkhd->bqhgd", p, vs)
            acc = acc * torch.movedim(corr, (1, 2, 3), (2, 3, 1)) + pv
            m = m2
        den = torch.movedim(den, (1, 2, 3), (2, 3, 1))
        outs.append((acc / torch.clamp_min(den, 1e-30)).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(b, lq, h, d)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """Single-token attention against a cache.

    q: (B,1,H,D); caches: (B,S,Hkv,D); pos: index of the new token.
    Entries at kpos > pos, and with a `window` those at kpos <= pos -
    window, are masked out."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = _grouped(q, n_kv).to(F32) * (d ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.to(F32))
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    ok = kpos <= pos
    if window:
        ok &= kpos > pos - window
    s = torch.where(ok, s, _neg_inf(s))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.to(F32))
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------- blocks

def _project(x, w):
    """(B, L, D) x (D, H, Dh) -> (B, L, H, Dh)."""
    return torch.einsum("bld,dhk->blhk", align(x, w, ((-1, 0),)), w)


def attn_qkv(p, x, positions, theta):
    """q, k, v (B, L, H or Hkv, D), q and k rotated. The QKV bias (Qwen2),
    where `p` has one, is added after the products in the activations'
    dtype, as the reference adds it."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    q = shard_act(q, "batch", None, "model", None)
    k = shard_act(k, "batch", None, None, None)
    return q, k, v


def attn_out(p, o):
    o = torch.einsum("blhk,hkd->bld", align(o, p["wo"], ((2, 0), (3, 1))),
                     p["wo"])
    return shard_act(o, "batch", None, None)


def randn(shape, scale, dtype, generator, device) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from `generator` on `device`, cast
    to `dtype`."""
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=F32) * scale).to(dtype)


def init_mlp(d_model: int, d_ff: int, dtype, generator, device):
    """The reference's `init_mlp` scales: {wi, wg} (D, F) at D^-0.5, wo
    (F, D) at F^-0.5."""
    return {"wi": randn((d_model, d_ff), d_model ** -0.5, dtype, generator,
                        device),
            "wg": randn((d_model, d_ff), d_model ** -0.5, dtype, generator,
                        device),
            "wo": randn((d_ff, d_model), d_ff ** -0.5, dtype, generator,
                        device)}


def mlp(p, x):
    h = torch.einsum("bld,df->blf", align(x, p["wi"], ((-1, 0),)), p["wi"])
    g = torch.einsum("bld,df->blf", align(x, p["wg"], ((-1, 0),)), p["wg"])
    h = F.silu(g.to(F32)).to(h.dtype) * h
    h = shard_act(h, "batch", None, "model")
    o = torch.einsum("blf,fd->bld", align(h, p["wo"], ((-1, 0),)), p["wo"])
    return shard_act(o, "batch", None, None)
