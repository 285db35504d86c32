"""Multi-head Latent Attention (DeepSeek-V2/V3), a port of the
reference's `models/mla.py`.

Queries are low-rank projected (q_lora_rank); keys and values are
compressed to a `kv_lora_rank` latent plus one rope key shared by the
heads. The decode cache stores only (c_kv, k_rope), kv_lora_rank +
rope_dim values a token and layer, and decode *absorbs* W_uk and W_uv,
so attention runs in latent space, in float32, as the reference's does.

Prefill and training materialise K and V (q and k of width nope + rope,
192 for DeepSeek-V3) and pad V with zeros to that width, as the
reference does to reuse its attention: the attention is
`kernels/ops.gqa_flash_attention`, the `flash_attention` kernel on the
card and its plain version on the CPU, at the scale of the q·k width.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32


def init_mla(d_model: int, n_heads: int, m: MLAConfig, dtype, generator,
             device) -> Dict[str, torch.Tensor]:
    """Random parameters at the reference's `init_mla` scales (the norms
    zero), drawn from `generator` on `device`."""
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def mat(shape, scale):
        return L.randn(shape, scale, dtype, generator, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    std = d_model ** -0.5
    return {
        "w_dq": mat((d_model, m.q_lora_rank), std),
        "q_norm": zeros(m.q_lora_rank),
        "w_uq": mat((m.q_lora_rank, n_heads, qk), m.q_lora_rank ** -0.5),
        "w_dkv": mat((d_model, m.kv_lora_rank), std),
        "kv_norm": zeros(m.kv_lora_rank),
        "w_kr": mat((d_model, m.qk_rope_head_dim), std),
        "w_uk": mat((m.kv_lora_rank, n_heads, m.qk_nope_head_dim),
                    m.kv_lora_rank ** -0.5),
        "w_uv": mat((m.kv_lora_rank, n_heads, m.v_head_dim),
                    m.kv_lora_rank ** -0.5),
        "wo": mat((n_heads, m.v_head_dim, d_model),
                  (n_heads * m.v_head_dim) ** -0.5),
    }


def _latents(p, x, m: MLAConfig, theta, positions):
    """(c_kv normalised (B, L, R), k_rope rotated (B, L, Rr)) of x (B, L,
    D)."""
    c_kv = L.rms_norm(torch.einsum("bld,dr->blr", x, p["w_dkv"]),
                      p["kv_norm"])
    k_r = torch.einsum("bld,dr->blr", x, p["w_kr"])[:, :, None, :]
    k_r = L.apply_rope(k_r, positions, theta)[:, :, 0, :]
    return c_kv, k_r


def _queries(p, x, m: MLAConfig, theta, positions):
    """(q_nope, q_rope rotated), (B, L, H, nope) and (B, L, H, rope)."""
    cq = L.rms_norm(torch.einsum("bld,dr->blr", x, p["w_dq"]), p["q_norm"])
    q = torch.einsum("blr,rhk->blhk", cq, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = L.apply_rope(q[..., m.qk_nope_head_dim:], positions, theta)
    return q_nope, q_rope


def _positions(x) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)[None, :]


def mla_prefill_latents(p, x, m: MLAConfig, theta):
    """The latents of every position of x (B, L, D): what `mla_forward`
    attends to and what the cache keeps."""
    return _latents(p, x, m, theta, _positions(x))


def mla_forward(p, x, m: MLAConfig, theta, *, chunk: int = 1024):
    """The prefill and training forward of x (B, L, D): ((B, L, D), the
    latents (`mla_prefill_latents`), which the cache keeps). K and V are
    materialised from the latents, V zero-padded to the q·k width, and
    attended with causal flash attention at a tile of min(chunk, L)."""
    b, l, _ = x.shape
    q_nope, q_rope = _queries(p, x, m, theta, _positions(x))
    c_kv, k_r = mla_prefill_latents(p, x, m, theta)
    k_nope = torch.einsum("blr,rhk->blhk", c_kv, p["w_uk"])
    v = torch.einsum("blr,rhk->blhk", c_kv, p["w_uv"])
    h = q_nope.shape[2]
    k_rope = k_r[:, :, None, :].expand(b, l, h, m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope], -1)
    vp = F.pad(v, (0, q.shape[-1] - m.v_head_dim))
    t = min(chunk, l)
    o = ops.gqa_flash_attention(q, k, vp, causal=True, tq=t, tk=t,
                                device=x.device)
    return (torch.einsum("blhk,hkd->bld", o[..., :m.v_head_dim], p["wo"]),
            (c_kv, k_r))


def mla_init_cache(n_layers: int, batch: int, seq_len: int, m: MLAConfig,
                   dtype, device: DeviceLike = None):
    """Zero latent caches for n_layers layers, stacked on a leading layer
    axis: c_kv (n_layers, B, S, kv_lora_rank), k_rope (n_layers, B, S,
    rope_dim)."""
    dev = resolve(device)
    return {"c_kv": torch.zeros((n_layers, batch, seq_len, m.kv_lora_rank),
                                dtype=dtype, device=dev),
            "k_rope": torch.zeros((n_layers, batch, seq_len,
                                   m.qk_rope_head_dim), dtype=dtype,
                                  device=dev)}


def mla_decode_step(p, x, cache, pos: int, m: MLAConfig, theta):
    """x: (B, 1, D) at position `pos`; `cache` {c_kv (B, S, R), k_rope
    (B, S, Rr)} is written at `pos` in place. Absorbed attention in
    latent space, in float32:

    scores = q_nope^T W_uk c_kv + q_rope^T k_rope
    out    = softmax(scores) c_kv W_uv

    q_nope W_uk is formed in x's dtype and then cast, and the latent
    output is cast back to x's dtype before W_uv, as in the reference.
    Returns ((B, 1, D), cache)."""
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _queries(p, x, m, theta, positions)
    c_new, kr_new = _latents(p, x, m, theta, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[:, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, pos] = kr_new[:, 0].to(k_rope.dtype)
    q_lat = torch.einsum("blhk,rhk->blhr", q_nope, p["w_uk"])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    c32 = c_kv.to(F32)
    s = (torch.einsum("blhr,bmr->bhlm", q_lat.to(F32), c32)
         + torch.einsum("blhk,bmk->bhlm", q_rope.to(F32),
                        k_rope.to(F32))) * scale
    kpos = torch.arange(c_kv.shape[1], device=x.device)
    s = torch.where(kpos <= pos, s, L._neg_inf(s))
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhlm,bmr->blhr", prob, c32)
    o = torch.einsum("blhr,rhk->blhk", o_lat.to(x.dtype), p["w_uv"])
    return torch.einsum("blhk,hkd->bld", o, p["wo"]), cache
