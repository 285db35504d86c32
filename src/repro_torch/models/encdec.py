"""Whisper-style encoder-decoder, the audio family: a port of the
reference's `models/encdec.py` for serving and training.

The conv-over-mel frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, n_frames, d_model). Positions are
sinusoidal (`layers.sinusoidal_positions`), added to the frames and to
the token embeddings. An encoder layer is bidirectional self-attention
and an MLP; a decoder layer causal self-attention, cross-attention to
the encoder's output and an MLP, each pre-normed.

The model is an `EncDecLM` module: `embed`, `enc_layers` (the
reference's stacked `enc_layers`, one `EncBlock` each), `dec_layers`
(one `DecBlock` each), `enc_norm`, `final_norm` and `lm_head`. The
cache keeps each decoder layer's self-attention K and V (n_layers, B,
S, Hkv, D) and its cross-attention K and V over the frames (n_layers,
B, T, Hkv, D), the reference's `self_k`, `self_v`, `cross_k` and
`cross_v`; prefill fills it and decode updates the self-attention part
in place.

Attention routes. The encoder's self-attention (the reference's
`plain_attention(bidirectional=True)`) runs on `flash_attention` with
`causal=False`, at one tile of every frame: without a causal mask the
tile changes nothing but the plain version's loop, and 1,500 frames
divide by no tile of 128. The decoder's self-attention runs on
`flash_attention` with `causal=True` at the reference's chunk,
`min(cfg.attn_chunk, L)`. Cross-attention (queries over the tokens,
keys over the frames) stays the reference's plain attention in eager
torch, as does decode (`layers.decode_attention` for self-attention,
plain attention against the cached cross K and V). Each layer runs
under `transformer.remat` when autograd records, as the reference's
`jax.checkpoint` wraps it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import (batch_mask, embed_tokens,
                                            frozen, init_attention,
                                            logits_fn, padded_vocab, remat,
                                            softmax_xent, torch_dtype)

CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


class EncBlock(nn.Module):
    """`ln1`, `attn` {wq, wk, wv, wo}, `ln2`, `mlp` {wi, wg, wo}."""

    def __init__(self, params: Dict):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"], requires_grad=False)
        self.attn = frozen(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"], requires_grad=False)
        self.mlp = frozen(params["mlp"])


class DecBlock(nn.Module):
    """`ln1`, `self_attn`, `ln_x`, `cross_attn`, `ln2`, `mlp`, as the
    reference's `init_dec_layer` lays them out."""

    def __init__(self, params: Dict):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"], requires_grad=False)
        self.self_attn = frozen(params["self_attn"])
        self.ln_x = nn.Parameter(params["ln_x"], requires_grad=False)
        self.cross_attn = frozen(params["cross_attn"])
        self.ln2 = nn.Parameter(params["ln2"], requires_grad=False)
        self.mlp = frozen(params["mlp"])


class EncDecLM(nn.Module):
    """The encoder-decoder's parameters (inference only)."""

    def __init__(self, params: Dict):
        super().__init__()
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.enc_layers = nn.ModuleList(EncBlock(p)
                                        for p in params["enc_layers"])
        self.dec_layers = nn.ModuleList(DecBlock(p)
                                        for p in params["dec_layers"])
        self.enc_norm = nn.Parameter(params["enc_norm"], requires_grad=False)
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)


def init_encdec(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, trainable: bool = False
                ) -> EncDecLM:
    """Random parameters at the reference's scales, drawn on the device
    from `generator` (a fresh one seeded 0 when None), frozen unless
    `trainable`."""
    dev = resolve(device)
    g = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg)
    d, vp = cfg.d_model, padded_vocab(cfg.vocab)

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=dev)

    def attn():
        return init_attention(cfg, dtype, g, dev)

    def mlp():
        return L.init_mlp(d, cfg.d_ff, dtype, g, dev)

    params = {
        "embed": L.randn((vp, d), d ** -0.5, dtype, g, dev),
        "enc_layers": [{"ln1": zeros(), "attn": attn(), "ln2": zeros(),
                        "mlp": mlp()} for _ in range(cfg.n_enc_layers)],
        "dec_layers": [{"ln1": zeros(), "self_attn": attn(),
                        "ln_x": zeros(), "cross_attn": attn(),
                        "ln2": zeros(), "mlp": mlp()}
                       for _ in range(cfg.n_layers)],
        "enc_norm": zeros(),
        "final_norm": zeros(),
        "lm_head": L.randn((d, vp), d ** -0.5, dtype, g, dev),
    }
    return EncDecLM(params).requires_grad_(trainable)


def _proj(x, w):
    return torch.einsum("bld,dhk->blhk", x, w)


def _with_positions(h):
    pos = L.sinusoidal_positions(h.shape[1], h.shape[2], h.device)
    return h + pos.to(h.dtype)[None]


def _enc_layer(p: EncBlock, cfg: ModelConfig, h):
    x = L.rms_norm(h, p.ln1, cfg.rms_eps)
    q, k, v = (_proj(x, p.attn[w]) for w in ("wq", "wk", "wv"))
    t = h.shape[1]
    o = ops.gqa_flash_attention(q, k, v, causal=False, tq=t, tk=t,
                                device=h.device)
    h = h + L.attn_out(p.attn, o)
    return h + L.mlp(p.mlp, L.rms_norm(h, p.ln2, cfg.rms_eps))


def encode(model: EncDecLM, cfg: ModelConfig, frames):
    """frames: (B, T, D), the stub frontend's embeddings -> the encoder's
    output (B, T, D), final-normed."""
    h = _with_positions(frames.to(torch_dtype(cfg)))
    for p in model.enc_layers:
        h = remat(cfg, _enc_layer, p, cfg, h)
    return L.rms_norm(h, model.enc_norm, cfg.rms_eps)


def _dec_layer(p: DecBlock, cfg: ModelConfig, h, enc_out):
    """One decoder layer: (h, the entries the cache keeps of it)."""
    x = L.rms_norm(h, p.ln1, cfg.rms_eps)
    q, k, v = (_proj(x, p.self_attn[w]) for w in ("wq", "wk", "wv"))
    o = ops.gqa_flash_attention(q, k, v, causal=True, tq=cfg.attn_chunk,
                                tk=cfg.attn_chunk, device=h.device)
    h = h + L.attn_out(p.self_attn, o)
    x = L.rms_norm(h, p.ln_x, cfg.rms_eps)
    ke = _proj(enc_out, p.cross_attn["wk"])
    ve = _proj(enc_out, p.cross_attn["wv"])
    o = L.plain_attention(_proj(x, p.cross_attn["wq"]), ke, ve,
                          bidirectional=True)
    h = h + L.attn_out(p.cross_attn, o)
    h = h + L.mlp(p.mlp, L.rms_norm(h, p.ln2, cfg.rms_eps))
    return h, {"self_k": k, "self_v": v, "cross_k": ke, "cross_v": ve}


def encdec_forward(model: EncDecLM, cfg: ModelConfig, frames, tokens):
    """The full forward: the decoder's final-normed hidden states."""
    enc_out = encode(model, cfg, frames)
    h = _with_positions(embed_tokens(model, tokens))

    def layer(p, h):
        return _dec_layer(p, cfg, h, enc_out)[0]
    for p in model.dec_layers:
        h = remat(cfg, layer, p, h)
    return L.rms_norm(h, model.final_norm, cfg.rms_eps)


def encdec_loss(model: EncDecLM, cfg: ModelConfig, batch):
    """(loss, {"xent"}) of {"frames", "tokens", "targets"[, "mask"]}."""
    h = encdec_forward(model, cfg, batch["frames"], batch["tokens"])
    loss = softmax_xent(logits_fn(model, cfg, h), batch["targets"],
                        batch_mask(batch))
    return loss, {"xent": loss}


def encdec_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero caches: self-attention K and V of capacity `seq_len`, cross
    K and V over the config's `n_audio_frames` frames."""
    dev, dtype = resolve(device), torch_dtype(cfg)
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return {k: torch.zeros((cfg.n_layers, batch, seq_len if
                            k.startswith("self") else cfg.n_audio_frames)
                           + kv, dtype=dtype, device=dev)
            for k in CACHE_KEYS}


def encdec_prefill(model: EncDecLM, cfg: ModelConfig, frames, tokens,
                   seq_len: int):
    """Encode the frames and run the decoder over the prompt into a
    preallocated cache of capacity `seq_len`. Returns (last-position
    logits (B, 1, V), cache)."""
    enc_out = encode(model, cfg, frames)
    h = _with_positions(embed_tokens(model, tokens))
    b, l, _ = h.shape
    cache = encdec_init_cache(cfg.replace(n_audio_frames=enc_out.shape[1]),
                              b, seq_len, h.device)
    for i, p in enumerate(model.dec_layers):
        h, entries = _dec_layer(p, cfg, h, enc_out)
        for k, x in entries.items():
            cache[k][i, :, :x.shape[1]] = x
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h[:, -1:]), cache


def encdec_decode_step(model: EncDecLM, cfg: ModelConfig, cache, tokens,
                       pos: int):
    """tokens: (B, 1) at position `pos`. Writes the token's self-attention
    K and V into the cache in place; returns (logits (B, 1, V), cache)."""
    h = embed_tokens(model, tokens)
    pe = L.sinusoidal_positions(cache["self_k"].shape[2], cfg.d_model,
                                h.device)
    h = h + pe[pos][None, None].to(h.dtype)
    for i, p in enumerate(model.dec_layers):
        kc, vc = cache["self_k"][i], cache["self_v"][i]
        x = L.rms_norm(h, p.ln1, cfg.rms_eps)
        q, k, v = (_proj(x, p.self_attn[w]) for w in ("wq", "wk", "wv"))
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        h = h + L.attn_out(p.self_attn, L.decode_attention(q, kc, vc, pos))
        x = L.rms_norm(h, p.ln_x, cfg.rms_eps)
        o = L.plain_attention(_proj(x, p.cross_attn["wq"]),
                              cache["cross_k"][i], cache["cross_v"][i],
                              bidirectional=True)
        h = h + L.attn_out(p.cross_attn, o)
        h = h + L.mlp(p.mlp, L.rms_norm(h, p.ln2, cfg.rms_eps))
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h), cache
