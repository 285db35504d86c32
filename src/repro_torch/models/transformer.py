"""What the hybrid's shared attention blocks need of the reference's
decoder (`models/transformer.py`): the padded vocabulary, dense-layer
init (GQA attention and SwiGLU MLP; no MLA, no MoE), embedding, logits,
the attention and FFN blocks, and the one-token GQA layer for decode.

The hybrid's configs have no QKV bias and untied embeddings, so neither
is ported. A block's parameters are a `DenseBlock` module; its prefill
attention runs through `kernels/ops.gqa_flash_attention` (the
`flash_attention` kernel on the card, its plain version on the CPU) at
the tile the reference's chunked attention uses, `min(cfg.attn_chunk,
L)`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

VOCAB_PAD = 256
F32 = torch.float32


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def frozen(params: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    """A ParameterDict of inference-only parameters."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class DenseBlock(nn.Module):
    """One attention + MLP block: `ln1`, `attn` {wq, wk, wv, wo}, `ln2`,
    `mlp` {wi, wg, wo}, as the reference's `init_dense_layer` lays them
    out."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"], requires_grad=False)
        self.attn = frozen(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"], requires_grad=False)
        self.mlp = frozen(params["mlp"])


def init_dense_layer(cfg: ModelConfig, dtype, generator, device
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random parameters at the reference's scales (its `init_attn` and
    `init_mlp`), drawn from `generator` on `device`."""
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff = cfg.resolved_head_dim, cfg.d_ff

    def mat(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=F32) * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {"wq": mat((d, h, hd), d ** -0.5),
            "wk": mat((d, hkv, hd), d ** -0.5),
            "wv": mat((d, hkv, hd), d ** -0.5),
            "wo": mat((h, hd, d), d ** -0.5)}
    return {"ln1": zeros(d), "attn": attn, "ln2": zeros(d),
            "mlp": {"wi": mat((d, ff), d ** -0.5),
                    "wg": mat((d, ff), d ** -0.5),
                    "wo": mat((ff, d), ff ** -0.5)}}


def embed_tokens(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens]


def logits_fn(model: nn.Module, cfg: ModelConfig, h: torch.Tensor):
    logits = torch.einsum("bld,dv->blv", h, model.lm_head)
    vp = padded_vocab(cfg.vocab)
    if vp != cfg.vocab:
        mask = torch.arange(vp, device=h.device) < cfg.vocab
        logits = torch.where(mask, logits, L._neg_inf(logits))
    return logits


def attn_block(p: DenseBlock, cfg: ModelConfig, h, *, positions):
    x = L.rms_norm(h, p.ln1, cfg.rms_eps)
    q, k, v = L.attn_qkv(p.attn, x, positions, cfg.rope_theta)
    o = ops.gqa_flash_attention(q, k, v, causal=True, tq=cfg.attn_chunk,
                                tk=cfg.attn_chunk, device=h.device)
    return h + L.attn_out(p.attn, o)


def ffn_block(p: DenseBlock, cfg: ModelConfig, h):
    x = L.rms_norm(h, p.ln2, cfg.rms_eps)
    return h + L.mlp(p.mlp, x)


def _gqa_layer_decode(p: DenseBlock, cfg: ModelConfig, h, k_cache,
                      v_cache, pos: int):
    """One token through an attention + MLP block. Writes the token's K
    and V into `k_cache`/`v_cache` (B, S, Hkv, D) at `pos` in place."""
    x = L.rms_norm(h, p.ln1, cfg.rms_eps)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=h.device)
    q, k, v = L.attn_qkv(p.attn, x, positions, cfg.rope_theta)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    o = L.decode_attention(q, k_cache, v_cache, pos)
    h = h + L.attn_out(p.attn, o)
    return ffn_block(p, cfg, h)
