"""Zamba2-style hybrid: a Mamba2 backbone with alternating *shared*
attention blocks applied after every `shared_attn_period` Mamba layers
(a port of the reference's `models/hybrid.py` for serving, and its loss
`hybrid_loss`: the full forward, each Mamba layer and each shared-block
call under `transformer.remat`, differentiated on the card through the
scan's and the attention's backward kernels).

Layer layout for n_layers=81, period=6:
  13 groups of (6 Mamba layers + shared block[i % 2]) + 3 tail Mamba
The model is a `HybridLM` module: `mamba` holds every Mamba layer in
order (the reference's `mamba_groups` (13, 6, ...) then `mamba_tail`),
`shared` the 2 shared blocks. The cache keeps every Mamba layer's state
stacked on a leading layer axis (81) and one K/V cache per shared-block
*invocation* (13), as the reference does, though the weights are shared.
Prefill fills a preallocated cache and decode updates it in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.transformer import (DenseBlock, attn_block,
                                            batch_mask, embed_tokens,
                                            ffn_block, frozen,
                                            init_dense_layer, logits_fn,
                                            padded_vocab, remat,
                                            softmax_xent, torch_dtype,
                                            _gqa_layer_decode)

F32 = torch.float32
# Mamba leaves the reference keeps in float32 whatever the model's dtype
F32_LEAVES = ("A_log", "dt_bias", "D")


def split_counts(cfg: ModelConfig):
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    n_tail = cfg.n_layers - n_groups * period
    return period, n_groups, n_tail


class MambaLayer(nn.Module):
    """A pre-norm Mamba2 layer: `ln` and the `mamba` parameters."""

    def __init__(self, params: Dict):
        super().__init__()
        self.ln = nn.Parameter(params["ln"], requires_grad=False)
        self.mamba = frozen(params["mamba"])


class HybridLM(nn.Module):
    """The hybrid's parameters (inference only)."""

    def __init__(self, params: Dict):
        super().__init__()
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.mamba = nn.ModuleList(MambaLayer(p) for p in params["mamba"])
        self.shared = nn.ModuleList(DenseBlock(p) for p in params["shared"])
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)


def init_hybrid(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, trainable: bool = False
                ) -> HybridLM:
    """Random parameters at the reference's scales, drawn on the device
    from `generator` (a fresh one seeded 0 when None), frozen unless
    `trainable`."""
    dev = resolve(device)
    g = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg)
    vp = padded_vocab(cfg.vocab)

    def mat(shape, scale):
        return (torch.randn(shape, generator=g, device=dev, dtype=F32)
                * scale).to(dtype)

    params = {
        "embed": mat((vp, cfg.d_model), cfg.d_model ** -0.5),
        "mamba": [{"ln": torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=dev),
                   "mamba": M.init_mamba(cfg.d_model, cfg.ssm, dtype, g, dev)}
                  for _ in range(cfg.n_layers)],
        "shared": [init_dense_layer(cfg, dtype, g, dev)
                   for _ in range(cfg.n_shared_blocks)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "lm_head": mat((cfg.d_model, vp), cfg.d_model ** -0.5),
    }
    return HybridLM(params).requires_grad_(trainable)


def _mamba_layer(p: MambaLayer, cfg, h, *, return_state=False):
    x = L.rms_norm(h, p.ln, cfg.rms_eps)
    if return_state:
        y, st = M.mamba_forward(p.mamba, x, cfg.ssm, return_state=True)
        return h + y, st
    return h + M.mamba_forward(p.mamba, x, cfg.ssm)


def _shared_block_fwd(p: DenseBlock, cfg, h, positions):
    h = attn_block(p, cfg, h, positions=positions)
    return ffn_block(p, cfg, h)


def _layout(cfg: ModelConfig):
    """Yield ('mamba', layer index) and ('shared', invocation, block)
    in the order the model runs them."""
    period, n_groups, n_tail = split_counts(cfg)
    for gi in range(n_groups):
        for j in range(period):
            yield "mamba", gi * period + j
        yield "shared", gi, gi % cfg.n_shared_blocks
    for j in range(n_tail):
        yield "mamba", n_groups * period + j


def hybrid_forward(model: HybridLM, cfg: ModelConfig, tokens):
    """The full forward (no cache): final-normed hidden states."""
    h = embed_tokens(model, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for step in _layout(cfg):
        if step[0] == "mamba":
            h = remat(cfg, lambda p, h: _mamba_layer(p, cfg, h),
                      model.mamba[step[1]], h)
        else:
            h = remat(cfg, lambda p, h: _shared_block_fwd(p, cfg, h,
                                                          positions),
                      model.shared[step[2]], h)
    return L.rms_norm(h, model.final_norm, cfg.rms_eps)


def hybrid_loss(model: HybridLM, cfg: ModelConfig, batch):
    """(loss, {"xent": loss}) of {"tokens", "targets"[, "mask"]}."""
    h = hybrid_forward(model, cfg, batch["tokens"])
    loss = softmax_xent(logits_fn(model, cfg, h), batch["targets"],
                        batch_mask(batch))
    return loss, {"xent": loss}


# --------------------------------------------------------------- serving

def hybrid_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero decode state: per Mamba layer `ssm` (n_layers, B, H, N, P)
    float32 and the conv windows `conv_x/B/C` (n_layers, B, d_conv-1, C);
    per shared-block invocation `attn_k/v` (n_groups, B, S, Hkv, D)."""
    dev = resolve(device)
    _, n_groups, _ = split_counts(cfg)
    dtype = torch_dtype(cfg)
    st = M.mamba_init_state(batch, cfg.d_model, cfg.ssm, dtype, dev)
    cache = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
             for k, v in st.items()}
    kv = (n_groups, batch, seq_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache["attn_k"] = torch.zeros(kv, dtype=dtype, device=dev)
    cache["attn_v"] = torch.zeros(kv, dtype=dtype, device=dev)
    return cache


def hybrid_prefill(model: HybridLM, cfg: ModelConfig, tokens, seq_len: int):
    """Prefill: the full forward that also fills a decode-ready cache of
    capacity `seq_len`: each SSD scan's final state is its layer's SSM
    state, and each shared-block invocation writes its K/V. Returns
    (last-position logits (B, 1, V), cache)."""
    h = embed_tokens(model, tokens)
    b, l, _ = h.shape
    positions = torch.arange(l, device=h.device)[None, :]
    cache = hybrid_init_cache(cfg, b, seq_len, h.device)
    for step in _layout(cfg):
        if step[0] == "mamba":
            li = step[1]
            h, st = _mamba_layer(model.mamba[li], cfg, h, return_state=True)
            for k, v in st.items():
                cache[k][li] = v
            continue
        gi, sp = step[1], model.shared[step[2]]
        x = L.rms_norm(h, sp.ln1, cfg.rms_eps)
        k = torch.einsum("bld,dhk->blhk", x, sp.attn["wk"])
        v = torch.einsum("bld,dhk->blhk", x, sp.attn["wv"])
        cache["attn_k"][gi, :, :l] = L.apply_rope(k, positions,
                                                   cfg.rope_theta)
        cache["attn_v"][gi, :, :l] = v
        h = _shared_block_fwd(sp, cfg, h, positions)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h[:, -1:]), cache


def _mamba_layer_decode(p: MambaLayer, cfg, h, state):
    x = L.rms_norm(h, p.ln, cfg.rms_eps)
    y, state = M.mamba_decode_step(p.mamba, x, state, cfg.ssm)
    return h + y, state


def hybrid_decode_step(model: HybridLM, cfg: ModelConfig, cache, tokens,
                       pos: int):
    """One token per sequence at position `pos`. Updates `cache` in place
    and returns (logits (B, 1, V), cache)."""
    h = embed_tokens(model, tokens)
    for step in _layout(cfg):
        if step[0] == "mamba":
            li = step[1]
            state = {k: cache[k][li] for k in ("ssm", "conv_x", "conv_B",
                                               "conv_C")}
            h, state = _mamba_layer_decode(model.mamba[li], cfg, h, state)
            for k, v in state.items():
                cache[k][li] = v
        else:
            gi = step[1]
            h = _gqa_layer_decode(model.shared[step[2]], cfg, h,
                                  cache["attn_k"][gi], cache["attn_v"][gi],
                                  pos)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h), cache
