"""Pure Mamba2 LM (attention-free, Mamba2-1.3B): a port of the
reference's `models/ssm.py` for serving, and its loss (`ssm_loss`).

The model is an `SSMLM` module: `embed`, `layers` (one pre-norm
`MambaLayer` per layer: the reference's stacked `layers`, unstacked),
`final_norm`, and `lm_head` only when the embedding is not tied. Each
layer's prefill scan runs through `models/mamba.py` (the `ssd_scan`
kernel on the card, its plain version on the CPU); decode is the O(1)
recurrence in plain torch. The cache is every layer's
`mamba_init_state` stacked on a leading layer axis: `ssm` (n_layers, B,
H, N, P) float32 and the conv windows `conv_x/B/C` (n_layers, B,
d_conv-1, C); its size does not grow with the sequence. Prefill fills a
preallocated cache and decode updates it in place. The loss runs the
full forward, each layer under `transformer.remat`; it differentiates
on the card through the scan's autograd Function (the forward kernel,
recomputed under remat, then `ssd_scan_bwd`) and on the CPU through its
plain versions.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.hybrid import (MambaLayer, _mamba_layer,
                                       _mamba_layer_decode)
from repro_torch.models.transformer import (batch_mask, embed_tokens,
                                            logits_fn, padded_vocab, remat,
                                            scan_layers_carry, softmax_xent,
                                            torch_dtype)

F32 = torch.float32


class SSMLM(nn.Module):
    """The Mamba2 LM's parameters (inference only)."""

    def __init__(self, params: Dict):
        super().__init__()
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(MambaLayer(p) for p in params["layers"])
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"],
                                        requires_grad=False)


def init_ssm_lm(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, trainable: bool = False) -> SSMLM:
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

    params = {"embed": mat((vp, cfg.d_model), cfg.d_model ** -0.5),
              "layers": [{"ln": torch.zeros((cfg.d_model,), dtype=dtype,
                                            device=dev),
                          "mamba": M.init_mamba(cfg.d_model, cfg.ssm, dtype,
                                                g, dev)}
                         for _ in range(cfg.n_layers)],
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat((cfg.d_model, vp), cfg.d_model ** -0.5)
    return SSMLM(params).requires_grad_(trainable)


def ssm_forward(model: SSMLM, cfg: ModelConfig, tokens):
    """The full forward (no cache): final-normed hidden states."""
    h = embed_tokens(model, tokens)
    for p in model.layers:
        h = remat(cfg, lambda p, h: _mamba_layer(p, cfg, h), p, h)
    return L.rms_norm(h, model.final_norm, cfg.rms_eps)


def ssm_loss(model: SSMLM, cfg: ModelConfig, batch):
    """(loss, {"xent": loss}) of {"tokens", "targets"[, "mask"]}."""
    h = ssm_forward(model, cfg, batch["tokens"])
    loss = softmax_xent(logits_fn(model, cfg, h), batch["targets"],
                        batch_mask(batch))
    return loss, {"xent": loss}


def ssm_init_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero decode state, every layer's stacked. `seq_len` is unused:
    the state is O(1) in the sequence, the SSM's long-context win."""
    del seq_len
    st = M.mamba_init_state(batch, cfg.d_model, cfg.ssm, torch_dtype(cfg),
                            resolve(device))
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in st.items()}


def ssm_prefill(model: SSMLM, cfg: ModelConfig, tokens, seq_len: int):
    """Forward the prompt; each layer's scan leaves its final state and
    conv windows in the cache. Returns (last-position logits (B, 1, V),
    cache)."""
    h = embed_tokens(model, tokens)
    cache = ssm_init_cache(cfg, h.shape[0], seq_len, h.device)
    for li, p in enumerate(model.layers):
        h, st = _mamba_layer(p, cfg, h, return_state=True)
        for k, v in st.items():
            cache[k][li] = v
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h[:, -1:]), cache


def ssm_decode_step(model: SSMLM, cfg: ModelConfig, cache, tokens,
                    pos: int):
    """One token per sequence (the recurrence needs no position).
    Updates `cache` in place and returns (logits (B, 1, V), cache)."""
    del pos
    h = embed_tokens(model, tokens)

    def body(h, p, st):
        return _mamba_layer_decode(p, cfg, h, st)

    h, cache = scan_layers_carry(body, h, model.layers, cache)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h), cache
