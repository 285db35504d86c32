"""Decoder-only LM, the dense family (Qwen2, Qwen2.5, Minitron, and
Gemma3 with its 5:1 local:global attention): a port
of the reference's `models/transformer.py` for serving and training
(`decoder_loss`, `softmax_xent`), and the blocks the hybrid's shared
attention reuses.

The model is a `DecoderLM` module: `embed`, `layers` (one `DenseBlock`
per layer: the reference's `dense_layers` stacked on a leading layer
axis, or on (n_groups, global_every) axes with local:global attention,
unstacked), `final_norm`, and `lm_head` only when the embedding is not
tied (tied: the logits use `embed.T`). The cache keeps every layer's K
and V stacked on a leading layer axis, (n_layers, B, S, Hkv, D) (the
reference groups it as the parameters; `convert.py` maps the layouts);
prefill fills a preallocated cache and decode updates it in place. With
`global_every` g > 1 and a `window`, layer i is local, attending to the
last `window` positions, unless i % g == g - 1 (`layer_windows`, the
reference's pattern); like the reference's, the cache holds every
position of a local layer too. Layers run in a Python loop
(`scan_layers_carry` has the reference's `unroll=True` semantics; torch
has no scan).

Prefill attention runs through `kernels/ops.gqa_flash_attention`: the
`flash_attention` kernel on the card, its plain version on the CPU, at
the tile of the reference's chunked attention, `min(cfg.attn_chunk, L)`.
`cfg.attn_impl` and `cfg.prefill_triangle_skip` pick among the
reference's jnp forms of that one function (plain, chunked over every KV
tile, chunked up to the diagonal); on the card every one of them runs
the kernel, which stops at the diagonal as the reference's Pallas kernel
does. On the CPU `attn_impl="plain"` runs `layers.plain_attention`, the
rest the kernel's plain version. A local layer passes its window to the
kernel, which then also reads no key below the reference's windowed
chunk bound (`kernels/flash_attention.py`); `attn_impl="plain"` has an
exact window with no tile bound, which the kernel gives at a tile of 1
on the card. Decode is plain torch, as in the reference, each layer
masked by its own window.

Training: parameters are built frozen for serving; `trainable=True` (or
`requires_grad_()` on the module) makes them trainable. The loss runs
the same forward; its attention's backward is the `flash_attention_bwd`
kernel on the card (`kernels/flash_attention.py::FlashAttention`). With
`cfg.remat` and autograd recording, each layer runs under
`torch.utils.checkpoint` (`remat`), as the reference's `jax.checkpoint`
wraps each layer: its activations are recomputed in the backward.

Not served yet, each raising NotImplementedError with its open item of
ROADMAP.md: MoE, MLA and multi-token prediction (13d), prepended patches
(13e).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L

VOCAB_PAD = 256
F32 = torch.float32


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def frozen(params: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    """A ParameterDict of inference-only parameters."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class DenseBlock(nn.Module):
    """One attention + MLP block: `ln1`, `attn` {wq, wk, wv, wo, and
    bq, bk, bv with a QKV bias}, `ln2`, `mlp` {wi, wg, wo}, as the
    reference's `init_dense_layer` lays them out."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"], requires_grad=False)
        self.attn = frozen(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"], requires_grad=False)
        self.mlp = frozen(params["mlp"])


class DecoderLM(nn.Module):
    """The dense decoder's parameters (inference only)."""

    def __init__(self, params: Dict):
        super().__init__()
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(DenseBlock(p) for p in params["layers"])
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"],
                                        requires_grad=False)


def check_served(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the dense decoder does not
    serve yet, naming the open item of ROADMAP.md that ports it."""
    for what in ("moe", "mla", "use_mtp"):
        if getattr(cfg, what):
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP.md, open "
                f"item 13d)")


def _no_patches(patches) -> None:
    if patches is not None:
        raise NotImplementedError("prepended patches (the VLM family) are "
                                  "not ported yet (ROADMAP.md, open item "
                                  "13e)")


def init_dense_layer(cfg: ModelConfig, dtype, generator, device
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random parameters at the reference's scales (its `init_attn`, with
    the QKV bias's zeros where `cfg.qkv_bias`, and `init_mlp`), drawn
    from `generator` on `device`."""
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
    if cfg.qkv_bias:
        attn.update(bq=zeros(h, hd), bk=zeros(hkv, hd), bv=zeros(hkv, hd))
    return {"ln1": zeros(d), "attn": attn, "ln2": zeros(d),
            "mlp": {"wi": mat((d, ff), d ** -0.5),
                    "wg": mat((d, ff), d ** -0.5),
                    "wo": mat((ff, d), ff ** -0.5)}}


def init_decoder(cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None,
                 trainable: bool = False) -> DecoderLM:
    """Random parameters at the reference's scales, drawn on the device
    from `generator` (a fresh one seeded 0 when None), frozen unless
    `trainable`. Each matrix is drawn in float32 and cast, so the largest
    transient is the float32 embedding."""
    check_served(cfg)
    dev = resolve(device)
    g = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dtype = torch_dtype(cfg)
    vp = padded_vocab(cfg.vocab)

    def mat(shape, scale):
        return (torch.randn(shape, generator=g, device=dev, dtype=F32)
                * scale).to(dtype)

    params = {"embed": mat((vp, cfg.d_model), cfg.d_model ** -0.5),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat((cfg.d_model, vp), cfg.d_model ** -0.5)
    params["layers"] = [init_dense_layer(cfg, dtype, g, dev)
                        for _ in range(cfg.n_layers)]
    return DecoderLM(params).requires_grad_(trainable)


# ------------------------------------------------------------------ blocks

def remat(cfg: ModelConfig, fn, *args):
    """fn(*args), under torch.utils.checkpoint when `cfg.remat` and
    autograd records (the reference's per-layer `jax.checkpoint`)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed_tokens(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens]


def logits_fn(model: nn.Module, cfg: ModelConfig, h: torch.Tensor):
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = torch.einsum("bld,dv->blv", h, w)
    vp = padded_vocab(cfg.vocab)
    if vp != cfg.vocab:
        mask = torch.arange(vp, device=h.device) < cfg.vocab
        logits = torch.where(mask, logits, L._neg_inf(logits))
    return logits


def layer_windows(cfg: ModelConfig) -> list:
    """Each layer's sliding window, 0 for a global layer: the reference's
    `_window_for`, gemma3's pattern (positions 0..g-2 of each group of
    g = `global_every` local, g-1 global; with g <= 1 all global)."""
    g = cfg.global_every or 1
    if g == 1 or cfg.window == 0:
        return [0] * cfg.n_layers
    return [cfg.window if i % g < g - 1 else 0 for i in range(cfg.n_layers)]


def _self_attention(p: DenseBlock, cfg: ModelConfig, h, positions,
                    window: int = 0):
    """The attention half of a block: (h + attention, k, v), k rotated
    as the cache keeps it. `window`: the layer's sliding window (0:
    global)."""
    x = L.rms_norm(h, p.ln1, cfg.rms_eps)
    q, k, v = L.attn_qkv(p.attn, x, positions, cfg.rope_theta)
    if cfg.attn_impl == "plain" and h.device.type == "cpu":
        o = L.plain_attention(q, k, v, causal=True, window=window)
    else:
        # the plain form's window is exact: a tile of one key bounds
        # nothing
        t = 1 if window and cfg.attn_impl == "plain" else cfg.attn_chunk
        o = ops.gqa_flash_attention(q, k, v, causal=True, tq=t, tk=t,
                                    window=window, device=h.device)
    return h + L.attn_out(p.attn, o), k, v


def attn_block(p: DenseBlock, cfg: ModelConfig, h, *, positions):
    return _self_attention(p, cfg, h, positions)[0]


def ffn_block(p: DenseBlock, cfg: ModelConfig, h):
    x = L.rms_norm(h, p.ln2, cfg.rms_eps)
    return h + L.mlp(p.mlp, x)


# ----------------------------------------------------------------- forward

def decoder_hidden(model: DecoderLM, cfg: ModelConfig, h, positions):
    """Run all layers over h: (B, L, D). Returns (h, aux loss sum): the
    aux loss is the MoE router's, 0.0 for the dense family."""
    def layer(p, h, window):
        h = _self_attention(p, cfg, h, positions, window)[0]
        return ffn_block(p, cfg, h)

    for p, window in zip(model.layers, layer_windows(cfg)):
        h = remat(cfg, layer, p, h, window)
    return h, 0.0


def decoder_forward(model: DecoderLM, cfg: ModelConfig, tokens,
                    patches=None):
    """The full forward (no cache): (final-normed hidden states, aux)."""
    _no_patches(patches)
    h = embed_tokens(model, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, aux = decoder_hidden(model, cfg, h, positions)
    return L.rms_norm(h, model.final_norm, cfg.rms_eps), aux


def softmax_xent(logits, targets, mask):
    """Mean token cross-entropy: logits (B, L, V) in float32 (log-sum-exp
    over the padded vocabulary, whose pad `logits_fn` masks), targets
    (B, L) ints, mask (B, L) weights."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def batch_mask(batch) -> torch.Tensor:
    """The batch's "mask", or ones over its targets."""
    mask = batch.get("mask")
    if mask is None:
        t = batch["targets"]
        mask = torch.ones(t.shape, dtype=F32, device=t.device)
    return mask


def decoder_loss(model: DecoderLM, cfg: ModelConfig, batch):
    """(loss, {"xent": loss}) of {"tokens", "targets"[, "mask"]} (B, L).
    MoE aux losses and multi-token prediction are refused with the rest
    of 13d by `check_served`."""
    h, _ = decoder_forward(model, cfg, batch["tokens"], batch.get("patches"))
    loss = softmax_xent(logits_fn(model, cfg, h), batch["targets"],
                        batch_mask(batch))
    return loss, {"xent": loss}


# ------------------------------------------------------------------ decode

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero K and V caches, (n_layers, B, seq_len, Hkv, D) each."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve(device)
    return {k: torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)
            for k in ("k", "v")}


def _gqa_layer_decode(p: DenseBlock, cfg: ModelConfig, h, k_cache,
                      v_cache, pos: int, window: int = 0):
    """One token through an attention + MLP block. Writes the token's K
    and V into `k_cache`/`v_cache` (B, S, Hkv, D) at `pos` in place."""
    x = L.rms_norm(h, p.ln1, cfg.rms_eps)
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=h.device)
    q, k, v = L.attn_qkv(p.attn, x, positions, cfg.rope_theta)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    o = L.decode_attention(q, k_cache, v_cache, pos, window=window)
    h = h + L.attn_out(p.attn, o)
    return ffn_block(p, cfg, h)


def scan_layers_carry(body, h, layers, state: Dict[str, torch.Tensor]):
    """Iterate layers with the decode state carried: `state` holds each
    leaf stacked on a leading layer axis, and body(h, layer, state_l) ->
    (h, new_state_l) gets layer li's views. A leaf the body returns as
    the view it was given was updated in place; any other is written
    into its layer's slot, cast to the leaf's dtype."""
    for li, p in enumerate(layers):
        state_l = {k: s[li] for k, s in state.items()}
        h, new_l = body(h, p, state_l)
        for k, s in new_l.items():
            if s is not state_l[k]:
                state[k][li] = s
    return h, state


def decode_step(model: DecoderLM, cfg: ModelConfig, cache, tokens,
                pos: int):
    """tokens: (B, 1) at position `pos`. Updates `cache` in place and
    returns (logits (B, 1, V), cache)."""
    h = embed_tokens(model, tokens)
    layers = list(zip(model.layers, layer_windows(cfg)))

    def body(h, layer, c):
        p, window = layer
        return _gqa_layer_decode(p, cfg, h, c["k"], c["v"], pos, window), c

    h, cache = scan_layers_carry(body, h, layers, cache)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h), cache


def prefill(model: DecoderLM, cfg: ModelConfig, tokens, seq_len: int,
            patches=None):
    """Forward the prompt into a preallocated cache of capacity
    `seq_len`, each layer writing the K and V its attention used.
    Returns (last-position logits (B, 1, V), cache)."""
    _no_patches(patches)
    h = embed_tokens(model, tokens)
    b, l, _ = h.shape
    positions = torch.arange(l, device=h.device)[None, :]
    cache = init_cache(cfg, b, seq_len, h.device)
    for i, (p, window) in enumerate(zip(model.layers, layer_windows(cfg))):
        h, k, v = _self_attention(p, cfg, h, positions, window)
        cache["k"][i, :, :l] = k
        cache["v"][i, :, :l] = v
        h = ffn_block(p, cfg, h)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h[:, -1:]), cache
