"""Decoder-only LM, the dense, MoE and VLM families (Qwen2, Qwen2.5,
Minitron, Gemma3 with its 5:1 local:global attention; Qwen2-MoE, and
DeepSeek-V3 with multi-head latent attention and multi-token
prediction; LLaVA-NeXT, image patches prepended): a port of the
reference's `models/transformer.py` for serving and training
(`decoder_loss`, `softmax_xent`), and the blocks the hybrid's shared
attention reuses.

The model is a `DecoderLM` module: `embed`, `layers`, `final_norm`,
`lm_head` only when the embedding is not tied (tied: the logits use
`embed.T`), and `mtp` {`proj`, `layer`, `norm`} with multi-token
prediction. `layers` holds the reference's `dense_layers` (stacked on a
leading layer axis, or on (n_groups, global_every) axes with
local:global attention) unstacked, one `DenseBlock` each, then its
`moe_layers`, one `MoEBlock` each (`layer_counts`: an MoE config's
`n_dense_layers` lead). A block's attention is GQA, or MLA where
`cfg.mla` (`models/mla.py`); an `MoEBlock`'s FFN is `models/moe.py`'s,
whose router aux losses `decoder_hidden` sums. The cache keeps every
layer's entries stacked on a leading layer axis: K and V (n_layers, B,
S, Hkv, D), or MLA's latents c_kv (n_layers, B, S, kv_lora_rank) and
k_rope (n_layers, B, S, rope_dim) (the reference groups it as the
parameters, `dense` and `moe`; `convert.py` maps the layouts); prefill
fills a preallocated cache and decode updates it in place. With
`global_every` g > 1 and a `window`, layer i is local, attending to the
last `window` positions, unless i % g == g - 1 (`layer_windows`, the
reference's pattern); like the reference's, the cache holds every
position of a local layer too. Layers run in a Python loop
(`scan_layers_carry` has the reference's `unroll=True` semantics; torch
has no scan).

Prefill attention runs through `kernels/ops.gqa_flash_attention`: the
`flash_attention` kernel on the card, its plain version on the CPU, at
the tile of the reference's chunked attention, `min(cfg.attn_chunk, L)`
(MLA's at the q·k width with V zero-padded to it, 192 for DeepSeek-V3).
`cfg.attn_impl` and `cfg.prefill_triangle_skip` pick among the
reference's jnp forms of that one function (plain, chunked over every KV
tile, chunked up to the diagonal); on the card every one of them runs
the kernel, which stops at the diagonal as the reference's Pallas kernel
does. On the CPU `attn_impl="plain"` runs `layers.plain_attention`, the
rest the kernel's plain version (MLA ignores `attn_impl`, as the
reference's does). A local layer passes its window to the kernel, which
then also reads no key below the reference's windowed chunk bound
(`kernels/flash_attention.py`); `attn_impl="plain"` has an exact window
with no tile bound, which the kernel gives at a tile of 1 on the card.
Decode is plain torch, as in the reference, each layer masked by its
own window; MLA's is absorbed, in float32.

Training: parameters are built frozen for serving; `trainable=True` (or
`requires_grad_()` on the module) makes them trainable. The loss runs
the same forward; its attention's backward is the `flash_attention_bwd`
kernel on the card (`kernels/flash_attention.py::FlashAttention`). With
`cfg.remat` and autograd recording, each layer runs under
`torch.utils.checkpoint` (`remat`), as the reference's `jax.checkpoint`
wraps each layer: its activations are recomputed in the backward.
`decoder_loss` adds the router aux loss (MoE) and the multi-token
prediction loss (MTP) to the cross-entropy, as the reference's does.

Tensor parallelism (the dense family on a mesh whose model axis is
above 1, `launch/train.py`): the parameters are DTensors split by the
reference's rules, and the forward places activations where the
reference's `shard_act` calls do (the embedding's output, each layer's
input, the logits over the vocabulary), and replicates each norm's
output, so that every gradient reaching a norm is whole. The embedding
lookup on a vocabulary-split table and the cross-entropy over
vocabulary-split logits run on each rank's piece (`local_map`): a row
outside a rank's piece reads zeros, and the log-sum-exp and the gold
logit are all-reduced over the model axis, so no rank gathers the (B,
L, V) logits.

The VLM family's frontend is a stub, as in the reference: precomputed
patch embeddings (B, P, D) are prepended to the token embeddings, in
`decoder_forward` and `prefill`, and take positions 0 .. P - 1; the
loss reads only the text positions. The cache then holds P + L
positions after the prefill, and decode's positions count the patches.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed.meshctx import (current_mesh, mesh_context,
                                             shard_act)
from repro_torch.distributed.sharding import is_dtensor, place_like
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE

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
    """One attention + MLP block: `ln1`, `attn` (GQA: {wq, wk, wv, wo,
    and bq, bk, bv with a QKV bias}; MLA: `mla.init_mla`'s leaves),
    `ln2`, `mlp` {wi, wg, wo}, as the reference's `init_dense_layer`
    lays them out."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"], requires_grad=False)
        self.attn = frozen(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"], requires_grad=False)
        self.mlp = frozen(params["mlp"])


class MoEBlock(nn.Module):
    """One attention + MoE block: `ln1`, `attn` (as `DenseBlock`'s),
    `ln2`, `moe` (`moe.MoEParams`), as the reference's `init_moe_layer`
    lays them out."""

    def __init__(self, params: Dict):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"], requires_grad=False)
        self.attn = frozen(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"], requires_grad=False)
        self.moe = MOE.MoEParams(params["moe"])


class MTPHead(nn.Module):
    """Depth-1 multi-token prediction: `proj` (2 D, D), `layer` (a dense
    `DenseBlock`) and `norm`."""

    def __init__(self, params: Dict):
        super().__init__()
        self.proj = nn.Parameter(params["proj"], requires_grad=False)
        self.layer = DenseBlock(params["layer"])
        self.norm = nn.Parameter(params["norm"], requires_grad=False)


class DecoderLM(nn.Module):
    """The decoder's parameters (inference only): a block a layer, the
    dense ones first, and the MTP head where the parameters have one."""

    def __init__(self, params: Dict):
        super().__init__()
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.layers = nn.ModuleList(
            MoEBlock(p) if "moe" in p else DenseBlock(p)
            for p in params["layers"])
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"],
                                        requires_grad=False)
        if "mtp" in params:
            self.mtp = MTPHead(params["mtp"])


def layer_counts(cfg: ModelConfig):
    """(dense layers, MoE layers): an MoE config's `n_dense_layers` lead,
    the rest are MoE; every layer of a config without MoE is dense."""
    if cfg.moe is None:
        return cfg.n_layers, 0
    return cfg.moe.n_dense_layers, cfg.n_layers - cfg.moe.n_dense_layers


def init_attention(cfg: ModelConfig, dtype, generator, device
                   ) -> Dict[str, torch.Tensor]:
    """A block's attention at the reference's scales: MLA's (`init_mla`)
    where `cfg.mla`, else GQA's (its `init_attn`, with the QKV bias's
    zeros where `cfg.qkv_bias`)."""
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    if cfg.mla:
        return MLA.init_mla(d, h, cfg.mla, dtype, generator, device)
    hd = cfg.resolved_head_dim

    def mat(shape, scale):
        return L.randn(shape, scale, dtype, generator, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {"wq": mat((d, h, hd), d ** -0.5),
            "wk": mat((d, hkv, hd), d ** -0.5),
            "wv": mat((d, hkv, hd), d ** -0.5),
            "wo": mat((h, hd, d), d ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(h, hd), bk=zeros(hkv, hd), bv=zeros(hkv, hd))
    return attn


def init_dense_layer(cfg: ModelConfig, dtype, generator, device,
                     moe: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A block's random parameters at the reference's scales
    (`init_attention`, then its `init_mlp`, or with `moe` its `init_moe`,
    the router float32), drawn from `generator` on `device`."""
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": zeros, "attn": init_attention(cfg, dtype, generator, device),
         "ln2": zeros.clone()}
    if moe:
        p["moe"] = MOE.init_moe(cfg.d_model, cfg.moe, dtype, generator,
                                device)
    else:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, dtype, generator,
                              device)
    return p


def init_decoder(cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None,
                 trainable: bool = False) -> DecoderLM:
    """Random parameters at the reference's scales, drawn on the device
    from `generator` (a fresh one seeded 0 when None), frozen unless
    `trainable`. Each matrix is drawn in float32 and cast (an expert
    stack one expert at a time), so the largest transient is the float32
    embedding."""
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
    n_dense, n_moe = layer_counts(cfg)
    params["layers"] = [init_dense_layer(cfg, dtype, g, dev, moe=i >= n_dense)
                        for i in range(n_dense + n_moe)]
    if cfg.use_mtp:
        d = cfg.d_model
        params["mtp"] = {"proj": mat((2 * d, d), (2 * d) ** -0.5),
                         "layer": init_dense_layer(cfg.replace(moe=None),
                                                   dtype, g, dev),
                         "norm": torch.zeros((d,), dtype=dtype, device=dev)}
    return DecoderLM(params).requires_grad_(trainable)


# ------------------------------------------------------------------ blocks

def remat(cfg: ModelConfig, fn, *args):
    """fn(*args), under torch.utils.checkpoint when `cfg.remat` and
    autograd records (the reference's per-layer `jax.checkpoint`). The
    recompute runs in the backward, which autograd runs in a thread of
    its own for a CUDA tensor: it re-installs the mesh context installed
    now, so `shard_act` places its activations as the forward did."""
    if cfg.remat and torch.is_grad_enabled():
        mesh = current_mesh()
        if mesh is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), mesh_context(mesh)))
    return fn(*args)


def _split_dim(t, dim: int):
    """(mesh dim, this rank's first index, piece size) where the DTensor
    `t` is split on `dim`, else (None, 0, size)."""
    dim %= t.ndim
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim == dim:
            n = t.device_mesh.size(i)
            return i, t.device_mesh.get_local_rank(i) * (t.shape[dim] // n), \
                t.shape[dim] // n
    return None, 0, t.shape[dim]


def _lookup(w, tokens, first: int, rows: int):
    """Rows `tokens` - `first` of `w`, this rank's `rows` rows of the
    table; zeros for a token outside them."""
    t = tokens - first
    inside = (t >= 0) & (t < rows)
    h = F.embedding(torch.where(inside, t, 0), w)
    return torch.where(inside[..., None], h, torch.zeros((), dtype=h.dtype,
                                                         device=h.device))


def embed_tokens(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    w = model.embed
    if not is_dtensor(w):
        return w[tokens]
    from functools import partial

    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    i, first, rows = _split_dim(w, 0)
    out = [Partial() if j == i else Replicate()
           for j in range(w.device_mesh.ndim)]
    h = local_map(partial(_lookup, first=first, rows=rows),
                  out_placements=out, in_placements=(w.placements, None),
                  in_grad_placements=(w.placements, None),
                  device_mesh=w.device_mesh)(w, tokens)
    return shard_act(h, "batch", None, None)


def logits_fn(model: nn.Module, cfg: ModelConfig, h: torch.Tensor):
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = torch.einsum("bld,dv->blv", h, w)
    logits = shard_act(logits, "batch", None, "model")
    vp = padded_vocab(cfg.vocab)
    if vp != cfg.vocab:
        mask = place_like(torch.arange(vp, device=h.device) < cfg.vocab,
                          logits)
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


def _attention(p, cfg: ModelConfig, h, positions, window: int = 0):
    """The attention half of a block: (h + attention, the entries the
    cache keeps of it): GQA's {"k" (rotated), "v"}, or MLA's {"c_kv",
    "k_rope"}. `window`: the layer's sliding window (0: global)."""
    x = shard_act(L.rms_norm(h, p.ln1, cfg.rms_eps), "batch", None, None)
    if cfg.mla:
        o, (c_kv, k_rope) = MLA.mla_forward(p.attn, x, cfg.mla,
                                            cfg.rope_theta,
                                            chunk=cfg.attn_chunk)
        return h + o, {"c_kv": c_kv, "k_rope": k_rope}
    q, k, v = L.attn_qkv(p.attn, x, positions, cfg.rope_theta)
    if cfg.attn_impl == "plain" and h.device.type == "cpu" and \
            not is_dtensor(q):
        o = L.plain_attention(q, k, v, causal=True, window=window)
    else:
        # the plain form's window is exact: a tile of one key bounds
        # nothing
        t = 1 if window and cfg.attn_impl == "plain" else cfg.attn_chunk
        o = ops.gqa_flash_attention(q, k, v, causal=True, tq=t, tk=t,
                                    window=window, device=h.device)
    return h + L.attn_out(p.attn, o), {"k": k, "v": v}


def attn_block(p, cfg: ModelConfig, h, *, positions):
    return _attention(p, cfg, h, positions)[0]


def ffn_aux(p, cfg: ModelConfig, h):
    """The FFN half of a block: (h + FFN, the router's aux loss, None
    for a dense block)."""
    x = shard_act(L.rms_norm(h, p.ln2, cfg.rms_eps), "batch", None, None)
    if isinstance(p, MoEBlock):
        o, aux = MOE.moe_ffn(p.moe, x, cfg.moe)
        return h + o, aux
    return h + L.mlp(p.mlp, x), None


def ffn_block(p, cfg: ModelConfig, h):
    return ffn_aux(p, cfg, h)[0]


# ----------------------------------------------------------------- forward

def decoder_hidden(model: DecoderLM, cfg: ModelConfig, h, positions):
    """Run all layers over h: (B, L, D). Returns (h, aux loss sum): the
    MoE routers' aux losses summed over the MoE layers, 0.0 without
    one."""
    def layer(p, h, window):
        h = shard_act(h, "batch", None, None)
        h = _attention(p, cfg, h, positions, window)[0]
        return ffn_aux(p, cfg, h)

    aux = 0.0
    for p, window in zip(model.layers, layer_windows(cfg)):
        h, a = remat(cfg, layer, p, h, window)
        if a is not None:
            aux = aux + a
    return h, aux


def embed_inputs(model: nn.Module, tokens, patches=None):
    """The token embeddings, with `patches` (B, P, D) ahead of them."""
    h = embed_tokens(model, tokens)
    if patches is not None:
        h = torch.cat([patches.to(h.dtype), h], dim=1)
    return h


def decoder_forward(model: DecoderLM, cfg: ModelConfig, tokens,
                    patches=None):
    """The full forward (no cache): (final-normed hidden states, aux);
    with `patches`, over the patches' positions too."""
    h = embed_inputs(model, tokens, patches)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, aux = decoder_hidden(model, cfg, h, positions)
    return shard_act(L.rms_norm(h, model.final_norm, cfg.rms_eps), "batch",
                     None, None), aux


class _PieceNLL(torch.autograd.Function):
    """lse - gold of each position from this rank's piece of the
    vocabulary (`first` on), the max, the sum of exponentials and the
    gold logit all-reduced over `group`."""

    @staticmethod
    def forward(ctx, logits, targets, first, group):
        import torch.distributed as dist
        m = torch.amax(logits, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        dist.all_reduce(s, group=group)
        lse = m + torch.log(s)
        t = targets.long() - first
        inside = (t >= 0) & (t < logits.shape[-1])
        t = torch.where(inside, t, 0)
        gold = torch.gather(logits, -1, t[..., None])[..., 0]
        gold = torch.where(inside, gold, 0.0)
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, lse, t, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, t, inside = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, t[..., None], -inside.to(d.dtype)[..., None])
        return d * g[..., None], None, None, None


def _piece_nll(logits, targets):
    """The (B, L) lse - gold of logits split over the vocabulary, on
    every rank of their mesh."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    i, first, _ = _split_dim(logits, -1)
    mesh = logits.device_mesh

    def nll(piece, targets):
        return _PieceNLL.apply(piece, targets, first, mesh.get_group(i))
    return local_map(nll, out_placements=[Replicate()] * mesh.ndim,
                     in_placements=(logits.placements, None),
                     in_grad_placements=(logits.placements, None),
                     device_mesh=mesh)(logits, targets)


def softmax_xent(logits, targets, mask):
    """Mean token cross-entropy: logits (B, L, V) in float32 (log-sum-exp
    over the padded vocabulary, whose pad `logits_fn` masks), targets
    (B, L) ints, mask (B, L) weights. Logits split over the vocabulary
    (a DTensor) are reduced piece by piece (`_PieceNLL`)."""
    logits = logits.to(F32)
    if is_dtensor(logits) and _split_dim(logits, -1)[0] is not None:
        nll = _piece_nll(logits, targets)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, place_like(targets.long(), logits)
                            [..., None])[..., 0]
        nll = lse - gold
    mask = place_like(mask, nll)
    nll = nll * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def batch_mask(batch) -> torch.Tensor:
    """The batch's "mask", or ones over its targets."""
    mask = batch.get("mask")
    if mask is None:
        t = batch["targets"]
        mask = torch.ones(t.shape, dtype=F32, device=t.device)
    return mask


def decoder_loss(model: DecoderLM, cfg: ModelConfig, batch):
    """(loss, metrics) of {"tokens", "targets"[, "mask"]} (B, L): the
    cross-entropy "xent", plus router_aux_weight x the routers' summed
    aux loss "aux" with MoE, plus mtp_weight x the multi-token
    prediction loss "mtp" with MTP; each metric only where the
    reference's has it. With "patches" (B, P, D), only the text
    positions are scored."""
    targets = batch["targets"]
    patches = batch.get("patches")
    h, aux = decoder_forward(model, cfg, batch["tokens"], patches)
    if patches is not None:
        h = h[:, patches.shape[1]:]
    mask = batch_mask(batch)
    xent = softmax_xent(logits_fn(model, cfg, h), targets, mask)
    loss, metrics = xent, {"xent": xent}
    if cfg.moe is not None:
        aux = torch.as_tensor(aux, dtype=F32, device=h.device)
        loss = loss + cfg.moe.router_aux_weight * aux
        metrics["aux"] = aux
    if cfg.use_mtp:
        mtp = _mtp_loss(model, cfg, h, targets, mask)
        loss = loss + cfg.mtp_weight * mtp
        metrics["mtp"] = mtp
    return loss, metrics


def _mtp_loss(model: DecoderLM, cfg: ModelConfig, h, targets, mask):
    """DeepSeek-style depth-1 multi-token prediction: predict token t + 2
    from (h_t, the embedding of y_{t+1}) through one more dense layer;
    the logits of positions 0 .. L - 2 against targets[:, 1:]."""
    p = model.mtp
    x = torch.cat([L.rms_norm(h, p.norm, cfg.rms_eps),
                   embed_tokens(model, targets)], dim=-1)
    x = torch.einsum("ble,ed->bld", x, p.proj)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    dense = cfg.replace(moe=None)
    x = _attention(p.layer, dense, x, positions)[0]
    x = ffn_block(p.layer, dense, x)
    logits = logits_fn(model, cfg, x[:, :-1])
    return softmax_xent(logits, targets[:, 1:], mask[:, 1:])


# ------------------------------------------------------------------ decode

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero caches for every layer: K and V, (n_layers, B, seq_len, Hkv,
    D) each, or MLA's latents (`mla.mla_init_cache`)."""
    dev = resolve(device)
    if cfg.mla:
        return MLA.mla_init_cache(cfg.n_layers, batch, seq_len, cfg.mla,
                                  torch_dtype(cfg), dev)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {k: torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)
            for k in ("k", "v")}


def _gqa_layer_decode(p, cfg: ModelConfig, h, k_cache,
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
        if cfg.mla:
            x = L.rms_norm(h, p.ln1, cfg.rms_eps)
            o, c = MLA.mla_decode_step(p.attn, x, c, pos, cfg.mla,
                                       cfg.rope_theta)
            return ffn_block(p, cfg, h + o), c
        return _gqa_layer_decode(p, cfg, h, c["k"], c["v"], pos, window), c

    h, cache = scan_layers_carry(body, h, layers, cache)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h), cache


def prefill(model: DecoderLM, cfg: ModelConfig, tokens, seq_len: int,
            patches=None):
    """Forward the prompt into a preallocated cache of capacity
    `seq_len`, each layer writing the K and V (or MLA's latents) its
    attention used; `patches` (B, P, D) go ahead of the tokens and take
    the cache's first P positions. Returns (last-position logits (B, 1,
    V), cache)."""
    h = embed_inputs(model, tokens, patches)
    b, l, _ = h.shape
    positions = torch.arange(l, device=h.device)[None, :]
    cache = init_cache(cfg, b, seq_len, h.device)
    for i, (p, window) in enumerate(zip(model.layers, layer_windows(cfg))):
        h, entries = _attention(p, cfg, h, positions, window)
        for name, x in entries.items():
            cache[name][i, :, :l] = x
        h = ffn_block(p, cfg, h)
    h = L.rms_norm(h, model.final_norm, cfg.rms_eps)
    return logits_fn(model, cfg, h[:, -1:]), cache
