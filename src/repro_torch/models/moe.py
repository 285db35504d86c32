"""Mixture-of-Experts layer: a top-k router and capacity-based sorted
dispatch (a port of the reference's `models/moe.py`).

The router's logits and softmax are float32 whatever the model's dtype:
its `router` leaf stays float32 (`F32_LEAVES`). Padded experts
(`n_experts_padded`) are masked to -1e30 before the softmax. Each
token's k choices make T x k slots, ordered by a stable sort on the
expert id, so expert e keeps its first `capacity` slots in token order
and drops the rest (`route_slots`). The expert products run on an
(E, C, D) buffer as `torch.bmm` in the model's dtype, the reference's
einsums (no Pallas kernel there). The combine gathers each token's k
slot outputs, weighted by their normalised probabilities, and sums them
over k in float32: every token has exactly k slots, so the gather
computes the reference's scatter-add in a fixed order, on every run.

Without a mesh both `dispatch` values run the flat form, as the
reference's do. Under a mesh (`distributed/meshctx.py`) `hierarchical`
splits the tokens into s shards, s the batch axes' size, and each shard
sorts and drops its own tokens at the capacity of its t / s tokens (the
reference falls back to s = 1 where s divides neither B nor t). Under
data parallelism each rank holds B / ranks of the global batch, so it
takes s / ranks of those shards; the router's load-balancing statistics
are summed over the batch group (differentiably), so `aux` is the
global batch's, as the reference takes it before the split. A flat
dispatch cannot be split by rank, since every token of the global batch
competes for one capacity: with more than one batch rank it raises.
Shard j's expert e is buffer row j * E_pad + e, so the shards share
one sort, and the experts run on (E_pad, s x C, D).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import meshctx
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.models import layers as L

F32 = torch.float32
# the leaves the reference keeps in float32 whatever the model's dtype
F32_LEAVES = ("router",)


class MoEParams(nn.Module):
    """`router` (D, E_pad) float32, `wi`, `wg` (E_pad, D, F) and `wo`
    (E_pad, F, D), and `shared` {wi, wg, wo} with shared experts, as the
    reference's `init_moe` lays them out; `p[name]` reads a leaf as from
    the reference's dict. Inference only."""

    def __init__(self, params):
        super().__init__()
        for k in ("router", "wi", "wg", "wo"):
            self.register_parameter(
                k, nn.Parameter(params[k], requires_grad=False))
        if "shared" in params:
            self.shared = nn.ParameterDict(
                {k: nn.Parameter(v, requires_grad=False)
                 for k, v in params["shared"].items()})

    def __getitem__(self, name):
        return getattr(self, name)


def init_moe(d_model: int, mcfg: MoEConfig, dtype, generator, device):
    """Random parameters at the reference's scales, drawn from
    `generator` on `device`; each expert's matrices are drawn in float32
    one expert at a time (a whole float32 stack of DeepSeek-V3's is 15
    GB)."""
    e, f = mcfg.e_padded, mcfg.d_ff_expert

    def stack(shape, scale):
        out = torch.empty((e,) + shape, dtype=dtype, device=device)
        for i in range(e):
            out[i] = L.randn(shape, scale, dtype, generator, device)
        return out

    p = {"router": L.randn((d_model, e), d_model ** -0.5, F32, generator,
                           device),
         "wi": stack((d_model, f), d_model ** -0.5),
         "wg": stack((d_model, f), d_model ** -0.5),
         "wo": stack((f, d_model), f ** -0.5)}
    if mcfg.n_shared:
        p["shared"] = L.init_mlp(d_model, mcfg.n_shared * f, dtype,
                                 generator, device)
    return p


def router_topk(logits, mcfg: MoEConfig):
    """logits: (..., E_pad) float32 -> (probs, idx, aux). Padded experts
    are masked before the softmax; idx[..., 0] is each token's most
    probable expert; probs are renormalised over the k choices. aux is
    the load-balancing loss: n_experts x sum over the E_pad experts of
    (share of first choices) x (mean probability), both over the tokens
    of every rank of the installed mesh's batch group (`meshctx`)."""
    group = meshctx.batch_group()
    e, ep = mcfg.n_experts, mcfg.e_padded
    if ep != e:
        real = torch.arange(ep, device=logits.device) < e
        logits = torch.where(real, logits, L._neg_inf(logits))
    probs_full = torch.softmax(logits, dim=-1)
    probs, idx = torch.topk(probs_full, mcfg.top_k, dim=-1, sorted=True)
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    first = F.one_hot(idx[..., 0], ep).to(F32).reshape(-1, ep)
    pf = probs_full.reshape(-1, ep)
    if meshctx.group_size(group) == 1:
        density, mean_probs = first.mean(0), pf.mean(0)
    else:
        sums = meshctx.all_reduce_sum(torch.cat([first.sum(0), pf.sum(0)]),
                                      group)
        n = first.shape[0] * meshctx.group_size(group)
        density, mean_probs = sums[:ep] / n, sums[ep:] / n
    aux = e * torch.sum(density * mean_probs)
    return probs, idx, aux


def capacity(t: int, mcfg: MoEConfig) -> int:
    """Slots an expert for a call of t tokens, the reference's arithmetic:
    ceil(t k capacity_factor / E_pad), at least 8, rounded up to 8."""
    c = int(-(-t * mcfg.top_k * mcfg.capacity_factor // mcfg.e_padded))
    return max(8, -(-c // 8) * 8)


def route_slots(idx, e: int, c: int):
    """Each (token, choice) slot's row in the flattened (E + 1) x C
    expert buffer, in the order of idx.reshape(-1), and whether it is
    kept. Slots are ordered by a stable sort on the expert id, so expert
    j keeps its first c slots in token order; a dropped slot's row is
    E x C, in the extra row that the buffer's cut removes."""
    flat_e = idx.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=idx.device, dtype=sorted_e.dtype))
    pos = torch.arange(n, device=idx.device) - seg_start[sorted_e]
    row = torch.empty_like(pos)
    row[order] = torch.where(pos < c, sorted_e * c + pos, e * c)
    return row, row < e * c


def dropped(idx, e: int, c: int) -> torch.Tensor:
    """The slots over capacity in a call routed to `idx`, (e,) int64 per
    expert."""
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    return torch.clamp_min(counts - c, 0)


def dispatch(xf, row, k: int, e: int, c: int):
    """xf (T, D) into the (E, C, D) expert buffer: slot s of token s // k
    at `row[s]`; empty and dropped places are zero (the drops land in
    the cut extra row)."""
    t, d = xf.shape
    src = torch.full(((e + 1) * c,), t, dtype=torch.int64,
                     device=xf.device)
    src[row] = torch.arange(t * k, device=xf.device) // k
    xz = torch.cat([xf, xf.new_zeros((1, d))])          # row t: zeros
    return xz[src[:e * c]].view(e, c, d)


def experts(p, buf):
    """The SwiGLU experts on their buffers, (E, C, D) -> (E, C, D), in
    the buffer's dtype, SiLU in float32."""
    h = torch.bmm(buf, p["wi"])
    g = torch.bmm(buf, p["wg"])
    h = F.silu(g.to(F32)).to(h.dtype) * h
    return torch.bmm(h, p["wo"])


def combine(out_buf, row, keep, probs, k: int):
    """(T, D) float32: each token's k slot outputs times their
    probabilities (in the buffer's dtype), summed over k in float32. A
    dropped slot reads expert E - 1's first place, as the reference's
    clip does, and weighs 0."""
    e, c, d = out_buf.shape
    flat = out_buf.reshape(e * c, d)
    slot_out = flat[torch.where(keep, row, (e - 1) * c)]
    w = (probs.reshape(-1) * keep).to(slot_out.dtype)
    return (slot_out * w[:, None]).view(-1, k, d).to(F32).sum(1)


def shards(b: int, t: int, mcfg: MoEConfig) -> int:
    """Dispatch shards of this process's B x L = t tokens: 1 without a
    mesh or with the flat dispatch; under `hierarchical`, the mesh's
    batch-axes size over the ranks of the batch group, or 1 where that
    divides neither b nor t."""
    mesh = meshctx.current_mesh()
    ranks = meshctx.group_size(meshctx.batch_group())
    if ranks > 1 and mcfg.dispatch != "hierarchical":
        raise NotImplementedError(
            f"the {mcfg.dispatch!r} MoE dispatch routes the whole global "
            f"batch against one capacity, which {ranks} data-parallel ranks "
            f"cannot split: use dispatch='hierarchical'")
    if mesh is None or mcfg.dispatch != "hierarchical":
        return 1
    shape = mesh_shape(mesh)
    s = 1
    for a in meshctx.batch_axes():
        s *= shape[a]
    s //= ranks
    if t % s or b % s:
        if ranks > 1:
            raise ValueError(
                f"{b} x {t // b} tokens a rank do not split into the "
                f"{s} dispatch shards a rank of the mesh {shape}")
        s = 1
    return s


def moe_ffn(p, x, mcfg: MoEConfig):
    """x: (B, L, D) -> ((B, L, D), aux loss), at the `capacity` of each
    dispatch shard's tokens (`shards`; one shard of all B x L tokens
    without a mesh). The shared experts' MLP is added after the cast to
    x's dtype."""
    b, l, d = x.shape
    t = b * l
    e, k = mcfg.e_padded, mcfg.top_k
    s = shards(b, t, mcfg)
    xf = x.reshape(t, d)
    logits = torch.einsum("td,de->te", xf.to(F32), p["router"])
    probs, idx, aux = router_topk(logits, mcfg)
    c = capacity(t // s, mcfg)
    if s > 1:
        idx_s = idx + e * torch.arange(s, device=idx.device).repeat_interleave(
            t // s)[:, None]
        row, keep = route_slots(idx_s, s * e, c)
        buf = dispatch(xf, row, k, s * e, c).view(s, e, c, d)
        buf = buf.transpose(0, 1).reshape(e, s * c, d)
        out_buf = experts(p, buf).view(e, s, c, d).transpose(0, 1)
        out_buf = out_buf.reshape(s * e, c, d)
    else:
        row, keep = route_slots(idx, e, c)
        out_buf = experts(p, dispatch(xf, row, k, e, c))
    out = combine(out_buf, row, keep, probs, k).reshape(b, l, d).to(x.dtype)
    if mcfg.n_shared:
        out = out + L.mlp(p["shared"], x)
    return out, aux
