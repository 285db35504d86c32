"""Train, prefill and decode step builders shared by train.py and serve.py
(a port of the reference's `launch/steps.py`).

The reference's steps are pure functions for `jax.jit`; these run
eagerly. `train_step` takes the model's parameters module and updates it,
and the optimizer state, in place (`optim/optimizers.py`), returning both
as the reference returns its new ones. Gradients come from
`torch.autograd.grad` over the module's parameters in
`named_parameters()` order; a parameter the loss does not reach gets
zeros, as `jax.grad` gives it. Adafactor (DeepSeek-V3's config) is given
the reference's leaves (`convert.reference_leaves`), so it factors and
clips each of the reference's stacked leaves as the reference does.

Under tensor parallelism the parameters are DTensors
(`sharding.place_params`): each gradient is placed as its parameter is,
the loss terms are the replicated values' local copies, and the
data-parallel mean packs each gradient's local piece.
"""
from __future__ import annotations

import torch

from repro_torch.convert import reference_leaves
from repro_torch.distributed.meshctx import redistribute
from repro_torch.distributed.sharding import is_dtensor, local, wrap_like
from repro_torch.models.model import Model
from repro_torch.optim import clip_by_norm, cosine_schedule, make_optimizer

F32 = torch.float32


def _grads(loss, named):
    """Each parameter's gradient, zeros where the loss does not reach it;
    a DTensor parameter's placed as the parameter is."""
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    out = {}
    with torch.no_grad():
        for (k, p), g in zip(named.items(), gs):
            if g is None:
                g = torch.zeros_like(p)
            elif is_dtensor(p) and g.placements != p.placements:
                g = redistribute(g, p.placements)
            out[k] = g
    return out


def mean_over(group, grads: dict, metrics: dict):
    """Gradients and loss terms averaged over the ranks of `group`, in
    one float32 all-reduce (each rank's own batch slice in, the global
    batch's mean out, in each tensor's dtype); a DTensor's local piece
    goes in and comes back placed as it was."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    items = list(grads.items()) + list(metrics.items())
    pieces = [local(v) for _, v in items]
    flat = torch.empty(sum(v.numel() for v in pieces), dtype=F32,
                       device=pieces[0].device)
    off = 0
    for v in pieces:
        flat[off:off + v.numel()].copy_(v.reshape(-1))
        off += v.numel()
    dist.all_reduce(flat, group=group)
    if n > 1:
        flat /= n
    out, off = {}, 0
    for (k, v), pc in zip(items, pieces):
        out[k] = wrap_like(flat[off:off + pc.numel()].view(pc.shape).to(
            pc.dtype), v)
        off += pc.numel()
    return ({k: out[k] for k in grads},
            {k: out[k] for k in metrics})


def make_train_step(model: Model, *, grad_accum: int = 1,
                    max_grad_norm: float = 1.0, lr_kwargs=None, group=None):
    """Returns (init_opt_state, train_step).

    init_opt_state(params) -> the optimizer's state for the module;
    train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics) with metrics {"xent", "loss", "gnorm", "lr"} as 0-d tensors.
    With `grad_accum` > 1 the batch's leading axis splits into that many
    micro-batches in order; their float32 gradients and losses are summed
    each divided by `grad_accum`, as the reference's scan sums them.
    With a process `group` (data parallelism: each rank's batch is its
    slice of the global batch, every rank holds the same parameters and
    state), the gradients and the per-rank loss terms are averaged over
    the group before the clip (`mean_over`); the MoE `aux` is already the
    global batch's (`models/moe.py`). The mean is the global batch's
    where every rank's slice has the same mask total, as
    `data/pipeline.host_batch`'s do."""
    cfg = model.cfg
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    lr_kwargs = lr_kwargs or {}

    def leaves(named):
        if cfg.optimizer != "adafactor":
            return {}
        return {"leaves": reference_leaves(named, cfg)}

    def init_opt_state(params):
        named = dict(params.named_parameters())
        return opt_init(named, **leaves(named))

    def train_step(params, opt_state, batch, step):
        named = dict(params.named_parameters())
        if grad_accum > 1:
            b = next(iter(batch.values())).shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} does not split into "
                                 f"grad_accum = {grad_accum} micro-batches")
            per = b // grad_accum
            grads = {k: torch.zeros_like(p, dtype=F32)
                     for k, p in named.items()}
            loss_sum = 0.0
            for i in range(grad_accum):
                mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
                loss, _ = model.loss_fn(params, mb)
                for k, g in _grads(loss, named).items():
                    grads[k] += g.to(F32) / grad_accum
                loss_sum = loss_sum + local(loss.detach()) / grad_accum
            metrics = {"xent": loss_sum}
        else:
            loss, metrics = model.loss_fn(params, batch)
            grads = _grads(loss, named)
            metrics = {k: local(v.detach()) for k, v in metrics.items()}
        if group is not None:
            terms = {k: v for k, v in metrics.items() if k != "aux"}
            grads, terms = mean_over(group, grads, terms)
            metrics = dict(metrics, **terms)
        grads, gnorm = clip_by_norm(grads, max_grad_norm)
        lr = cosine_schedule(step, **lr_kwargs)
        _, opt_state = opt_update(named, grads, opt_state, lr,
                                  **leaves(named))
        metrics = dict(metrics, gnorm=gnorm, lr=lr,
                       loss=metrics.get("xent", 0.0))
        return params, opt_state, metrics

    return init_opt_state, train_step


def make_prefill_step(model: Model, seq_len: int):
    def prefill_step(params, batch):
        return model.prefill_fn(params, batch, seq_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens, pos):
        return model.decode_fn(params, cache, tokens, pos)
    return decode_step
