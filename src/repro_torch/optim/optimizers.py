"""Optimizers as plain functions over an ordered `{name: tensor}` dict of
parameters: AdamW and Adafactor (the reference's `optim/optimizers.py`).

The reference's functions map pytrees to new pytrees; these take the
dict of a model's parameters (`dict(module.named_parameters())`), the
gradients under the same names and the state, and update the parameter
and state tensors in place under `torch.no_grad()` (the port may update
in place where that saves memory; a full model's m and v are 4x its
bfloat16 parameters). Each returns `(params, state)` as the reference's
does, the same dicts. The arithmetic is the reference's, in its order:
float32 gradients, m and v; the parameter, bfloat16 or float32, updated
directly from its own value in float32; `b1 ** t` with t float32.

`adamw_init(master=True)` adds a float32 copy of the parameters under
"master", as the reference's does; the reference's `adamw_update` neither
reads nor returns it, and neither does this one (ROADMAP.md, queue 3).

Adafactor computes the reference's update on the reference's leaves.
The reference stacks a model's layers on leading axes (n_layers, ...),
or (n_groups, g, ...), and factors each stacked leaf as one tensor; the
port holds one tensor a layer. `leaves` ({reference path: (the port's
names in the stack's C order, the stack's shape)}, from
`convert.reference_leaves`) joins them: the state is kept in the
reference's stacked layout, under its path. Where a layer's leaf is a
matrix or more, the stacked leaf is factored over the same last two
axes, so each layer's r and c are its own (views into the stacked
state), and only the RMS clip spans the stack: the layers' sums of u·u
are added first, then each layer's u is formed again and applied, so
no stacked copy of a parameter, gradient or update is made. A layer's
vector (or scalar) is stacked: the (n, d) leaf is factored, r (n,)
against c (d,), which couples the layers. Without `leaves` each
parameter is its own leaf, under its name.

Under tensor parallelism (DTensor parameters, `sharding.place_params`)
AdamW's moments mirror their parameters' placements, and the update runs
on each rank's local pieces; the clip's norm counts each split
gradient's pieces once (summed over the model axis) and each replicated
one once.
"""
from __future__ import annotations

import itertools
from typing import Dict

import torch

from repro_torch.distributed.sharding import is_dtensor, local, wrap_like

F32 = torch.float32
Tensors = Dict[str, torch.Tensor]


def _zeros_f32(p: torch.Tensor, shape=None) -> torch.Tensor:
    """Float32 zeros placed as `p` is, or of `shape` on its device."""
    if shape is None:
        return torch.zeros_like(p, dtype=F32)
    return torch.zeros(shape, dtype=F32, device=p.device)


def _sum_squares(grads: Tensors) -> torch.Tensor:
    """The float32 sum of every gradient's squares: the split DTensors'
    local sums all-reduced over their mesh, then the rest's added."""
    import torch.distributed as dist
    split = [g for g in grads.values() if is_dtensor(g)
             and any(p.is_shard() for p in g.placements)]
    if not split:
        return sum(torch.sum(torch.square(local(g).to(F32)))
                   for g in grads.values())
    mesh = split[0].device_mesh
    if mesh.ndim != 1 or any(g.device_mesh != mesh for g in split):
        raise NotImplementedError("gradients split over more than one "
                                  "mesh axis (ROADMAP.md item 13g)")
    parts = sum(torch.sum(torch.square(local(g).to(F32))) for g in split)
    dist.all_reduce(parts, group=mesh.get_group())
    ids = {id(g) for g in split}
    return parts + sum((torch.sum(torch.square(local(g).to(F32)))
                        for g in grads.values() if id(g) not in ids),
                       torch.zeros((), dtype=F32, device=parts.device))


@torch.no_grad()
def clip_by_norm(grads: Tensors, max_norm: float):
    """Scale every gradient by min(1, max_norm / global L2 norm). Returns
    (new gradient dict, float32 norm)."""
    gnorm = torch.sqrt(_sum_squares(grads))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return {k: wrap_like((local(g).to(F32) * scale).to(g.dtype), g)
            for k, g in grads.items()}, gnorm


# ----------------------------------------------------------------- adamw

def adamw_init(params: Tensors, master: bool = False) -> dict:
    dev = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": {k: _zeros_f32(p) for k, p in params.items()},
             "v": {k: _zeros_f32(p) for k, p in params.items()}}
    if master:
        state["master"] = {k: p.detach().to(F32).clone()
                           for k, p in params.items()}
    return state


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: dict, lr, *,
                 b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    step = state["step"] + 1
    t = step.to(F32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for k, p in params.items():
        p, g = local(p), local(grads[k]).to(F32)
        m, v = local(state["m"][k]), local(state["v"][k])
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        pf = p.to(F32)
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    return params, {"step": step, "m": state["m"], "v": state["v"]}


# -------------------------------------------------------------- adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _own_leaves(params: Tensors) -> dict:
    """Each parameter its own leaf, under its name."""
    return {(k,): ((k,), ()) for k in params}


def _node(tree: dict, path) -> dict:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    return tree


def adafactor_init(params: Tensors, leaves=None) -> dict:
    """Zero state {"step", "vs"}: `vs` holds each leaf's {"r", "c"}
    (factored) or {"v"} in the leaf's stacked shape, under its path."""
    def one(p, shape):
        if _factored(shape):
            return {"r": _zeros_f32(p, shape[:-1]),                # row
                    "c": _zeros_f32(p, shape[:-2] + shape[-1:])}   # col
        return {"v": _zeros_f32(p, shape)}
    vs: dict = {}
    for path, (names, stack) in (leaves or _own_leaves(params)).items():
        p = params[names[0]]
        _node(vs, path)[path[-1]] = one(p, tuple(stack) + tuple(p.shape))
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "vs": vs}


def _vhat(v: Tensors, eps) -> torch.Tensor:
    """The second-moment estimate the state v gives."""
    if "r" not in v:
        return v["v"]
    r = v["r"]
    rmean = torch.mean(r, dim=-1, keepdim=True)
    return (r / torch.clamp_min(rmean, eps))[..., None] * v["c"][..., None, :]


def _moment_step(v: Tensors, g, beta, eps) -> torch.Tensor:
    """Update the state v (in place) from the gradient g; the update's
    unclipped direction u = g / sqrt(vhat)."""
    g2 = g * g + eps
    if "r" in v:
        v["r"].copy_(beta * v["r"] + (1 - beta) * torch.mean(g2, dim=-1))
        v["c"].copy_(beta * v["c"] + (1 - beta) * torch.mean(g2, dim=-2))
    else:
        v["v"].copy_(beta * v["v"] + (1 - beta) * g2)
    return g * torch.rsqrt(torch.clamp_min(_vhat(v, eps), eps))


def _apply(p, u, mean_uu, lr, eps, clip_thresh, wd) -> None:
    """The RMS clip (Adafactor's update clipping) and the step."""
    rms = torch.sqrt(mean_uu + eps)
    u = u / torch.clamp_min(rms / clip_thresh, 1.0)
    pf = p.to(F32)
    p.copy_((pf - lr * (u + wd * pf)).to(p.dtype))


@torch.no_grad()
def adafactor_update(params: Tensors, grads: Tensors, state: dict, lr, *,
                     decay=0.8, eps=1e-30, clip_thresh=1.0, wd=0.0,
                     leaves=None):
    step = state["step"] + 1
    t = step.to(F32)
    beta = 1.0 - t ** -decay
    clip = dict(lr=lr, eps=eps, clip_thresh=clip_thresh, wd=wd)
    for path, (names, stack) in (leaves or _own_leaves(params)).items():
        v = _node(state["vs"], path)[path[-1]]
        shape = params[names[0]].shape
        if not stack:
            p = params[names[0]]
            u = _moment_step(v, grads[names[0]].to(F32), beta, eps)
            _apply(p, u, torch.mean(u * u), **clip)
            continue
        if len(shape) < 2:
            # a vector (or scalar) a layer: the stacked leaf, one tensor
            p = torch.stack([params[k] for k in names]).reshape(
                tuple(stack) + tuple(shape))
            g = torch.stack([grads[k].to(F32) for k in names]).reshape(
                p.shape)
            u = _moment_step(v, g, beta, eps)
            _apply(p, u, torch.mean(u * u), **clip)
            for k, pk in zip(names, p.reshape((len(names),) + shape)):
                params[k].copy_(pk)
            continue
        # a matrix a layer: each layer's own r and c (views of the
        # stacked state); the clip's mean spans the stack
        views = [{kk: s[idx] for kk, s in v.items()}
                 for idx in itertools.product(*map(range, stack))]
        uu = sum(torch.sum(torch.square(_moment_step(vk, grads[k].to(F32),
                                                      beta, eps)))
                 for k, vk in zip(names, views))
        mean_uu = uu / (len(names) * params[names[0]].numel())
        for k, vk in zip(names, views):
            g = grads[k].to(F32)
            u = g * torch.rsqrt(torch.clamp_min(_vhat(vk, eps), eps))
            _apply(params[k], u, mean_uu, **clip)
    return params, {"step": step, "vs": state["vs"]}


# ----------------------------------------------------------------- facade

def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
