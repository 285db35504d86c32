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

Adafactor factors each leaf it is given. The reference factors its
model's stacked leaves (n_layers, ...), where the port has one tensor a
layer: on the same arrays the two agree, on a model's update they do not
(ROADMAP.md, queue 3); no ported config trains with Adafactor.
"""
from __future__ import annotations

from typing import Dict

import torch

F32 = torch.float32
Tensors = Dict[str, torch.Tensor]


def _zeros_f32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=F32,
                       device=p.device)


@torch.no_grad()
def clip_by_norm(grads: Tensors, max_norm: float):
    """Scale every gradient by min(1, max_norm / global L2 norm). Returns
    (new gradient dict, float32 norm)."""
    gsq = sum(torch.sum(torch.square(g.to(F32))) for g in grads.values())
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return {k: (g.to(F32) * scale).to(g.dtype)
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
        g = grads[k].to(F32)
        m, v = state["m"][k], state["v"][k]
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


def adafactor_init(params: Tensors) -> dict:
    def one(p):
        if _factored(p.shape):
            return {"r": _zeros_f32(p, p.shape[:-1]),                # row
                    "c": _zeros_f32(p, p.shape[:-2] + p.shape[-1:])}  # col
        return {"v": _zeros_f32(p)}
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "vs": {k: one(p) for k, p in params.items()}}


@torch.no_grad()
def adafactor_update(params: Tensors, grads: Tensors, state: dict, lr, *,
                     decay=0.8, eps=1e-30, clip_thresh=1.0, wd=0.0):
    step = state["step"] + 1
    t = step.to(F32)
    beta = 1.0 - t ** -decay
    for k, p in params.items():
        g = grads[k].to(F32)
        v = state["vs"][k]
        g2 = g * g + eps
        if _factored(p.shape):
            r = beta * v["r"] + (1 - beta) * torch.mean(g2, dim=-1)
            c = beta * v["c"] + (1 - beta) * torch.mean(g2, dim=-2)
            rmean = torch.mean(r, dim=-1, keepdim=True)
            vhat = (r / torch.clamp_min(rmean, eps))[..., None] \
                * c[..., None, :]
            v["r"].copy_(r)
            v["c"].copy_(c)
        else:
            vhat = beta * v["v"] + (1 - beta) * g2
            v["v"].copy_(vhat)
        u = g * torch.rsqrt(torch.clamp_min(vhat, eps))
        # update clipping (Adafactor's RMS clip)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp_min(rms / clip_thresh, 1.0)
        pf = p.to(F32)
        p.copy_((pf - lr * (u + wd * pf)).to(p.dtype))
    return params, {"step": step, "vs": state["vs"]}


# ----------------------------------------------------------------- facade

def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
