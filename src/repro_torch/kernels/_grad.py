"""Autograd around the card kernels that have no backward kernel.

A kernel launches through a raw pointer, so its outputs on the card
carry no autograd graph: a loss through it would leave every parameter
upstream without a gradient, and raise nothing. `flash_attention` and
`ssd_scan` have backward kernels, joined to their forwards by their own
autograd Functions. `bitplane_matmul` has none: its wrapper routes a
launch whose inputs need a gradient through `NoBackward`, whose backward
raises NotImplementedError with the reason. On the CPU its plain
version is differentiable and needs none of this.
"""
from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd records and an input requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


class NoBackward(torch.autograd.Function):
    """`NoBackward.apply(why, launch, *inputs)` returns `launch(*inputs)`
    with a backward that raises NotImplementedError(why)."""

    @staticmethod
    def forward(ctx, why, launch, *inputs):
        ctx.why = why
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(ctx.why)
