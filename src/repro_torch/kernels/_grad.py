"""Autograd around the card kernels that have no backward kernel.

`ssd_scan` and `bitplane_matmul` launch through a raw pointer, so their
outputs on the card carry no autograd graph: a loss through them would
leave every parameter upstream without a gradient, and raise nothing.
Their wrappers route a launch whose inputs need a gradient through
`NoBackward`, whose backward raises NotImplementedError with the reason.
On the CPU the plain versions are differentiable and need none of this.
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
