"""Mesh context: logical-axis activation sharding that is a no-op off a
mesh (a port of the reference's `distributed/meshctx.py`).

`mesh_context(mesh)` installs an `AbstractMesh` or a
`torch.distributed` `DeviceMesh` and the logical -> physical axis map
derived from it: 'batch' -> ('pod', 'data') with a pod axis, else
('data',); 'model' -> ('model',); 'data' -> ('data',). `shard_act(x,
'batch', None, 'model')` redistributes a DTensor to those axes; on a
plain tensor, or without a mesh, it returns `x`, so model code is
mesh-agnostic. `batch_group` is the process group over the batch axes,
over which a data-parallel step reduces its gradients, and
`all_reduce_sum` a sum over it that autograd differentiates.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import (AbstractMesh, axis_names,
                                              mesh_shape, placements)

_state = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Install `mesh` and the logical -> physical axis map derived from
    it for the calls inside."""
    names = axis_names(mesh)
    rules = {"model": ("model",), "data": ("data",),
             "batch": ("pod", "data") if "pod" in names else ("data",)}
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def logical_to_spec(axes: Tuple[Optional[str], ...]) -> tuple:
    rules = _rules()
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        else:
            phys = rules[a]
            out.append(phys[0] if len(phys) == 1 else phys)
    return tuple(out)


def batch_axes() -> Tuple[str, ...]:
    """Physical axis names the batch dimension shards over."""
    rules = _rules()
    return rules["batch"] if rules else ("data",)


def shard_act(x, *axes):
    """Place activation `x` by logical axes; a no-op without a mesh and
    on a plain tensor. Divisibility-aware: an axis whose dim the mesh
    axes' product does not divide is dropped (replicated)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    shape = mesh_shape(mesh)
    spec = list(logical_to_spec(axes)) + [None] * (x.ndim - len(axes))
    for i, a in enumerate(spec):
        if a is None:
            continue
        size = math.prod(shape[n] for n in (a if isinstance(a, tuple)
                                            else (a,)))
        if x.shape[i] % size != 0 or x.shape[i] == 0:
            spec[i] = None
    want = placements(tuple(spec), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def batch_group(mesh=None):
    """The process group over the batch axes of `mesh` (the installed
    one by default), this rank's row of them: None for an `AbstractMesh`
    or no mesh."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or isinstance(mesh, AbstractMesh):
        return None
    if "pod" not in axis_names(mesh):
        return mesh.get_group("data")
    return mesh["pod", "data"]._flatten().get_group()


def group_size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group`, differentiable."""
    return _AllReduceSum.apply(x, group)
