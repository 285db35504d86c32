"""Mesh context: logical-axis activation sharding that is a no-op off a
mesh (a port of the reference's `distributed/meshctx.py`).

`mesh_context(mesh)` installs an `AbstractMesh` or a
`torch.distributed` `DeviceMesh` and the logical -> physical axis map
derived from it: 'batch' -> ('pod', 'data') with a pod axis, else
('data',); 'model' -> ('model',); 'data' -> ('data',). `shard_act(x,
'batch', None, 'model')` redistributes a DTensor to those axes (of its
own mesh: a tensor-parallel step's DTensors live on the model axis's
sub-mesh, so the batch entries name no axis there) and holds its
gradient to the same placement, as the transpose of the reference's
`with_sharding_constraint` is one; on a plain tensor, or without a mesh,
it returns `x`, so model code is mesh-agnostic. `align` places an
activation for a product with a weight split on a contracted dim.
`batch_group` is the process group over the batch axes, over which a
data-parallel step reduces its gradients, `all_reduce_sum` a sum over
it that autograd differentiates, and `sum_grads` the identity whose
gradient is summed over a group.

Every redistribution here (`redistribute`, `full`) runs on c10d's
all-gather and DTensor's all-reduce only: two ranks on one card need a
gloo group, and on CUDA tensors gloo crashes in the functional
all-gather that DTensor's own redistribution calls (torch 2.11;
`scripts/gloo_collectives.py`), where c10d's `all_gather_into_tensor`
and every all-reduce run.
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


def _gather(piece, dim: int, mesh, i: int):
    """The whole of a tensor split on `dim` over mesh dim `i`, from this
    rank's `piece` (c10d's all-gather)."""
    import torch.distributed as dist
    x = piece.movedim(dim, 0).contiguous()
    out = torch.empty((mesh.size(i) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(i))
    return out.movedim(0, dim).contiguous()


def _piece(whole, dim: int, mesh, i: int):
    """This rank's piece of `whole` split evenly on `dim` over mesh dim
    `i`."""
    n = mesh.size(i)
    if whole.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(whole.shape)} does not split "
                         f"over {n} ranks")
    s = whole.shape[dim] // n
    return whole.narrow(dim, mesh.get_local_rank(i) * s, s)


def piece_of(whole: torch.Tensor, placements_, mesh) -> torch.Tensor:
    """This rank's piece of the full tensor `whole` placed by
    `placements_` on `mesh` (no collective)."""
    for i, p in enumerate(placements_):
        if p.is_shard():
            whole = _piece(whole, p.dim, mesh, i)
    return whole


def _move(x, want, grad: bool):
    """The DTensor `x` placed by `want` (not differentiable). Partial
    pieces are summed by DTensor (an all-reduce; a masked partial applies
    its mask), split dims gathered by `_gather`, and each rank then keeps
    its piece of a dim `want` splits. For a gradient (`grad`), a Partial
    in `want` keeps the whole value: every rank's piece of a sum has the
    sum's gradient."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    want = tuple(want)
    pls = list(x.placements)
    if pls == list(want):
        return DTensor.from_local(x.to_local(), mesh, want, run_check=False)
    summed = [Replicate() if p.is_partial() and p != w else p
              for p, w in zip(pls, want)]
    if summed != pls:
        x = x.redistribute(mesh, summed)
        pls = summed
    t = x.to_local()
    for i in reversed(range(mesh.ndim)):
        if pls[i].is_shard() and pls[i] != want[i]:
            t = _gather(t, pls[i].dim, mesh, i)
            pls[i] = Replicate()
    for i, w in enumerate(want):
        if pls[i] == w:
            continue
        if w.is_shard():
            t = _piece(t, w.dim, mesh, i).contiguous()
            pls[i] = w
        elif not (w.is_partial() and grad):
            raise ValueError(f"cannot place {x.placements} as {want}")
    return DTensor.from_local(t, mesh, tuple(pls), run_check=False)


class _Redistribute(torch.autograd.Function):
    """`x` placed by `want`; its gradient placed by `want` too, then as
    `x` was."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.src, ctx.want = tuple(x.placements), tuple(want)
        return _move(x, want, grad=False)

    @staticmethod
    def backward(ctx, g):
        return _move(_move(g, ctx.want, grad=True), ctx.src, grad=True), None


def redistribute(x, want):
    """The DTensor `x` placed by `want` ({Shard, Replicate} a mesh dim),
    differentiable: its gradient is held to `want` and returned as `x`
    was placed."""
    return _Redistribute.apply(x, tuple(want))


def full(t):
    """The whole tensor of a DTensor, on every rank (a collective); any
    other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return _move(t, (Replicate(),) * t.device_mesh.ndim,
                     grad=False).to_local()


def shard_act(x, *axes):
    """Place activation `x` by logical axes, and hold its gradient to the
    same placement; a no-op without a mesh and on a plain tensor.
    Divisibility-aware: an axis whose dim the mesh axes' product does not
    divide is dropped (replicated)."""
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
    return redistribute(x, placements(tuple(spec), x.device_mesh))


def align(x, w, dims):
    """`x` placed for a product with the DTensor weight `w` that
    contracts each (x dim, w dim) pair of `dims`: where `w` is split on
    such a dim, `x` is split on its partner over the same mesh dim, so
    that each rank multiplies its pieces into a partial sum (the
    reference's row-parallel fallback) and no redistribution is left to
    the product. `x` itself without a mesh or where nothing needs to
    move."""
    if current_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    want = list(x.placements)
    for i, p in enumerate(w.placements):
        for xd, wd in dims:
            if p.is_shard() and p.dim == wd % w.ndim:
                want[i] = Shard(xd % x.ndim)
    if want == list(x.placements):
        return x
    return redistribute(x, want)


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


class _SumGrads(torch.autograd.Function):
    """The identity; the gradient is summed over `group`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself, its gradient summed over `group`: a tensor every rank
    holds whole and each uses part of (the replicated k and v of a
    tensor-parallel attention, each rank's query heads reading some of
    them)."""
    return _SumGrads.apply(x, group)
