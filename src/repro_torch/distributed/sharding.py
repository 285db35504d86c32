"""Parameter, optimizer, batch, cache and fleet sharding rules (a port
of the reference's `distributed/sharding.py`).

The rules are name and shape driven and divisibility-aware: the
preferred dim is sharded over `model` only when the model axis's size
divides it, else a fallback applies (GQA with 2 KV heads on a 16-way
model axis shards the contracting d_model dim instead, Megatron
row-parallel). Batch dims shard over ('pod', 'data') when the mesh has a
pod axis.

A spec is a tuple with one entry a dim: None (replicated), an axis name,
or a tuple of axis names (the dim split over their product, the first
axis major), as the reference's `PartitionSpec`.

The reference stacks a model's layers on leading axes of one leaf
(n_layers, ...), or (n_groups, g, ...), and its rules index that leaf's
dims from the end and read its `ndim`; the port holds one tensor a
layer. So the rules here run on the reference's leaf path and stacked
shape (`convert.reference_leaves`), and each port tensor gets a
`ParamSpec`: `stack`, the spec of the stacked axes (where a rule picks
one, layer i of n lives on the ranks whose coordinate on that axis is
i // (n / axis size)), and `spec`, the spec of its own dims. The
reference's expert rule, for one, reads the stacked shared expert
(L, D, F) as (E, D, F) and shards its layer axis where the model axis
divides L. Caches are mapped to the reference's leaves the same way
(`convert.reference_cache_leaves`), one `CachePart` a leaf.

`placements` maps a spec onto a `torch.distributed` `DeviceMesh` as
DTensor placements and `distribute` places tensors by their specs.

Tensor parallelism (a model axis above 1) runs on DTensors over the
model axis's own one-axis sub-mesh (`mesh["model"]`): the batch axes stay
data parallelism, each rank's batch slice a plain tensor that every rank
of its model group holds whole. `place_params` / `place_state` make every
parameter and optimizer tensor such a DTensor, split where the rules
split it and replicated elsewhere; `place_like` makes a constant (a RoPE
table, a mask) a DTensor beside the activation it meets, and `local` /
`wrap_like` step between a DTensor and its local piece.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh for shape-only sharding: the counterpart of the
    reference's `abstract_mesh`. `shape` maps each axis name to its
    size, in order."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class ParamSpec(NamedTuple):
    """A port tensor's placement: the spec of the reference's stacked
    layer axes it is one index of, and the spec of its own dims."""
    stack: Spec
    spec: Spec


class CachePart(NamedTuple):
    """The layers [start, stop) of a port cache leaf's leading axis that
    make up one of the reference's cache leaves, with that leaf's stack
    and own specs."""
    start: int
    stop: int
    stack: Spec
    spec: Spec


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of an `AbstractMesh` or a `DeviceMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _model_axis_size(mesh) -> int:
    return mesh_shape(mesh)["model"]


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _batch_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in batch_axes(mesh))


def _batch_entry(mesh) -> Axis:
    baxes = batch_axes(mesh)
    return baxes if len(baxes) > 1 else baxes[0]


def _map(fn, tree):
    """fn over every tensor of nested dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


# ------------------------------------------------------------ fleet lanes

def lane_specs(mesh, state):
    """Fleet-lane layout: dim 0 of every leaf over every mesh axis (the
    fleet engine is pure data parallelism; the lane pool flattens the
    whole mesh into one device axis)."""
    axes = axis_names(mesh)
    return _map(lambda t: (axes,) + (None,) * (t.ndim - 1), state)


def bank_specs(mesh, tree):
    """Program-bank layout: every leaf replicated (every lane reads the
    bank every step)."""
    return _map(lambda t: (), tree)


def stage_specs(mesh, tree):
    """Staged-refill-buffer layout: dim 0, the shard axis, over every
    mesh axis, so each device holds only its own shard's rows."""
    axes = axis_names(mesh)
    return _map(lambda t: (axes,) + (None,) * (t.ndim - 1), tree)


# ------------------------------------------------------------- parameters

# Priority lists of dims per parameter name (the reference's): python
# indices into the leaf's shape, negative from the end.
_RULES = {
    # embeddings / heads
    "embed": [-2],          # (V, D): shard vocab
    "lm_head": [-1],        # (D, V): shard vocab
    # attention
    "wq": [-2, -3],         # (D, H, Dh): heads, else contracting D
    "wk": [-2, -3],
    "wv": [-2, -3],
    "wo": [-3, -2],         # (H, Dh, D): heads, else Dh (both contracting)
    "bq": [-2], "bk": [-2], "bv": [-2],
    # dense mlp
    "wi": [-1], "wg": [-1],     # (D, F): shard F
    # MLA
    "w_dq": [-1], "w_uq": [-2, -3], "w_dkv": [], "w_kr": [],
    "w_uk": [-2, -3], "w_uv": [-2, -3],
    # moe (E, D, F) handled specially by name prefix 'moe/'
    "router": [],
    # mamba
    "wz": [-1], "wx": [-1], "wdt": [-1], "wB": [], "wC": [],
    "conv_x": [-1], "conv_bx": [-1],
    "conv_B": [], "conv_C": [], "conv_bB": [], "conv_bC": [],
    "A_log": [-1], "dt_bias": [-1], "D": [-1], "norm_w": [-1],
    "out_proj": [-2],       # (d_inner, D): contracting
    # mtp
    "proj": [],
    # adafactor factored moments (see opt_shardings)
    "r": [-2, -1], "c": [-2, -1],
}


def spec_for_param(keys: Tuple[str, ...], shape, mesh) -> Spec:
    """The reference's rule for the leaf at path `keys` (dict keys, the
    leaf's name last) of shape `shape`: the stacked leaf's shape, where
    the reference stacks it."""
    msize = _model_axis_size(mesh)
    name = keys[-1]
    ndim = len(shape)
    spec = [None] * ndim

    def try_dims(dims) -> Optional[int]:
        for d in dims:
            dd = d % ndim if d < 0 else d
            if 0 <= dd < ndim and shape[dd] % msize == 0 and shape[dd] > 1:
                return dd
        return None

    in_moe = any(k in ("moe", "wi_e", "wg_e", "wo_e") for k in keys) and \
        name in ("wi", "wg", "wo")
    in_mlp = "mlp" in keys or "shared" in keys

    if in_moe:
        # (L?, E, D, F) for wi/wg; (L?, E, F, D) for wo: expert parallel
        # on E where it divides. The shared expert under `moe` takes this
        # branch too, so its stacked layer axis stands for E
        e_dim = ndim - 3
        if shape[e_dim] % msize == 0:
            spec[e_dim] = "model"
            return tuple(spec)
        f_dim = ndim - 1 if name in ("wi", "wg") else ndim - 2
        if shape[f_dim] % msize == 0:
            spec[f_dim] = "model"
        return tuple(spec)

    if name == "wo" and in_mlp:
        # dense mlp wo: (F, D): shard contracting F
        d = try_dims([-2])
        if d is not None:
            spec[d] = "model"
        return tuple(spec)

    dims = _RULES.get(name)
    if dims is None:
        return tuple(spec)          # replicate unknown/small params
    d = try_dims(dims)
    if d is not None:
        spec[d] = "model"
    return tuple(spec)


def _named_shapes(params) -> dict:
    """{port name: shape} of a parameters module or a {name: tensor}
    dict."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {k: tuple(p.shape) for k, p in items}


def _param_index(shapes: dict, cfg) -> dict:
    """{port name: (the reference's leaf path, its stacked shape, the
    stack's rank)}."""
    from repro_torch.convert import reference_leaves
    out = {}
    for path, (names, stack) in reference_leaves(list(shapes), cfg).items():
        for n in names:
            out[n] = (path, tuple(stack) + shapes[n], len(stack))
    missing = set(shapes) - set(out)
    if missing:
        raise KeyError(f"no reference leaf for {sorted(missing)}")
    return out


def _split(spec: Spec, n_stack: int) -> ParamSpec:
    return ParamSpec(tuple(spec[:n_stack]), tuple(spec[n_stack:]))


def param_shardings(params, cfg, mesh) -> dict:
    """{port name: ParamSpec} for a model's parameters (a module or a
    {name: tensor} dict; meta or fake tensors do)."""
    index = _param_index(_named_shapes(params), cfg)
    return {n: _split(spec_for_param(path, shape, mesh), k)
            for n, (path, shape, k) in index.items()}


def _zero1(spec: Spec, shape, dsize: int) -> Spec:
    """ZeRO-1: a moment leaf's dim 0 (the stacked-layers dim) over
    'data' where free and divisible."""
    lst = list(spec) + [None] * (len(shape) - len(spec))
    if shape and lst[0] is None and shape[0] > 1 and shape[0] % dsize == 0:
        lst[0] = "data"
    return tuple(lst)


def opt_shardings(opt_state, cfg, mesh, *, zero1: bool = False) -> dict:
    """Specs for optimizer state, the same tree as `opt_state`: AdamW's
    m, v (and master) under the port's names mirror their parameters
    (the rules read the leaf names); Adafactor's `vs`, which the port
    keeps in the reference's stacked layout under its paths, gets the
    rules on those paths (r and c shard their largest divisible dim).
    With `zero1`, moment leaves also shard dim 0 of the stacked leaf
    over 'data'. Scalars (`step`) are replicated."""
    dsize = mesh_shape(mesh)["data"]
    index = None

    def leaf(keys, shape, n_stack):
        spec = spec_for_param(keys, shape, mesh) if shape else ()
        if zero1 and keys[0] in ("m", "v", "vs", "master"):
            spec = _zero1(spec, shape, dsize)
        return _split(spec, n_stack)

    def walk(keys, tree):
        nonlocal index
        if not isinstance(tree, dict):
            return leaf(keys, tuple(tree.shape), 0)
        if keys and keys[0] in ("m", "v", "master") and len(keys) == 1:
            index = index or _param_index(_named_shapes(tree), cfg)
            return {n: leaf(keys + index[n][0], index[n][1], index[n][2])
                    for n in tree}
        return {k: walk(keys + (k,), v) for k, v in tree.items()}
    return walk((), opt_state)


# ------------------------------------------------------- batch and cache

def batch_shardings(batch, mesh) -> dict:
    """Dim 0 (batch) over ('pod', 'data'); replicated where indivisible
    (long_500k's batch of 1); scalars replicated. `batch`: {name: a
    tensor or a shape}."""
    bsize = _batch_size(mesh)

    def one(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape:
            return ()
        if shape[0] % bsize == 0:
            return (_batch_entry(mesh),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)
    return {k: one(v) for k, v in batch.items()}


def _cache_spec(name: str, shape, mesh) -> Spec:
    """The reference's rule for a stacked cache leaf (L?, B, ...): batch
    over the data axes at dim 1; attention K/V heads over `model` when
    divisible, else the sequence (never the contracting head dim); MLA
    latents the sequence; SSM states their heads, conv windows their
    channels."""
    bsize = _batch_size(mesh)
    msize = _model_axis_size(mesh)
    nd = len(shape)
    spec = [None] * nd
    if nd < 3:
        return tuple(spec)
    bdim = 1   # the reference reads every cache leaf as (L, B, ...)
    if shape[bdim] % bsize == 0 and shape[bdim] > 1:
        spec[bdim] = _batch_entry(mesh)

    def try_model(dims):
        for d in dims:
            dd = d % nd
            if spec[dd] is None and shape[dd] > 1 and shape[dd] % msize == 0:
                spec[dd] = "model"
                return

    if name in ("c_kv", "k_rope"):
        try_model([2])                       # MLA: sequence dim
    elif name == "ssm":
        try_model([-3])                      # (L,B,H,N,P): heads
    elif name.startswith("conv"):
        try_model([-1])                      # channels
    else:                                    # attention k/v caches
        try_model([-2, 2])                   # heads, else sequence
    return tuple(spec)


def cache_shardings(cache, cfg, mesh) -> dict:
    """{port cache key: tuple of CachePart}: the reference's rule on each
    of its cache leaves (its stacked shape, grouped where it groups
    layers) that the port's leaf (layers on dim 0) holds."""
    from repro_torch.convert import reference_cache_leaves
    out: dict = {}
    for path, (key, start, stop, stack) in reference_cache_leaves(
            cache, cfg).items():
        shape = tuple(stack) + tuple(cache[key].shape[1:])
        spec = _cache_spec(path[-1], shape, mesh)
        out.setdefault(key, []).append(CachePart(
            start, stop, spec[:len(stack)], spec[len(stack):]))
    return {k: tuple(sorted(v)) for k, v in out.items()}


# ---------------------------------------------------------- device meshes

def placements(spec: Spec, device_mesh):
    """DTensor placements of `spec` on `device_mesh`: Shard(d) on each
    mesh dim whose axis names dim d's entry, Replicate elsewhere (an
    entry of several axes shards its dim over them in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in device_mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _sharded(spec: Spec, mesh) -> bool:
    """Whether `spec` splits anything over an axis of size > 1."""
    shape = mesh_shape(mesh)
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and shape[a] > 1:
                return True
    return False


def _own_spec(name, s, mesh) -> Spec:
    """The spec of a tensor's own dims; raises where its stacked layer
    index is split over an axis of size > 1."""
    stack, spec = (s.stack, s.spec) if isinstance(s, ParamSpec) else ((), s)
    if _sharded(stack, mesh):
        raise NotImplementedError(
            f"{name}: its stacked layer index is split over the mesh "
            f"({stack}); layers placed on separate ranks need expert or "
            f"ZeRO-1 parallelism, which the port does not run (ROADMAP.md "
            f"item 13g)")
    return spec


def distribute(named: dict, specs: dict, device_mesh) -> dict:
    """{name: tensor} placed by `specs` ({name: ParamSpec or spec}) on
    `device_mesh`: a DTensor where the spec splits a dim over an axis of
    size > 1, the tensor itself where every placement replicates. Every
    rank calls it with the same full tensors, and keeps its piece of
    each: no collective runs."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, t in named.items():
        spec = _own_spec(k, specs[k], device_mesh)
        if not _sharded(spec, device_mesh):
            out[k] = t
            continue
        with torch.no_grad():
            out[k] = distribute_tensor(t, device_mesh,
                                       placements(spec, device_mesh),
                                       src_data_rank=None)
    return out


# ------------------------------------------------- tensor parallelism

def place(named: dict, specs: dict, mesh) -> dict:
    """{name: tensor} for a step on `mesh`, every rank calling it with
    the same full tensors: with a model axis of 1 the tensors themselves;
    above it each a DTensor on `mesh["model"]`, Shard where its spec
    names `model`, Replicate elsewhere, this rank keeping its piece (no
    collective runs); a scalar (AdamW's step) stays itself. A spec that
    splits a batch axis of size > 1 (ZeRO-1) raises, as does a split
    stacked layer index: ROADMAP.md item 13g."""
    from torch.distributed.tensor import distribute_tensor
    shape = mesh_shape(mesh)
    if shape["model"] == 1:
        return dict(named)
    sub = mesh["model"]
    out = {}
    for k, t in named.items():
        spec = _own_spec(k, specs[k], mesh)
        if t.ndim == 0:
            out[k] = t
            continue
        split = {a for e in spec for a in (e if isinstance(e, tuple) else
                                            (e,)) if a is not None}
        if any(shape[a] > 1 for a in split - {"model"}):
            raise NotImplementedError(
                f"{k}: its spec {spec} splits a batch axis of the mesh "
                f"{shape}; ZeRO-1 is not ported (ROADMAP.md item 13g)")
        with torch.no_grad():
            out[k] = distribute_tensor(t.detach(), sub, placements(spec, sub),
                                       src_data_rank=None)
    return out


def place_params(params, cfg, mesh):
    """Replace each parameter of the module `params` by its `place`d
    DTensor (`param_shardings`' rules), in place; a no-op at a model
    axis of 1. Returns `params`."""
    named = dict(params.named_parameters())
    for name, t in place(named, param_shardings(params, cfg, mesh),
                         mesh).items():
        if t is not named[name]:
            mod, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(mod), leaf, torch.nn.Parameter(
                t, requires_grad=named[name].requires_grad))
    return params


def place_state(opt_state: dict, cfg, mesh) -> dict:
    """The optimizer state tree with each tensor `place`d by
    `opt_shardings`' rules."""
    specs = opt_shardings(opt_state, cfg, mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return place({"t": tree}, {"t": spec}, mesh)["t"]
    return walk(opt_state, specs)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """A DTensor's local piece (the tensor itself under no_grad, so an
    in-place update of it updates the DTensor); any other tensor as it
    is."""
    return t.to_local() if is_dtensor(t) else t


def wrap_like(piece: torch.Tensor, t):
    """`piece`, this rank's part of a tensor placed as `t` is, as a
    DTensor placed so; `piece` itself where `t` is no DTensor."""
    if not is_dtensor(t):
        return piece
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(piece, t.device_mesh, t.placements,
                              run_check=False)


def place_like(t: torch.Tensor, ref):
    """The constant `t` (a mask, a RoPE table) for an operation with the
    DTensor `ref`, which `t` broadcasts against from the right: a DTensor
    on `ref`'s mesh, split as `ref` is where `t` has that dim in full,
    replicated elsewhere, so that the operation needs no collective. `t`
    itself where `ref` is no DTensor."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    off = ref.ndim - t.ndim
    pls = []
    for p in ref.placements:
        d = p.dim - off if p.is_shard() else -1
        pls.append(Shard(d) if d >= 0 and t.shape[d] == ref.shape[p.dim]
                   else Replicate())
    return distribute_tensor(t, ref.device_mesh, pls, src_data_rank=None)
