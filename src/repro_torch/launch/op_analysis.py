"""FLOPs, bytes, op counts and collectives of one step, counted on fake
tensors: the port's counterpart of the reference's
`launch/hlo_analysis.py`.

The reference parses the post-SPMD HLO that XLA compiles for a
512-device mesh. PyTorch has no HLO, so this module, named for what it
reads, runs the step once on fake tensors (shapes and dtypes only,
nothing allocated, no card needed) under a `TorchDispatchMode` that sees
every aten op the step dispatches, its backward included:

  * FLOPs by `torch.utils.flop_counter`'s formulas (matmuls, batched
    matmuls, convolutions, attention; einsum dispatches as these),
  * bytes as each op's tensor inputs plus outputs (views move none),
  * op counts by aten name (`op_counts`), of the ops that make a tensor.

Eager torch has no loops for it to fold, so `unknown_trip_counts` is
always 0. The kernels' wrappers take their plain versions on fake
tensors, and the counts are theirs: the flash attention's plain version
runs the kernel's tiles (those above the causal diagonal skipped, as the
card's kernel skips them), in float32; the SSD scan's its chunks.

Per device: FLOPs and activation bytes are the global counts over the
chips. Bytes of the state, the parameters, the optimizer state and the
decode cache, count at each tensor's shard of the mesh's rules
(`distributed/sharding.py`); gradients count as activations.
Collectives: the data-axis gradient all-reduce of a train step (the
port's one float32 all-reduce of `launch/steps.py::mean_over`), at the
reference's ring factor of 2 x its bytes. `model`-axis collectives wait
for tensor parallelism (ROADMAP.md item 13g), so `collectives_counted`
lists "data" alone.
"""
from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import CachePart, ParamSpec, mesh_shape

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched inside it. `state` maps a tensor
    storage's key (`_key`) to the share of it one device holds; ops
    touching other storages count in full."""

    def __init__(self, state=None):
        super().__init__()
        self.state = state or {}
        self.flops = 0.0
        self.bytes = 0.0          # global, outside the state
        self.state_bytes = 0.0    # per device
        self.ops: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if next(_tensors(out), None) is None:
            return out          # metadata queries (prim.device, sizes)
        packet = func._overloadpacket
        self.ops[packet.__name__] += 1
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if not func.is_view:
            for t in _tensors((args, kwargs, out)):
                nb = t.numel() * t.element_size()
                share = self.state.get(_key(t))
                if share is None:
                    self.bytes += nb
                else:
                    self.state_bytes += nb * share
        return out


def spec_share(spec, mesh) -> float:
    """The share of a tensor one device holds under `spec`: a tuple of
    None, axis names or tuples of names, a `ParamSpec`, or a tuple of a
    cache leaf's `CachePart`s."""
    if spec and isinstance(spec[0], CachePart):
        n = sum(p.stop - p.start for p in spec)
        return sum((p.stop - p.start) / n * spec_share(p.stack + p.spec, mesh)
                   for p in spec)
    if isinstance(spec, ParamSpec):
        spec = spec.stack + spec.spec
    shape = mesh_shape(mesh)
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                n *= shape[a]
    return 1.0 / n


def state_shares(tensors: Dict, specs: Dict, mesh) -> Dict[int, float]:
    """{storage key: the share one device holds} for {name: tensor}
    placed by {name: spec}."""
    return {_key(t): spec_share(specs[k], mesh) for k, t in tensors.items()}


def shard_bytes(tensors: Dict, specs: Dict, mesh) -> float:
    """The bytes of {name: tensor} one device holds, placed by specs."""
    return float(sum(t.numel() * t.element_size()
                     * spec_share(specs[k], mesh) for k, t in
                     tensors.items()))


def analyze(counter: OpCounter, n_chips: int, allreduce_bytes: float = 0.0
            ) -> Dict:
    """`analyze_hlo`'s keys for a counted step, per device."""
    per_op = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    if allreduce_bytes:
        per_op["all-reduce"] = 2.0 * allreduce_bytes
        counts["all-reduce"] = 1
    return {
        "flops_per_device": counter.flops / n_chips,
        "bytes_per_device": counter.bytes / n_chips + counter.state_bytes,
        "collective_bytes_per_device": sum(per_op.values()),
        "collective_per_op": per_op,
        "collective_counts": counts,
        "unknown_trip_counts": 0,
        "collectives_counted": ["data"],
        "op_counts": dict(sorted(counter.ops.items())),
    }
