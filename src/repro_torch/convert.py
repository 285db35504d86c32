"""State carry-across between the reference and the port.

The reference holds its simulator state as NamedTuples of JAX arrays
(`ISSState`, `PackedState`, the resident loop's `ResidentAcc`); the port
holds the same fields, in the same order and dtypes, as torch tensors.
These functions move one into the other through numpy, so the reference
and the port can be fed the same state and compared field by field. They
take any NamedTuple with the right field names (numpy arrays, or
anything `np.asarray` accepts) and never import the reference.

The port's `ResidentAcc` keeps one extra discard row at the end of each
shard's block of every per-item leaf (retire scatters of the shard's
lanes that did not retire land there); `mix_g` keeps the reference's
leading shard axis. `acc_to_torch`/`acc_to_numpy` add and drop the
discard rows.

`fault_spec_from` rebuilds a reference `FaultSpec` as the port's, so
both packages run the same fault schedule. For the carbon sweep,
`sweep_spec_from` rebuilds a reference `SweepSpec` as the port's
(profiles as the port's `DeviceProfile`, cores by name, distributions by
their components), and `sweep_acc_to_torch` / `sweep_acc_to_numpy` carry
the sweep's running accumulators.

For the hybrid LM (Zamba2), `hybrid_params_to_torch` turns the
reference's parameter pytree, given as numpy, into the port's
`HybridLM`: the stacked `mamba_groups` (n_groups, period, ...) and
`mamba_tail` (n_tail, ...) become one Mamba layer each, in the order the
model runs them, and the stacked `shared` (2, ...) one `DenseBlock`
each. Give bfloat16 leaves as float32 numpy (cast on the JAX side): the
cast back to the config's dtype is then exact. `hybrid_cache_to_numpy`
and `hybrid_cache_to_torch` carry the decode cache between the port's
per-layer stacks and the reference's `group_states` / `tail_states` /
`attn_k` / `attn_v`.

For the decoder (the dense and MoE families) and the Mamba2 LM,
`decoder_params_to_torch` and `ssm_params_to_torch` unstack the
reference's `dense_layers`, `moe_layers` and `layers` (n_layers, ...)
into one block each, the dense layers first (the QKV bias, MoE's shared
experts, the MTP head and, where the embedding is tied, no `lm_head`
included), under the same bfloat16 rule; the MoE router stays float32
whatever the model's dtype, as the Mamba leaves do (`F32_NAMES`). With
local:global attention (`global_every` g > 1, Gemma3) the reference
stacks `dense_layers`, and its cache, on (n_groups, g, ...) axes: layer
i is [i // g, i % g]. `decoder_cache_to_numpy/_to_torch` carry the cache
between the port's one stack a leaf, (n_layers, ...): `{"k", "v"}`, or
MLA's `{"c_kv", "k_rope"}`, and the reference's `{"dense": ..., "moe":
...}` of the same leaves; `ssm_cache_to_numpy/_to_torch` the state
between the port's stacked leaves and the reference's `{"states":
{...}}`.

For the encoder-decoder (Whisper), `encdec_params_to_torch` unstacks
the reference's `enc_layers` and `dec_layers` into one block each, and
`encdec_cache_to_numpy` / `encdec_cache_to_torch` carry its cache
(`self_k`, `self_v`, `cross_k`, `cross_v`, stacked on a leading layer
axis on both sides).

For training, `lm_params_to_numpy` is the inverse of the four
parameter converters: a `{port name: tensor}` dict (a module's
`named_parameters()`, or optimizer state under those names) as the
reference's stacked tree of float32 numpy. `reference_leaves` runs it on
the parameters' indices to tell which port names make up each of the
reference's leaves, and in what stacked shape: the grouping Adafactor
factors over (`optim/optimizers.py`) and the sharding rules read
(`distributed/sharding.py`); `reference_cache_leaves` does the same for
a decode cache, running the cache converters on each leaf's layer
indices. `adamw_state_to_torch` /
`adamw_state_to_numpy` carry AdamW's state between the reference's
`{"step", "m", "v"}` pytrees (in its parameter layout) and the port's
dicts under the port's names. The port keeps Adafactor's state in the
reference's layout already (its `vs` tree, stacked, under the
reference's paths, or under each name without `leaves`), so
`adafactor_state_to_torch` / `adafactor_state_to_numpy` map that tree
leaf for leaf.
"""
from __future__ import annotations

from typing import NamedTuple

import dataclasses

import numpy as np
import torch

from repro_torch.core.carbon import DeviceProfile
from repro_torch.core.sweep import LifetimeDist, SweepSpec
from repro_torch.device import DeviceLike, resolve
from repro_torch.fleet.engine import ResidentAcc
from repro_torch.flexibits.faults import FaultSpec
from repro_torch.flexibits.cycles import CORES
from repro_torch.flexibits.iss import ISSState, PackedState
from repro_torch.kernels.carbon_sweep import SweepAcc
from repro_torch.models import moe
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import F32_LEAVES, HybridLM, split_counts
from repro_torch.models.ssm import SSMLM
from repro_torch.models.transformer import (DecoderLM, layer_counts,
                                            torch_dtype)

# the leaves that stay float32 whatever the model's dtype: the Mamba
# layers' and the MoE router
F32_NAMES = F32_LEAVES + moe.F32_LEAVES

_ACC_ITEM_LEAVES = ("n_instr", "n_two", "n_cycles", "halted", "out",
                    "mems", "regs", "pc", "mix_items")


def _t(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def _n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def state_to_torch(st: NamedTuple, device: DeviceLike = None) -> ISSState:
    """An `ISSState`-shaped tuple of arrays -> the port's `ISSState`."""
    dev = resolve(device)
    return ISSState(*(_t(getattr(st, f), dev) for f in ISSState._fields))


def state_to_numpy(st: ISSState) -> ISSState:
    """The port's `ISSState` -> the same tuple of numpy arrays."""
    return ISSState(*(_n(x) for x in st))


def packed_to_torch(ps: NamedTuple, device: DeviceLike = None
                    ) -> PackedState:
    """A `PackedState`-shaped tuple -> the port's `PackedState`."""
    dev = resolve(device)
    return PackedState(lanes=state_to_torch(ps.lanes, dev),
                       prog_id=_t(ps.prog_id, dev),
                       max_steps=_t(ps.max_steps, dev))


def packed_to_numpy(ps: PackedState) -> PackedState:
    """The port's `PackedState` -> numpy arrays."""
    return PackedState(lanes=state_to_numpy(ps.lanes),
                       prog_id=_n(ps.prog_id), max_steps=_n(ps.max_steps))


def acc_to_torch(acc: NamedTuple, device: DeviceLike = None) -> ResidentAcc:
    """A reference `ResidentAcc`, sharded or not (`mix_g` of shape
    (n_shards, n_groups, 8), `n_shards * cap` item rows) -> the port's
    layout for one device's pool of those shards."""
    dev = resolve(device)
    n_sh = np.asarray(acc.mix_g).shape[0]
    out = {}
    for f in ResidentAcc._fields:
        v = getattr(acc, f)
        if v is None:
            out[f] = None
            continue
        v = np.asarray(v)
        if f in _ACC_ITEM_LEAVES:
            v = v.reshape((n_sh, -1) + v.shape[1:])
            v = np.concatenate(
                [v, np.zeros((n_sh, 1) + v.shape[2:], v.dtype)], axis=1)
            v = v.reshape((-1,) + v.shape[2:])
        out[f] = _t(v, dev)
    return ResidentAcc(**out)


def acc_to_numpy(acc: ResidentAcc) -> ResidentAcc:
    """The port's `ResidentAcc` -> the reference's layout (numpy arrays,
    each shard's discard row dropped)."""
    n_sh = acc.mix_g.shape[0]
    out = {}
    for f in ResidentAcc._fields:
        v = getattr(acc, f)
        if v is None:
            out[f] = None
        elif f in _ACC_ITEM_LEAVES:
            v = _n(v)
            v = v.reshape((n_sh, -1) + v.shape[1:])[:, :-1]
            out[f] = v.reshape((-1,) + v.shape[2:])
        else:
            out[f] = _n(v)
    return ResidentAcc(**out)


def fault_spec_from(ref_spec) -> FaultSpec:
    """A `FaultSpec`-shaped object (the reference's) -> the port's spec,
    field by field."""
    return FaultSpec(rate=ref_spec.rate, seed=ref_spec.seed,
                     targets=tuple(ref_spec.targets), mode=ref_spec.mode)


def sweep_spec_from(ref_spec) -> SweepSpec:
    """A `SweepSpec`-shaped object (the reference's) -> the port's spec:
    the same fields, with profiles, cores and distributions rebuilt from
    the port's own classes (cores looked up by name)."""
    prof_fields = [f.name for f in dataclasses.fields(DeviceProfile)]
    fields = {f.name: getattr(ref_spec, f.name)
              for f in dataclasses.fields(SweepSpec)}
    fields["profiles"] = tuple(
        DeviceProfile(**{k: getattr(p, k) for k in prof_fields})
        for p in ref_spec.profiles)
    fields["cores"] = tuple(CORES[c.name] for c in ref_spec.cores)
    fields["dists"] = tuple(LifetimeDist(d.name, tuple(d.comps))
                            for d in ref_spec.dists)
    return SweepSpec(**fields)


def sweep_acc_to_torch(acc: NamedTuple, device: DeviceLike = None
                       ) -> SweepAcc:
    """A `SweepAcc`-shaped tuple of arrays -> the port's `SweepAcc`."""
    dev = resolve(device)
    return SweepAcc(*(_t(getattr(acc, f), dev) for f in SweepAcc._fields))


def sweep_acc_to_numpy(acc: SweepAcc) -> SweepAcc:
    """The port's `SweepAcc` -> the same tuple of numpy arrays."""
    return SweepAcc(*(_n(x) for x in acc))


def _params_to_torch(dev, dtype):
    """Functions carrying a parameter subtree (nested dicts of numpy)
    to torch, and taking index `idx` of every leaf of a stacked one."""
    def leaf(x, name):
        dt = torch.float32 if name in F32_NAMES else dtype
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, dt)

    def conv(tree):
        return {k: conv(v) if isinstance(v, dict) else leaf(v, k)
                for k, v in tree.items()}

    def take(tree, *idx):
        return {k: take(v, *idx) if isinstance(v, dict) else
                np.asarray(v)[idx] for k, v in tree.items()}
    return leaf, conv, take


def _lm_params(params, layers, leaf) -> dict:
    """The embedding, final norm and (untied) head around `layers`."""
    out = {"embed": leaf(params["embed"], "embed"), "layers": layers,
           "final_norm": leaf(params["final_norm"], "final_norm")}
    if "lm_head" in params:
        out["lm_head"] = leaf(params["lm_head"], "lm_head")
    return out


def hybrid_params_to_torch(params, cfg, device: DeviceLike = None
                           ) -> HybridLM:
    """The reference's hybrid parameter pytree (nested dicts of numpy
    arrays) -> the port's `HybridLM` on `device`."""
    leaf, conv, take = _params_to_torch(resolve(device), torch_dtype(cfg))
    period, n_groups, n_tail = split_counts(cfg)
    layers = [conv(take(params["mamba_groups"], gi, j))
              for gi in range(n_groups) for j in range(period)]
    layers += [conv(take(params["mamba_tail"], j)) for j in range(n_tail)]
    return HybridLM({
        "embed": leaf(params["embed"], "embed"),
        "mamba": layers,
        "shared": [conv(take(params["shared"], i))
                   for i in range(cfg.n_shared_blocks)],
        "final_norm": leaf(params["final_norm"], "final_norm"),
        "lm_head": leaf(params["lm_head"], "lm_head")})


def _group(cfg) -> int:
    """The reference's dense layers a group (`global_every`, or 1)."""
    return cfg.global_every or 1


def decoder_params_to_torch(params, cfg, device: DeviceLike = None
                            ) -> DecoderLM:
    """The reference's decoder parameters (`init_decoder`'s pytree,
    numpy: `dense_layers`, `moe_layers`, `mtp`) -> the port's
    `DecoderLM` on `device`."""
    leaf, conv, take = _params_to_torch(resolve(device), torch_dtype(cfg))
    g = _group(cfg)
    n_dense, n_moe = layer_counts(cfg)
    layers = [conv(take(params["dense_layers"],
                        *(divmod(i, g) if g > 1 else (i,))))
              for i in range(n_dense)]
    layers += [conv(take(params["moe_layers"], i)) for i in range(n_moe)]
    out = _lm_params(params, layers, leaf)
    if "mtp" in params:
        out["mtp"] = conv(params["mtp"])
    return DecoderLM(out)


def encdec_params_to_torch(params, cfg, device: DeviceLike = None
                           ) -> EncDecLM:
    """The reference's encoder-decoder parameters (`init_encdec`'s
    pytree, numpy: stacked `enc_layers` and `dec_layers`) -> the port's
    `EncDecLM` on `device`."""
    leaf, conv, take = _params_to_torch(resolve(device), torch_dtype(cfg))
    return EncDecLM({
        **{k: leaf(params[k], k) for k in ("embed", "enc_norm", "final_norm",
                                           "lm_head")},
        "enc_layers": [conv(take(params["enc_layers"], i))
                       for i in range(cfg.n_enc_layers)],
        "dec_layers": [conv(take(params["dec_layers"], i))
                       for i in range(cfg.n_layers)]})


def ssm_params_to_torch(params, cfg, device: DeviceLike = None) -> SSMLM:
    """The reference's Mamba2 LM parameters (`init_ssm_lm`'s pytree,
    numpy) -> the port's `SSMLM` on `device`."""
    leaf, conv, take = _params_to_torch(resolve(device), torch_dtype(cfg))
    layers = [conv(take(params["layers"], i)) for i in range(cfg.n_layers)]
    return SSMLM(_lm_params(params, layers, leaf))


_STATE_KEYS = ("ssm", "conv_x", "conv_B", "conv_C")


def _f32(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t.astype(np.float32)
    return t.detach().cpu().float().numpy().copy()


def _from_f32(x, dev, dt) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(dev, dt)


def hybrid_cache_to_numpy(cache, cfg) -> dict:
    """The port's hybrid cache -> the reference's layout, float32 numpy."""
    period, n_groups, n_tail = split_counts(cfg)
    n_g = n_groups * period
    out = {"group_states": {k: _f32(cache[k][:n_g]).reshape(
               (n_groups, period) + tuple(cache[k].shape[1:]))
               for k in _STATE_KEYS},
           "attn_k": _f32(cache["attn_k"]), "attn_v": _f32(cache["attn_v"])}
    if n_tail:
        out["tail_states"] = {k: _f32(cache[k][n_g:]) for k in _STATE_KEYS}
    return out


def hybrid_cache_to_torch(cache, cfg, device: DeviceLike = None) -> dict:
    """A cache in the reference's layout (numpy; bfloat16 leaves as
    float32) -> the port's, on `device`."""
    dev = resolve(device)
    dtype = torch_dtype(cfg)
    period, n_groups, n_tail = split_counts(cfg)
    out = {}
    for k in _STATE_KEYS:
        parts = [np.asarray(cache["group_states"][k], np.float32).reshape(
            (n_groups * period,) + np.shape(cache["group_states"][k])[2:])]
        if n_tail:
            parts.append(np.asarray(cache["tail_states"][k], np.float32))
        dt = torch.float32 if k == "ssm" else dtype
        out[k] = torch.from_numpy(np.concatenate(parts)).to(dev, dt)
    for k in ("attn_k", "attn_v"):
        out[k] = _from_f32(cache[k], dev, dtype)
    return out


def _cache_keys(cfg):
    return ("c_kv", "k_rope") if cfg.mla else ("k", "v")


def decoder_cache_to_numpy(cache, cfg) -> dict:
    """The port's decoder cache -> the reference's layout, float32: the
    dense layers' part under "dense" (grouped as its parameters), the
    MoE layers' under "moe"."""
    g = _group(cfg)
    n_dense, n_moe = layer_counts(cfg)

    def grouped(x):
        return x.reshape((-1, g) + x.shape[1:]) if g > 1 else x
    out = {}
    if n_dense:
        out["dense"] = {k: grouped(_f32(cache[k][:n_dense]))
                        for k in _cache_keys(cfg)}
    if n_moe:
        out["moe"] = {k: _f32(cache[k][n_dense:]) for k in _cache_keys(cfg)}
    return out


def decoder_cache_to_torch(cache, cfg, device: DeviceLike = None) -> dict:
    """A decoder cache in the reference's layout (numpy; bfloat16 leaves
    as float32) -> the port's, on `device`."""
    dev, dtype = resolve(device), torch_dtype(cfg)

    def flat(x):
        x = np.asarray(x, np.float32)
        return x.reshape((-1,) + x.shape[2:]) if _group(cfg) > 1 else x
    out = {}
    for k in _cache_keys(cfg):
        parts = [flat(cache["dense"][k])] if "dense" in cache else []
        if "moe" in cache:
            parts.append(np.asarray(cache["moe"][k], np.float32))
        out[k] = _from_f32(np.concatenate(parts), dev, dtype)
    return out


_ENCDEC_CACHE = ("self_k", "self_v", "cross_k", "cross_v")


def encdec_cache_to_numpy(cache, cfg) -> dict:
    """The port's encoder-decoder cache -> the reference's, float32."""
    return {k: _f32(cache[k]) for k in _ENCDEC_CACHE}


def encdec_cache_to_torch(cache, cfg, device: DeviceLike = None) -> dict:
    """An encoder-decoder cache in the reference's layout (numpy;
    bfloat16 leaves as float32) -> the port's, on `device`."""
    dev, dtype = resolve(device), torch_dtype(cfg)
    return {k: _from_f32(cache[k], dev, dtype) for k in _ENCDEC_CACHE}


def ssm_cache_to_numpy(cache, cfg) -> dict:
    """The port's Mamba2 LM state -> the reference's layout, float32."""
    return {"states": {k: _f32(cache[k]) for k in _STATE_KEYS}}


def ssm_cache_to_torch(cache, cfg, device: DeviceLike = None) -> dict:
    """A Mamba2 LM state in the reference's layout (numpy; bfloat16
    leaves as float32) -> the port's, on `device`: `ssm` float32, the
    conv windows in the config's dtype."""
    dev, dtype = resolve(device), torch_dtype(cfg)
    return {k: _from_f32(cache["states"][k], dev,
                         torch.float32 if k == "ssm" else dtype)
            for k in _STATE_KEYS}


# --------------------------------------------------------------- training

_PARAMS_TO_TORCH = {"dense": decoder_params_to_torch,
                    "moe": decoder_params_to_torch,
                    "vlm": decoder_params_to_torch,
                    "hybrid": hybrid_params_to_torch,
                    "ssm": ssm_params_to_torch,
                    "audio": encdec_params_to_torch}


def lm_named_to_torch(tree, cfg, device: DeviceLike = None) -> dict:
    """A tree in the reference's parameter layout (numpy) -> {port name:
    float32 tensor} on `device`, the names of the port's module."""
    mod = _PARAMS_TO_TORCH[cfg.family](tree, cfg.replace(dtype="float32"),
                                       device)
    return {k: p.detach() for k, p in mod.named_parameters()}


def _stack(trees):
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def lm_params_to_numpy(named: dict, cfg) -> dict:
    """{port name: tensor (or numpy array)} -> the reference's parameter
    tree (stacked layers), float32 numpy."""
    nested: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        d = nested
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = _f32(t)

    def layers(key):
        return [nested[key][str(i)] for i in range(len(nested[key]))]

    out = {k: nested[k] for k in ("embed", "final_norm", "lm_head", "mtp",
                                  "enc_norm") if k in nested}
    if cfg.family in ("dense", "moe", "vlm"):
        g = _group(cfg)
        n_dense, n_moe = layer_counts(cfg)
        blocks = layers("layers")
        if n_dense:
            out["dense_layers"] = _stack(blocks[:n_dense])
            if g > 1:
                out["dense_layers"] = _map(
                    lambda v: v.reshape((-1, g) + v.shape[1:]),
                    out["dense_layers"])
        if n_moe:
            out["moe_layers"] = _stack(blocks[n_dense:])
    elif cfg.family == "ssm":
        out["layers"] = _stack(layers("layers"))
    elif cfg.family == "hybrid":
        period, n_groups, n_tail = split_counts(cfg)
        mamba = layers("mamba")
        n_g = n_groups * period
        out["mamba_groups"] = _map(
            lambda v: v.reshape((n_groups, period) + v.shape[1:]),
            _stack(mamba[:n_g]))
        if n_tail:
            out["mamba_tail"] = _stack(mamba[n_g:])
        out["shared"] = _stack(layers("shared"))
    elif cfg.family == "audio":
        out["enc_layers"] = _stack(layers("enc_layers"))
        out["dec_layers"] = _stack(layers("dec_layers"))
    else:
        raise KeyError(f"family {cfg.family!r} has no port")
    return out


def adamw_state_to_torch(state, cfg, device: DeviceLike = None) -> dict:
    """The reference's AdamW state (numpy; m and v in its parameter
    layout) -> the port's, on `device`."""
    dev = resolve(device)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "m": lm_named_to_torch(state["m"], cfg, dev),
            "v": lm_named_to_torch(state["v"], cfg, dev)}


def adamw_state_to_numpy(state, cfg) -> dict:
    """The port's AdamW state -> the reference's layout, numpy."""
    return {"step": np.int32(int(state["step"])),
            "m": lm_params_to_numpy(state["m"], cfg),
            "v": lm_params_to_numpy(state["v"], cfg)}


def reference_leaves(named: dict, cfg) -> dict:
    """{path of one of the reference's parameter leaves (a tuple of
    keys): (the port's names that make it up, in the C order of its
    stacked layer axes; those axes' shape, () for a leaf the reference
    does not stack)}, for the port's parameter names `named` (a dict or
    a list): `lm_params_to_numpy` run on each name's index."""
    names = list(named)
    index = {k: np.array(i, np.float32) for i, k in enumerate(names)}
    out = {}

    def walk(path, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(path + (k,), v)
            else:
                out[path + (k,)] = (tuple(names[int(i)] for i in
                                          v.reshape(-1)), v.shape)
    walk((), lm_params_to_numpy(index, cfg))
    return out


_CACHE_TO_NUMPY = {"dense": decoder_cache_to_numpy,
                   "moe": decoder_cache_to_numpy,
                   "vlm": decoder_cache_to_numpy,
                   "hybrid": hybrid_cache_to_numpy,
                   "ssm": ssm_cache_to_numpy,
                   "audio": encdec_cache_to_numpy}


def reference_cache_leaves(cache: dict, cfg) -> dict:
    """{path of one of the reference's cache leaves: (the port's cache
    key it comes from, the first and one past the last of the port
    leaf's layers (dim 0) it holds, its stacked layer axes' shape)}, for
    a port cache (real, meta or fake tensors): the cache converters run
    on each leaf's layer indices. A reference leaf keeps the port key's
    name, and holds a run of its layers in order."""
    index = {k: np.arange(v.shape[0], dtype=np.float32).reshape(
        (-1,) + (1,) * (v.dim() - 1)) for k, v in cache.items()}
    out = {}

    def walk(path, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(path + (k,), v)
                continue
            n_stack = v.ndim - (cache[k].dim() - 1)
            layers = v.reshape(-1).astype(int)
            out[path + (k,)] = (k, int(layers[0]), int(layers[-1]) + 1,
                                v.shape[:n_stack])
    walk((), _CACHE_TO_NUMPY[cfg.family](index, cfg))
    return out


def adafactor_state_to_torch(state, device: DeviceLike = None) -> dict:
    """The reference's Adafactor state (numpy; `vs` in its parameter
    layout, or a flat {name: ...} dict's) -> the port's, on `device`."""
    dev = resolve(device)
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "vs": _map(lambda x: _t(np.asarray(x, np.float32), dev),
                       state["vs"])}


def adafactor_state_to_numpy(state) -> dict:
    """The port's Adafactor state -> the reference's layout, numpy."""
    return {"step": np.int32(int(state["step"])),
            "vs": _map(_f32, state["vs"])}
