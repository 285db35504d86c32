"""Elastic restart: resume a checkpoint on a different mesh (a port of
the reference's `distributed/elastic.py`).

The port's checkpoint is mesh-free: every tensor whole, in one flat
dict (`launch/train.py::flat_state`, `distributed/checkpoint.py`).
`resume_elastic` restores it and places each tensor by the new mesh's
rules (`sharding.param_shardings` / `opt_shardings`, `distribute`), so
going from N ranks to M is a restore, not a migration. The data
pipeline's (step, host)-deterministic addressing keeps the global batch
the same across meshes (`data/pipeline.py`).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import (distribute, opt_shardings,
                                              param_shardings)
from repro_torch.launch.mesh import mesh_device
from repro_torch.launch.train import flat_state, load_state


def _flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def resume_elastic(ckpt_dir: str, model, opt_init, new_mesh, *,
                   zero1: bool = False, step: Optional[int] = None,
                   device: DeviceLike = None) -> Tuple[Any, Any, int]:
    """(params, opt_state, step) restored from `ckpt_dir` (its newest
    intact step, or `step`) onto `new_mesh`, a DeviceMesh: on its device,
    each tensor placed by the mesh's rules (a DTensor where they split
    it). With `new_mesh` None, one process on `device`."""
    dev = resolve(device) if new_mesh is None else mesh_device(new_mesh)
    params = model.init_params(device=dev, trainable=True)
    opt_state = opt_init(params)
    restored, got = ckpt.restore(ckpt_dir, flat_state(params, opt_state, 0),
                                 step=step)
    load_state(restored, params, opt_state)
    if new_mesh is None:
        return params, opt_state, got
    cfg = model.cfg
    named = dict(params.named_parameters())
    for name, t in distribute(named, param_shardings(params, cfg, new_mesh),
                              new_mesh).items():
        if t is not named[name]:
            mod, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(mod), leaf, torch.nn.Parameter(t))
    specs = _flat(opt_shardings(opt_state, cfg, new_mesh, zero1=zero1))
    for path, t in distribute(_flat(opt_state), specs, new_mesh).items():
        node = opt_state
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t
    return params, opt_state, got
