"""Elastic restart: resume a checkpoint on a different mesh (a port of
the reference's `distributed/elastic.py`).

The port's checkpoint is mesh-free: every tensor whole, in one flat
dict (`launch/train.py::flat_state`, `distributed/checkpoint.py`).
`resume_elastic` places the parameters by the new mesh's rules
(`sharding.place_params`; AdamW's moments mirror them, as
`opt_shardings` says) and copies each rank's piece of every restored
tensor into them, so going from N ranks to M, or from one model-axis
size to another, is a restore, not a migration. The data pipeline's
(step, host)-deterministic addressing keeps the global batch the same
across meshes (`data/pipeline.py`).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed.sharding import place_params
from repro_torch.launch.mesh import mesh_device
from repro_torch.launch.train import check_mesh, restore_into


def resume_elastic(ckpt_dir: str, model, opt_init, new_mesh, *,
                   zero1: bool = False, step: Optional[int] = None,
                   device: DeviceLike = None) -> Tuple[Any, Any, int]:
    """(params, opt_state, step) restored from `ckpt_dir` (its newest
    intact step, or `step`) onto `new_mesh`, a DeviceMesh: on its device,
    each tensor placed by the mesh's rules (a DTensor on its model axis
    where that axis is above 1). With `new_mesh` None, one process on
    `device`. What `launch/train.py` cannot run on the mesh raises
    (ROADMAP.md item 13g), as ZeRO-1 over more than one data rank does."""
    if new_mesh is not None:
        check_mesh(new_mesh, model.cfg.replace(zero1=zero1))
    dev = resolve(device) if new_mesh is None else mesh_device(new_mesh)
    params = model.init_params(device=dev, trainable=True)
    if new_mesh is not None:
        place_params(params, model.cfg, new_mesh)
    opt_state = opt_init(params)
    got = restore_into(ckpt_dir, params, opt_state, step=step)
    return params, opt_state, got
