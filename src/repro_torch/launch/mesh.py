"""Meshes (a port of the reference's `launch/mesh.py`). Functions only:
importing this module starts no process group.

`make_host_mesh` is a (data, model) `torch.distributed` `DeviceMesh`
over the ranks of this process group; without one it starts a one-rank
group through a local store (NCCL on the card, gloo on the CPU), so one
card gives a (1, 1) mesh. Several cards run one process each under
`torchrun`, which starts the group (`launch/train.py --data-parallel`
asks for a (ranks, 1) mesh). `make_production_mesh` is the
reference's (16, 16) or (2, 16, 16): a `DeviceMesh` where the world has
256 or 512 ranks, else an `AbstractMesh` for the dry run.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed.sharding import AbstractMesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def ensure_process_group(device: DeviceLike = None) -> None:
    """Start the process group where none is running, NCCL for the card
    and gloo for the CPU: from `torchrun`'s environment (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR), each rank on card LOCAL_RANK, or
    else one rank through a local store."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dev = resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(device: DeviceLike = None, *, model=None):
    """The process group's ranks as a (data, model) DeviceMesh. The model
    axis is `model`, or by default the reference's choice: 4, else 2,
    else 1, the first that divides the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    ensure_process_group(device)
    n = dist.get_world_size()
    if model is None:
        model = next(m for m in (4, 2, 1) if n % m == 0)
    return init_device_mesh(resolve(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """(16, 16) (data, model), or (2, 16, 16) (pod, data, model): 256 or
    512 chips. A DeviceMesh where the running process group has exactly
    that many ranks, else an AbstractMesh (the dry run's)."""
    import torch.distributed as dist
    shape, names = PRODUCTION[multi_pod]
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(resolve(device).type, shape,
                                mesh_dim_names=names)
    return AbstractMesh(names, shape)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on for `mesh`: its card, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
