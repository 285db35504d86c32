"""Train loop: auto-resume, atomic checkpoints, straggler watchdog,
optional gradient accumulation (a port of the reference's
`launch/train.py`). Runs on one card (`device=None` means "cuda" and
raises without one), on request on the CPU, or data-parallel over a
`torch.distributed` mesh (`mesh=`, `launch/mesh.py`): one process a
rank, each rank's card its own (`torchrun` starts them on several
cards; on the CPU, gloo ranks).

Parameters are drawn from a `torch.Generator` seeded `seed` on the
device (the reference's `jax.random.key(0)` has no torch counterpart;
the tests carry the reference's parameters across by `convert`), and
the batches are `data/pipeline.host_batch`'s. A checkpoint is one flat
dict, `params/<name>`, `opt/<key>[/<name>...]` and `step`, through
`distributed/checkpoint.py`; a run resumes from the newest intact one.
A step's `dt` is the wall time from the step's start to the loss's
`.item()`, as the reference measures it up to `float(loss)`.

Under a mesh each rank draws the same parameters, takes its slice of
each step's global batch over the batch axes (`host_batch(...,
host_id=rank, n_hosts=ranks)`), and the step averages gradients and
loss terms over the batch group in one all-reduce before the optimizer
(`launch/steps.py`). With a model axis of 1 the parameters and optimizer
state stay whole and replicated. Above 1 the dense family (Qwen2,
Qwen2.5, Minitron, Gemma3) runs tensor-parallel: each parameter is
placed by the reference's rules (`sharding.place_params`: a DTensor on
the model axis, split where the rules split it) and AdamW's moments
mirror it, so a rank holds only its pieces; the forward places
activations as the reference's `shard_act` calls do
(`models/transformer.py`) and the flash kernels run on each rank's heads
(`kernels/ops.py`). A checkpoint stays mesh-free: every rank gathers
each tensor whole and rank 0 alone writes it, and every rank waits for
it; a restore places each tensor again. Every other family at a model
axis above 1, Adafactor there, and ZeRO-1 (`cfg.zero1`) over more than
one data rank raise NotImplementedError (ROADMAP.md item 13g).

Every decoder, hybrid and SSM arch trains here (`--arch
qwen2-moe-a2.7b` among them; `--arch deepseek-v3-671b` with the
reference's Adafactor); the VLM and audio families need patches or
frames in the batch, which the reference's loop does not draw either:
they train through `launch/steps.py::make_train_step`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 20 --ckpt-dir /tmp/ckpt [--batch 8 --seq 128] \
      [--device cpu]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --data-parallel \
      --arch qwen2-1.5b --steps 20 --batch 32 --seq 512
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.meshctx import (batch_group, full, mesh_context,
                                             piece_of)
from repro_torch.distributed.sharding import (AbstractMesh, is_dtensor, local,
                                              mesh_shape, place_params)
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_device)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model


class StragglerWatchdog:
    """Flags steps slower than `factor` x the running median. On real pods
    this feeds the rescheduling hook; here it logs (and is unit-tested)."""

    def __init__(self, factor: float = 2.0, warmup: int = 3):
        self.times = []
        self.factor = factor
        self.warmup = warmup
        self.flagged = []

    def observe(self, step: int, dt: float) -> bool:
        slow = (len(self.times) >= self.warmup
                and dt > self.factor * float(np.median(self.times)))
        self.times.append(dt)
        if slow:
            self.flagged.append((step, dt))
        return slow


def _state_items(params, opt_state) -> dict:
    """{checkpoint key: tensor}: `params/<name>` and the optimizer
    state's leaves under `opt/` joined by "/"."""
    out = {f"params/{k}": p.detach() for k, p in params.named_parameters()}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                out[f"{prefix}{k}"] = v
    walk("opt/", opt_state)
    return out


def flat_state(params, opt_state, step: int) -> dict:
    """The checkpoint tree: `params/<name>`, the optimizer state's leaves
    under `opt/` joined by "/", and `step`; each DTensor gathered whole,
    so every rank of its mesh must call it."""
    out = {k: full(v) for k, v in _state_items(params, opt_state).items()}
    out["step"] = np.int64(step)
    return out


def load_state(flat: dict, params, opt_state) -> None:
    """Copy a restored `flat_state` tree into the parameters and the
    optimizer state, in place: into a DTensor its own piece."""
    with torch.no_grad():
        for k, t in _state_items(params, opt_state).items():
            src = torch.as_tensor(flat[k])
            if is_dtensor(t):
                src = piece_of(src, t.placements, t.device_mesh)
            local(t).copy_(src)


def restore_into(ckpt_dir: str, params, opt_state, step=None) -> int:
    """Restore the newest intact checkpoint (or `step`) of `ckpt_dir`
    into the parameters and optimizer state; returns its step."""
    keys = dict(_state_items(params, opt_state), step=None)
    restored, got = ckpt.restore(ckpt_dir, keys, step=step)
    load_state(restored, params, opt_state)
    return got


def to_device(batch: dict, dev: torch.device) -> dict:
    """A host batch on the device: token ids as int64, the mask float32."""
    return {k: torch.as_tensor(v).to(dev, torch.int64 if k != "mask"
                                     else torch.float32)
            for k, v in batch.items()}


def check_mesh(mesh, cfg) -> None:
    """Raise for what the port cannot run on `mesh`."""
    import torch.distributed as dist
    shape = mesh_shape(mesh)
    why = []
    if isinstance(mesh, AbstractMesh):
        n = dist.get_world_size() if dist.is_initialized() else 1
        why.append(f"it needs {mesh.size} ranks, one a card, and {n} "
                   f"running (start them with torchrun)")
    if shape["model"] > 1 and cfg.family != "dense":
        why.append(f"its model axis of {shape['model']} needs the "
                   f"{cfg.family} family's tensor or expert parallelism, "
                   f"which is not ported (the dense family's is)")
    elif shape["model"] > 1 and cfg.optimizer != "adamw":
        why.append(f"its model axis of {shape['model']} needs "
                   f"{cfg.optimizer}'s state split over it, which is not "
                   f"ported (AdamW's is)")
    if cfg.zero1 and shape["data"] * shape.get("pod", 1) > 1:
        why.append("zero1 shards the optimizer state over the data ranks, "
                   "which the port does not run")
    if why:
        raise NotImplementedError(f"the mesh {shape}: " + "; ".join(why)
                                  + " (ROADMAP.md item 13g)")


def train_loop(*, cfg, steps: int, batch: int, seq: int, ckpt_dir: str,
               mesh=None, ckpt_every: int = 10, grad_accum: int = 1,
               lr_kwargs=None, log=print, device: DeviceLike = None,
               seed: int = 0):
    """Train `cfg` from step 0, or from the newest checkpoint in
    `ckpt_dir`, to `steps`, saving every `ckpt_every` steps and at the
    end. With `mesh` (a DeviceMesh of (data, model), or (pod, data,
    model)), data-parallel over its batch axes and, for the dense family,
    tensor-parallel over its model axis, on the mesh's device; `device`
    is then unused. Returns {"losses", "flagged",
    "params", "opt_state", "dts", "metrics"}: "metrics" holds
    each step's loss terms ("xent", and "aux", "mtp" where the model has
    them) as floats, global-batch means under a mesh."""
    import torch.distributed as dist
    group, rank, ranks = None, 0, 1
    ctx = contextlib.nullcontext()
    if mesh is not None:
        check_mesh(mesh, cfg)
        dev = mesh_device(mesh)
        group = batch_group(mesh)
        rank, ranks = dist.get_rank(group), dist.get_world_size(group)
        ctx = mesh_context(mesh)
    else:
        dev = resolve(device)
    model = build_model(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    if batch % ranks:
        raise ValueError(f"global batch {batch} does not split over "
                         f"{ranks} data-parallel ranks")
    opt_init, train_step = make_train_step(model, grad_accum=grad_accum,
                                           lr_kwargs=lr_kwargs, group=group)
    params = model.init_params(
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev,
        trainable=True)
    if mesh is not None:
        place_params(params, cfg, mesh)
    opt_state = opt_init(params)
    start_step = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start_step = restore_into(ckpt_dir, params, opt_state)
        log(f"[train] resumed from step {start_step}")

    def save(step):
        tree = flat_state(params, opt_state, step)
        if mesh is None or dist.get_rank() == 0:
            ckpt.save(ckpt_dir, step, tree)
        del tree
        if mesh is not None:
            dist.barrier()

    watchdog = StragglerWatchdog()
    losses, dts, terms = [], [], []
    with ctx:
        for step in range(start_step, steps):
            bt = to_device(host_batch(dcfg, step, host_id=rank,
                                      n_hosts=ranks), dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, bt,
                                                    step)
            loss = float(metrics["loss"].item())
            dt = time.perf_counter() - t0
            slow = watchdog.observe(step, dt)
            losses.append(loss)
            dts.append(dt)
            terms.append({k: float(metrics[k]) for k in ("xent", "aux",
                                                         "mtp")
                          if k in metrics})
            log(f"[train] step={step} loss={loss:.4f} dt={dt * 1e3:.0f}ms"
                + (" SLOW" if slow else ""))
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save(step + 1)
    if ckpt_dir:
        save(steps)
    return {"losses": losses, "flagged": watchdog.flagged, "params": params,
            "opt_state": opt_state, "dts": dts, "metrics": terms}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: 256 ranks")
    ap.add_argument("--data-parallel", action="store_true",
                    help="data-parallel over this process group's ranks, "
                         "a (ranks, 1) mesh")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(device=args.device)
    elif args.data_parallel:
        mesh = make_host_mesh(args.device, model=1)
    out = train_loop(cfg=cfg, steps=args.steps, batch=args.batch,
                     seq=args.seq, ckpt_dir=args.ckpt_dir, mesh=mesh,
                     grad_accum=args.grad_accum, device=args.device)
    print(json.dumps({"first_loss": out["losses"][0],
                      "last_loss": out["losses"][-1],
                      "n_flagged": len(out["flagged"])}))


if __name__ == "__main__":
    main()
