"""One gloo rank of `test_torch_mesh_train.py`'s four (no JAX: started by
`torch.multiprocessing.spawn`). Each check writes what it found into the
rank's result file, `out/rank<r>.pt`, which the test reads:

- `placements` / `distribute` at a (2, 2) mesh, `shard_act`;
- `compressed_allreduce` over the four ranks' own gradients, two
  error-feedback steps;
- data-parallel `make_train_step` at (4, 1) from the reference's
  parameters (`inputs.pt`), dense and the hierarchical MoE, and the flat
  dispatch's refusal;
- `train_loop` at (4, 1) with checkpoints, resumed by `resume_elastic`
  at (2, 1) on ranks 0 and 1.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
LR = {"warmup": 0, "total": 10, "peak_lr": 1e-3}
STEPS = 2
# the data-parallel cases start from an AdamW state at this step
FIRST_STEP = 3


def _dense_2x2(rank, out):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import meshctx, sharding
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    di, mi = mesh.get_coordinate()
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    specs = {"rows_model": ("model", None), "cols_data": (None, "data"),
             "rows_both": (("data", "model"), None),
             "param": sharding.ParamSpec((None,), ("data", "model")),
             "repl": (None, None)}
    want = {"rows_model": full[mi * 4:(mi + 1) * 4],
            "cols_data": full[:, di * 3:(di + 1) * 3],
            "rows_both": full[(di * 2 + mi) * 2:(di * 2 + mi + 1) * 2],
            "param": full[di * 4:(di + 1) * 4, mi * 3:(mi + 1) * 3],
            "repl": full}
    placed = sharding.distribute({k: full for k in specs}, specs, mesh)
    out["placements"] = {
        k: (isinstance(placed[k], DTensor) == (k != "repl"),
            torch.equal(placed[k].to_local() if k != "repl" else placed[k],
                        want[k]))
        for k in specs}
    out["placements_of"] = sharding.placements(("model", ("data",)), mesh)

    # shard_act: a replicated DTensor redistributed by logical axes; an
    # indivisible batch dim (3 over 2) is dropped
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    acts = {}
    with meshctx.mesh_context(mesh):
        for name, t in (("divisible", x), ("indivisible", x[:3])):
            d = DTensor.from_local(t, mesh, [Replicate(), Replicate()])
            y = meshctx.shard_act(d, "batch", None, "model")
            b = t.shape[0]
            rows = (slice(di * b // 2, (di + 1) * b // 2) if b % 2 == 0
                    else slice(None))
            acts[name] = (tuple(y.placements),
                          torch.equal(y.to_local(), t[rows][..., mi * 4:
                                                            (mi + 1) * 4]))
    assert meshctx.shard_act(x, "batch") is x
    out["shard_act"] = acts
    out["shard_act_want"] = {"divisible": (Shard(0), Shard(2)),
                             "indivisible": (Replicate(), Shard(2))}


def _compression(rank, out):
    from repro_torch.distributed import compression
    rng = np.random.default_rng(100 + rank)
    steps = [{"w": torch.as_tensor(rng.normal(size=(37, 5)).astype(
                  np.float32) * (rank + 1)),
              "b": torch.as_tensor(rng.normal(size=(11,)).astype(
                  np.float32) * 1e-3)} for _ in range(2)]
    res = compression.init_residuals(steps[0])
    got = []
    for g in steps:
        mean, res = compression.compressed_allreduce(g, res, dist.group.WORLD)
        got.append((mean, res))
    out["compression"] = {"grads": steps, "out": got}


def _dp_train(rank, out, inputs):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.distributed import meshctx
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import build_model
    mesh = init_device_mesh("cpu", (WORLD, 1),
                            mesh_dim_names=("data", "model"))
    group = meshctx.batch_group(mesh)
    for name, case in inputs["cases"].items():
        cfg = case["cfg"]
        params = convert.decoder_params_to_torch(case["params"], cfg, "cpu")
        params.requires_grad_(True)
        _, step_fn = psteps.make_train_step(build_model(cfg), lr_kwargs=LR,
                                            group=group)
        opt = convert.adamw_state_to_torch(case["opt"], cfg, "cpu")
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=case["seq"],
                          global_batch=case["batch"])
        mets = []
        with meshctx.mesh_context(mesh):
            for s in range(FIRST_STEP + 1, FIRST_STEP + 1 + STEPS):
                bt = to_device(host_batch(dcfg, s, host_id=rank,
                                          n_hosts=WORLD), torch.device("cpu"))
                params, opt, m = step_fn(params, opt, bt, s)
                mets.append({k: float(v) for k, v in m.items()})
        out[f"train/{name}"] = {
            "metrics": mets,
            "params": convert.lm_params_to_numpy(
                dict(params.named_parameters()), cfg)}

    # the flat dispatch cannot be split by rank
    cfg = inputs["flat_cfg"]
    model = build_model(cfg)
    p = model.init_params(device="cpu")
    bt = to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=8,
                                         global_batch=8), 0, rank, WORLD),
                   torch.device("cpu"))
    with meshctx.mesh_context(mesh):
        try:
            model.loss_fn(p, bt)
            out["flat_raises"] = ""
        except NotImplementedError as e:
            out["flat_raises"] = str(e)


def _elastic(rank, out, inputs, ckpt_dir):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch import convert
    from repro_torch.distributed.elastic import resume_elastic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import build_model
    cfg = inputs["elastic_cfg"]
    mesh = init_device_mesh("cpu", (WORLD, 1),
                            mesh_dim_names=("data", "model"))
    run = train_loop(cfg=cfg, steps=STEPS, batch=8, seq=16,
                     ckpt_dir=ckpt_dir, mesh=mesh, ckpt_every=1,
                     lr_kwargs=LR, log=lambda *a: None)
    out["elastic/losses"] = run["losses"]
    out["elastic/final"] = convert.lm_params_to_numpy(
        dict(run["params"].named_parameters()), cfg)
    out["elastic/opt"] = convert.adamw_state_to_numpy(run["opt_state"], cfg)
    # every rank takes part in making the (2, 1) mesh's groups
    small = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                       mesh_dim_names=("data", "model"))
    if rank < 2:
        model = build_model(cfg)
        opt_init, _ = make_train_step(model, lr_kwargs=LR)
        params, opt, step = resume_elastic(ckpt_dir, model, opt_init, small)
        out["elastic/resumed"] = (
            step, convert.lm_params_to_numpy(
                dict(params.named_parameters()), cfg),
            convert.adamw_state_to_numpy(opt, cfg))
    dist.barrier()


def run(rank: int, init_file: str, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"),
                            weights_only=False)
        _dense_2x2(rank, out)
        _compression(rank, out)
        _dp_train(rank, out, inputs)
        _elastic(rank, out, inputs, os.path.join(work, "ckpt"))
    finally:
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
