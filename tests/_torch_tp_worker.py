"""One gloo rank of `test_torch_tensor_parallel.py`'s four (no JAX: started
by `torch.multiprocessing.spawn`). Each check writes what it found into
the rank's result file, `out/rank<r>.pt`, which the test reads:

- tensor-parallel `make_train_step` of each case in `inputs.pt` (the
  reference's parameters and AdamW state, placed by
  `sharding.place_params` / `place_state`) at its (data, model) mesh:
  metrics, the gathered parameters, every local parameter's and moment's
  shape, the heads each flash call saw, the step's collectives; and
  Qwen2's at (2, 2) again with grad_accum 2;
- `train_loop` at (1, 4) with checkpoints, resumed by `resume_elastic` at
  (2, 2) and (4, 1), and the test process's checkpoint (written without a
  mesh) resumed at (1, 4);
- the NotImplementedError of every family outside the slice at a model
  axis above 1, of Adafactor there and of ZeRO-1 over two data ranks.
"""
import os

import torch
import torch.distributed as dist

from _torch_mesh_worker import FIRST_STEP, LR, STEPS

WORLD = 4
# the families outside the slice, one smoke config each
OUTSIDE = ("qwen2-moe-a2.7b", "deepseek-v3-671b", "llava-next-34b",
           "zamba2-7b", "mamba2-1.3b", "whisper-tiny")


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _gathered(params, opt, cfg):
    """The parameters and AdamW state whole, in the reference's layout."""
    from repro_torch import convert
    from repro_torch.distributed.meshctx import full
    named = {k: full(p) for k, p in params.named_parameters()}
    state = {"step": opt["step"],
             "m": {k: full(t) for k, t in opt["m"].items()},
             "v": {k: full(t) for k, t in opt["v"].items()}}
    return (convert.lm_params_to_numpy(named, cfg),
            convert.adamw_state_to_numpy(state, cfg))


def _local_shapes(params, opt):
    from repro_torch.distributed.sharding import local
    return ({k: tuple(local(p).shape) for k, p in params.named_parameters()},
            {part: {k: tuple(local(t).shape) for k, t in opt[part].items()}
             for part in ("m", "v")})


def _steps(case, grad_accum=1):
    """STEPS steps of the case from its inputs on its mesh: (metrics a
    step, params, opt, the batch-times-heads of each flash call, the
    collectives' counts)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import convert
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.distributed import meshctx
    from repro_torch.distributed.sharding import place_params, place_state
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import build_model
    cfg = case["cfg"]
    mesh = _mesh(case["mesh"])
    group = meshctx.batch_group(mesh)
    params = convert.decoder_params_to_torch(case["params"], cfg, "cpu")
    params.requires_grad_(True)
    place_params(params, cfg, mesh)
    opt = place_state(convert.adamw_state_to_torch(case["opt"], cfg, "cpu"),
                      cfg, mesh)
    _, step_fn = make_train_step(build_model(cfg), grad_accum=grad_accum,
                                 lr_kwargs=LR, group=group)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=case["seq"],
                      global_batch=case["batch"])
    seen, flash = [], ops.flash_attention

    def spy(q, *a, **kw):
        seen.append(q.shape[0])
        return flash(q, *a, **kw)
    mets = []
    ops.flash_attention = spy
    try:
        with meshctx.mesh_context(mesh), CommDebugMode() as comm:
            for s in range(FIRST_STEP + 1, FIRST_STEP + 1 + STEPS):
                bt = to_device(host_batch(dcfg, s, host_id=dist.get_rank(
                    group), n_hosts=case["mesh"][0]), torch.device("cpu"))
                params, opt, m = step_fn(params, opt, bt, s)
                mets.append({k: float(v) for k, v in m.items()})
    finally:
        ops.flash_attention = flash
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return mets, params, opt, seen, counts


def _tp_train(out, inputs):
    for name, case in inputs["cases"].items():
        mets, params, opt, seen, counts = _steps(case)
        gp, gs = _gathered(params, opt, case["cfg"])
        out[f"train/{name}"] = {
            "metrics": mets, "params": gp, "opt": gs,
            "shapes": _local_shapes(params, opt), "flash_bh": seen,
            "comm": counts}
    mets, params, opt, _, _ = _steps(inputs["cases"]["qwen2_2x2"],
                                     grad_accum=2)
    out["accum2"] = {"metrics": mets,
                     "params": _gathered(params, opt,
                                         inputs["cases"]["qwen2_2x2"]["cfg"])
                     [0]}


def _checkpoints(out, inputs, work):
    from repro_torch.distributed.elastic import resume_elastic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import build_model
    cfg = inputs["ckpt_cfg"]
    d = os.path.join(work, "ckpt_tp")
    run = train_loop(cfg=cfg, steps=STEPS, batch=8, seq=16, ckpt_dir=d,
                     mesh=_mesh((1, 4)), ckpt_every=1, lr_kwargs=LR,
                     log=lambda *a: None)
    out["tp/losses"] = run["losses"]
    out["tp/final"] = _gathered(run["params"], run["opt_state"], cfg)
    model = build_model(cfg)
    opt_init, _ = make_train_step(model, lr_kwargs=LR)
    for src, shape in (("ckpt_tp", (2, 2)), ("ckpt_tp", (4, 1)),
                       ("ckpt_plain", (1, 4))):
        params, opt, step = resume_elastic(os.path.join(work, src), model,
                                           opt_init, _mesh(shape))
        out[f"resumed/{src}/{shape}"] = (step, *_gathered(params, opt, cfg))


def _raises(out, inputs):
    from repro_torch.configs import registry
    from repro_torch.distributed.elastic import resume_elastic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import build_model
    dense = inputs["ckpt_cfg"]
    cases = {arch: (registry.get_smoke_config(arch), (1, 4))
             for arch in OUTSIDE}
    cases["adafactor"] = (dense.replace(optimizer="adafactor"), (1, 4))
    cases["zero1"] = (dense.replace(zero1=True), (2, 2))
    msgs = {}
    for name, (cfg, shape) in cases.items():
        try:
            train_loop(cfg=cfg, steps=1, batch=8, seq=8, ckpt_dir="",
                       mesh=_mesh(shape), log=lambda *a: None)
            msgs[name] = ""
        except NotImplementedError as e:
            msgs[name] = str(e)
    model = build_model(dense)
    try:
        resume_elastic("", model, make_train_step(model)[0], _mesh((2, 2)),
                       zero1=True)
        msgs["resume zero1"] = ""
    except NotImplementedError as e:
        msgs["resume zero1"] = str(e)
    out["raises"] = msgs


def run(rank: int, init_file: str, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"),
                            weights_only=False)
        _tp_train(out, inputs)
        _checkpoints(out, inputs, work)
        _raises(out, inputs)
    finally:
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
