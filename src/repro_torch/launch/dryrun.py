"""Dry run of the production meshes on the H100: trace one step of every
(arch x input shape x mesh) cell on fake tensors, size its per-device
memory and write its roofline terms to JSON (a port of the reference's
`launch/dryrun.py`).

The reference lowers and compiles each cell with XLA over 512
placeholder devices and reads FLOPs, bytes and collectives from the
HLO. Here the mesh is an `AbstractMesh` ((16, 16), or (2, 16, 16) with
`--multi-pod`), the shardings are the port's rules
(`distributed/sharding.py`), the step runs once on fake tensors under
`launch/op_analysis.py`'s counter, and the roofline is the H100's
(`launch/roofline.py`). Nothing is allocated and no card is needed.
`long_500k` runs only for the SSM and hybrid archs, as the reference's
`shape_applicable` says.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES_BY_NAME, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed.meshctx import mesh_context
from repro_torch.distributed.sharding import (batch_axes, batch_shardings,
                                              cache_shardings, mesh_shape,
                                              opt_shardings, param_shardings)
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (HBM_BYTES, axis_link_bytes_per_s,
                                         roofline_terms)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.model import (build_model, count_params,
                                      input_specs, model_flops)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               config_overrides=None):
    """Trace one dry-run cell on the production mesh. Returns a result
    dict."""
    cfg = get_config(arch)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "why": why}
    res = analyze_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod))
    return dict(res, multi_pod=multi_pod)


def analyze_cell(cfg, shape, mesh):
    """One step of `cfg` at `shape` (a ShapeConfig) on `mesh` (an
    AbstractMesh or a DeviceMesh), traced on fake tensors: its FLOPs,
    bytes and collectives a device, per-device memory, roofline."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = mesh_shape(mesh)
    n_chips = math.prod(sizes.values())
    model = build_model(cfg)
    mode = FakeTensorMode()
    t0 = time.time()
    with mesh_context(mesh):
        params = model.abstract_params(fake_mode=mode)
        named = dict(params.named_parameters())
        p_specs = param_shardings(named, cfg, mesh)
        n_params = count_params(params)
        result = {"arch": cfg.name, "shape": shape.name,
                  "mesh": "x".join(str(s) for s in sizes.values()),
                  "status": "ok", "n_params": n_params}
        state = OA.state_shares(named, p_specs, mesh)
        memory = {"param_bytes": OA.shard_bytes(named, p_specs, mesh)}
        allreduce = 0.0
        with mode:
            inputs = {k: torch.empty(v.shape, dtype=v.dtype)
                      for k, v in input_specs(cfg, shape).items()}
            if shape.kind == "train":
                opt_init, train_step = make_train_step(model)
                opt_state = opt_init(params)
            elif shape.kind == "decode":
                cache = model.init_cache(shape.global_batch, shape.seq_len,
                                         device="cpu")
        if shape.kind != "decode":
            memory["batch_bytes"] = OA.shard_bytes(
                inputs, batch_shardings(inputs, mesh), mesh)
        if shape.kind == "train":
            opt = _flat(opt_state)
            o_specs = _flat(opt_shardings(opt_state, cfg, mesh,
                                          zero1=cfg.zero1))
            state.update(OA.state_shares(opt, o_specs, mesh))
            memory["opt_bytes"] = OA.shard_bytes(opt, o_specs, mesh)
            if math.prod(sizes[a] for a in batch_axes(mesh)) > 1:
                # the float32 all-reduce of every gradient a device
                allreduce = 4.0 * sum(p.numel() * state[OA._key(p)]
                                      for p in named.values())

            def run():
                train_step(params, opt_state, inputs, 0)
        elif shape.kind == "prefill":
            def run():
                make_prefill_step(model, shape.seq_len)(params, inputs)
        else:
            c_specs = cache_shardings(cache, cfg, mesh)
            state.update(OA.state_shares(cache, c_specs, mesh))
            memory["cache_bytes"] = OA.shard_bytes(cache, c_specs, mesh)
            result["cache_bytes"] = sum(t.numel() * t.element_size()
                                        for t in cache.values())

            def run():
                make_decode_step(model)(params, cache, inputs["tokens"],
                                        shape.seq_len - 1)
        counter = OA.OpCounter(state)
        with mode, counter:
            run()
        result["trace_s"] = round(time.time() - t0, 1)
        memory["total_bytes"] = sum(memory.values())
        memory["hbm_bytes"] = HBM_BYTES
        memory["fits"] = memory["total_bytes"] <= HBM_BYTES
        result["memory"] = memory
        result["hlo"] = OA.analyze(counter, n_chips, allreduce)
        result["model_flops"] = model_flops(cfg, shape, n_params)
        result["param_bytes"] = sum(p.numel() * p.element_size()
                                    for p in named.values())
        result["kind"] = shape.kind
        link = min(axis_link_bytes_per_s(sizes, a) for a in batch_axes(mesh))
        result["roofline"] = roofline_terms(result, n_chips, link)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES_BY_NAME]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}__{'pod2' if args.multi_pod else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        try:
            res = lower_cell(arch, shape_name, multi_pod=args.multi_pod)
        except Exception as e:  # one cell's failure is its JSON's status
            res = {"arch": arch, "shape": shape_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "ok":
            rf = res["roofline"]
            extra = (f" flops/dev={res['hlo']['flops_per_device']:.3e}"
                     f" bottleneck={rf['bottleneck']}"
                     f" frac={rf['roofline_fraction']:.3f}"
                     f" fits={res['memory']['fits']}"
                     f" trace={res['trace_s']}s")
        elif status == "error":
            extra = " " + res["error"][:200]
        print(f"[dryrun] {tag}: {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
