"""The reference's side of `test_torch_mesh_train.py`, run as a script
with four host devices (`--xla_force_host_platform_device_count=4`, set
by the test before JAX starts): two `make_train_step` steps of each case
in `ref_inputs.pkl`, from its nonzero AdamW state, jitted with the reference's shardings under an
Auto-axis (data, model) mesh, the case's "mesh" or (4, 1), from the
parameters the port's ranks start from. Writes each step's metrics and
the final parameters. Also the reference's side of
`test_torch_tensor_parallel.py`.

Usage: python tests/_torch_mesh_ref.py WORK_DIR
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from _torch_lm_ref import cast_params, to_np
from repro.data.pipeline import DataConfig, host_batch
from repro.distributed.meshctx import mesh_context
from repro.distributed.sharding import (batch_shardings, opt_shardings,
                                        param_shardings)
from repro.launch import steps as rsteps
from repro.models.model import build_model

from _torch_mesh_worker import FIRST_STEP, LR, STEPS, WORLD


def main(work):
    assert len(jax.devices()) == WORLD, jax.devices()
    with open(f"{work}/ref_inputs.pkl", "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        mesh = jax.make_mesh(case.get("mesh", (WORLD, 1)), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        rcfg = case["rcfg"]
        rm = build_model(rcfg)
        opt_init, step = rsteps.make_train_step(rm, lr_kwargs=LR)
        dcfg = DataConfig(vocab=rcfg.vocab, seq_len=case["seq"],
                          global_batch=case["batch"])
        with mesh_context(mesh):
            params = cast_params(case["params"], rcfg.dtype)
            p_sh = param_shardings(params, mesh)
            params = jax.device_put(params, p_sh)
            o_sh = opt_shardings(jax.eval_shape(opt_init, params), mesh)
            opt = jax.device_put(jax.tree.map(jnp.asarray, case["opt"]),
                                 o_sh)
            sample = host_batch(dcfg, 0)
            b_sh = batch_shardings(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), sample),
                mesh)
            jstep = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh, None),
                            out_shardings=(p_sh, o_sh, None))
            mets = []
            for s in range(FIRST_STEP + 1, FIRST_STEP + 1 + STEPS):
                bt = jax.tree.map(lambda x, sh: jax.device_put(x, sh),
                                  host_batch(dcfg, s), b_sh)
                params, opt, m = jstep(params, opt, bt, jnp.int32(s))
                mets.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": mets, "params": jax.tree.map(to_np, params)}
    with open(f"{work}/ref_out.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
