"""Adafactor over the reference's stacked leaves, on the CPU against the
reference: three `make_train_step` steps of DeepSeek-V3 (1 dense and 3
MoE layers, MLA, MTP), Qwen2 and Gemma3 (its dense layers stacked on
(n_groups, global_every) axes) smoke configs with
`optimizer="adafactor"`, every parameter and the state (step, r, c, v in
the reference's layout) after each step; the leaves `reference_leaves`
groups; the train loop resumed after step 2 against three uninterrupted
steps, bit for bit.

The reference runs as `_torch_lm_ref` runs it (its zero-initialised
leaves drawn at random, its jitted step under an Auto-axis mesh), from
the same nonzero state carried by the converters: from a zero state
Adafactor's first step moves every unfactored parameter by the sign of
its gradient, and a gradient that is rounding noise (a K bias's:
softmax does not see it) then moves it either way. Tolerance as the
AdamW steps' in `test_torch_moe_lm.py`, float32 1e-4 (the two differ in
the order of sums), but the state's absolute part 1e-10: its leaves are
about 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import TOL, auto_mesh, cast_params, ref_params, to_np
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.distributed.meshctx import mesh_context
from repro.launch import steps as rsteps
from repro.models.model import build_model as ref_build_model
from repro.optim import optimizers as ropt
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models.model import build_model

ARCHS = ("deepseek-v3-671b", "qwen2-1.5b", "gemma3-12b")
STATE_TOL = dict(rtol=1e-4, atol=1e-10)


def _configs(arch):
    kw = dict(dtype="float32", remat=False, optimizer="adafactor")
    return (ref_smoke_config(arch).replace(**kw),
            registry.get_smoke_config(arch).replace(**kw))


def _batch(vocab, b, l, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, l + 1)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[:, : l // 4] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _close_tree(got, want, path="", tol=None):
    assert set(got) == set(want), (path, set(got), set(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, f"{path}/{k}", tol)
        else:
            assert got[k].shape == np.shape(w), (path, k)
            np.testing.assert_allclose(got[k], to_np(w), err_msg=path + k,
                                       **(tol or TOL["float32"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_steps_equal_the_reference(arch):
    """Three steps from a nonzero state (step 3): each step's metrics,
    then every parameter and the state's step, r, c and v, leaf for
    leaf in the reference's tree."""
    rcfg, cfg = _configs(arch)
    _, pnp = ref_params(rcfg, perturb=True, jit=True)
    lr_kwargs = {"warmup": 2, "total": 20, "peak_lr": 1e-2}
    _, rstep = rsteps.make_train_step(ref_build_model(rcfg),
                                      lr_kwargs=lr_kwargs)
    _, pstep = psteps.make_train_step(build_model(cfg), lr_kwargs=lr_kwargs)
    params = cast_params(pnp, jnp.float32)
    rng = np.random.default_rng(3)
    vs = jax.tree.map(
        lambda x: (rng.uniform(size=x.shape) * 1e-4 + 1e-6).astype(
            np.float32), jax.tree.map(to_np, ropt.adafactor_init(params)
                                      ["vs"]))
    rstate = {"step": jnp.int32(3), "vs": jax.tree.map(jnp.asarray, vs)}
    tp = convert.decoder_params_to_torch(pnp, cfg, "cpu").requires_grad_(
        True)
    tstate = convert.adafactor_state_to_torch({"step": 3, "vs": vs}, "cpu")
    jstep = jax.jit(rstep)
    for step in range(3):
        bt = _batch(cfg.vocab, 2, 16, seed=step)
        with mesh_context(auto_mesh()):
            params, rstate, wmet = jstep(
                params, rstate, {k: jnp.asarray(x) for k, x in bt.items()},
                jnp.int32(step))
        tp, tstate, met = pstep(tp, tstate, {k: torch.as_tensor(x)
                                             for k, x in bt.items()}, step)
        assert set(met) == set(wmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(wmet[k]),
                                       err_msg=f"step {step} {k}",
                                       **TOL["float32"])
        _close_tree(convert.lm_params_to_numpy(
            dict(tp.named_parameters()), cfg), jax.tree.map(to_np, params))
        got = convert.adafactor_state_to_numpy(tstate)
        assert int(got["step"]) == int(rstate["step"]) == 4 + step
        _close_tree(got["vs"], jax.tree.map(to_np, rstate["vs"]),
                    tol=STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_leaves_group_the_stacks(arch):
    """Each of the reference's leaves, by path: the port's names that
    make it up, in the stack's order, and the stack's shape; the zero
    state has the reference's tree and shapes."""
    rcfg, cfg = _configs(arch)
    model = build_model(cfg)
    named = dict(model.init_params(torch.Generator().manual_seed(0), "cpu",
                                   trainable=True).named_parameters())
    leaves = convert.reference_leaves(named, cfg)
    assert sorted(k for names, _ in leaves.values() for k in names) == \
        sorted(named)
    dense = {"deepseek-v3-671b": (1,), "qwen2-1.5b": (2,),
             "gemma3-12b": (2, 3)}[arch]
    names, stack = leaves[("dense_layers", "ln1")]
    assert stack == dense
    assert names == tuple(f"layers.{i}.ln1" for i in range(len(names)))
    assert leaves[("embed",)] == (("embed",), ())
    if arch == "deepseek-v3-671b":
        assert leaves[("moe_layers", "ln2")][1] == (3,)
        assert leaves[("mtp", "layer", "ln1")] == (("mtp.layer.ln1",), ())
    want = jax.eval_shape(ropt.adafactor_init, ref_build_model(
        rcfg).abstract_params())["vs"]
    got = psteps.make_train_step(build_model(cfg))[0](
        build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                     "cpu", trainable=True))["vs"]
    assert jax.tree.structure(jax.tree.map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape


def test_train_loop_resumes_bit_for_bit(tmp_path):
    """DeepSeek-V3's smoke config with its Adafactor: 3 steps in one
    run, against 2 steps, a checkpoint and a resumed run to 3: the
    third loss, every parameter and every state leaf bit for bit."""
    cfg = registry.get_smoke_config("deepseek-v3-671b").replace(
        dtype="float32")
    assert cfg.optimizer == "adafactor"
    kw = dict(cfg=cfg, steps=3, batch=2, seq=16, lr_kwargs={"warmup": 1},
              device="cpu", log=lambda *a: None)
    full = ptrain.train_loop(ckpt_dir="", **kw)
    d = str(tmp_path / "ckpt")
    ptrain.train_loop(ckpt_dir=d, **dict(kw, steps=2))
    resumed = ptrain.train_loop(ckpt_dir=d, **kw)
    assert resumed["losses"] == full["losses"][2:]
    for (k, a), b in zip(full["params"].named_parameters(),
                         resumed["params"].parameters()):
        assert torch.equal(a, b), k
    a = convert.adafactor_state_to_numpy(full["opt_state"])
    b = convert.adafactor_state_to_numpy(resumed["opt_state"])
    assert int(a["step"]) == int(b["step"]) == 3
    for x, y in zip(jax.tree.leaves(a["vs"]), jax.tree.leaves(b["vs"])):
        np.testing.assert_array_equal(x, y)
    assert jax.tree.structure(a["vs"]) == jax.tree.structure(b["vs"])
