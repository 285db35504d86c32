"""Tensor parallelism over the model axis for the dense family's training
step, on four gloo ranks, against the reference on four host devices:
Qwen2-1.5B's smoke config at (2, 2) (every attention and MLP weight over
its heads or F, the vocabulary split) and at (1, 4) (two KV heads do not
split four ways: wk and wv split the contracting d_model, bk and bv
replicated), Minitron-8B's (an untied lm_head) and Gemma3-12B's (local
layers' window) at (1, 4), float32.

One `torch.multiprocessing.spawn` of four ranks (`_torch_tp_worker.py`)
runs every rank check, beside one subprocess of the reference
(`_torch_mesh_ref.py`) that jits its `make_train_step` with its
shardings under each case's Auto-axis mesh; both start from the
reference's parameters (its zero-initialised leaves drawn at random) and
a nonzero AdamW state, as `test_torch_mesh_train.py` does, and take two
steps. Tolerances: rtol 1e-5, atol 1e-6 (float32; the ranks sum partial
products in another order than XLA's); checkpoints bit for bit.
"""
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_tp_worker as worker
from _torch_lm_ref import ref_params
from _torch_mesh_worker import FIRST_STEP, LR, STEPS
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import resume_elastic
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train_loop
from repro_torch.models.model import build_model

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_TESTS), "src")
TOL = dict(rtol=1e-5, atol=1e-6)
# name: (arch, (data, model), global batch, sequence length)
CASES = {"qwen2_2x2": ("qwen2-1.5b", (2, 2), 8, 16),
         "qwen2_1x4": ("qwen2-1.5b", (1, 4), 8, 16),
         "minitron_1x4": ("minitron-8b", (1, 4), 8, 16),
         "gemma3_1x4": ("gemma3-12b", (1, 4), 8, 32)}
# the collectives a step may run: all-reduces, and c10d's all-gather
# (gloo crashes in the functional all-gather on CUDA tensors;
# `distributed/meshctx.py`)
ALLOWED = {"c10d_functional.all_reduce", "c10d.allreduce_",
           "c10d._allgather_base_"}


def _cfg(arch):
    return registry.get_smoke_config(arch).replace(dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, run once; the
    checkpoint written without a mesh first."""
    work = str(tmp_path_factory.mktemp("tp"))
    ref_cases, port_cases = {}, {}
    for name, (arch, mesh, b, l) in CASES.items():
        rcfg = ref_smoke_config(arch).replace(dtype="float32")
        _, pnp = ref_params(rcfg, perturb=True)
        rng = np.random.default_rng(5)
        state = {"step": np.int32(FIRST_STEP),
                 "m": jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
                     np.float32) * 1e-2, pnp),
                 "v": jax.tree.map(lambda x: rng.uniform(
                     size=x.shape).astype(np.float32) * 1e-4, pnp)}
        case = {"params": pnp, "opt": state, "batch": b, "seq": l,
                "mesh": mesh}
        ref_cases[name] = dict(case, rcfg=rcfg)
        port_cases[name] = dict(case, cfg=_cfg(arch))
    with open(os.path.join(work, "ref_inputs.pkl"), "wb") as f:
        pickle.dump(ref_cases, f)
    small = _cfg("qwen2-1.5b")
    torch.save({"cases": port_cases, "ckpt_cfg": small},
               os.path.join(work, "inputs.pt"))
    plain = train_loop(cfg=small, steps=STEPS, batch=8, seq=16,
                       ckpt_dir=os.path.join(work, "ckpt_plain"),
                       lr_kwargs=LR, log=lambda *a: None, device="cpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([_SRC, _TESTS]))
    ref = subprocess.Popen([sys.executable,
                            os.path.join(_TESTS, "_torch_mesh_ref.py"), work],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(worker.run, args=(os.path.join(work, "init"), work),
                 nprocs=worker.WORLD, join=True)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(worker.WORLD)]
    with open(os.path.join(work, "ref_out.pkl"), "rb") as f:
        ref_out = pickle.load(f)
    return types.SimpleNamespace(
        ranks=ranks, ref=ref_out, work=work, small=small, cases=port_cases,
        plain=(convert.lm_params_to_numpy(
            dict(plain["params"].named_parameters()), small),
            convert.adamw_state_to_numpy(plain["opt_state"], small)))


def _close_tree(got, want, exact=False):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, exact)
        elif exact:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_train_equals_the_reference(runs, name):
    """Two steps: every metric and every gathered parameter against the
    reference's jitted step on the same mesh; the four ranks' gathered
    parameters the same bits."""
    want = runs.ref[name]
    for r, out in enumerate(runs.ranks):
        got = out[f"train/{name}"]
        for s in range(STEPS):
            assert set(got["metrics"][s]) == set(want["metrics"][s])
            for k, v in want["metrics"][s].items():
                np.testing.assert_allclose(got["metrics"][s][k], v,
                                           err_msg=f"rank {r} step {s} {k}",
                                           **TOL)
        _close_tree(got["params"], want["params"])
        _close_tree(got["params"], runs.ranks[0][f"train/{name}"]["params"],
                    exact=True)


def _local_shape(shape, spec, m):
    return tuple(n // m if e == "model" else n for n, e in zip(shape, spec))


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_pieces(runs, name):
    """Every local parameter and AdamW moment has the local shape of the
    reference's rule on the case's mesh (`param_shardings`,
    `opt_shardings`), and something is split."""
    case = runs.cases[name]
    cfg = case["cfg"]
    mesh = sharding.AbstractMesh(("data", "model"), case["mesh"])
    m = case["mesh"][1]
    params = convert.decoder_params_to_torch(case["params"], cfg, "cpu")
    shapes = {k: tuple(p.shape) for k, p in params.named_parameters()}
    specs = sharding.param_shardings(params, cfg, mesh)
    opt_specs = sharding.opt_shardings(
        convert.adamw_state_to_torch(case["opt"], cfg, "cpu"), cfg, mesh)
    want = {k: _local_shape(shapes[k], specs[k].spec, m) for k in shapes}
    assert want != shapes
    for out in runs.ranks:
        got_p, got_o = out[f"train/{name}"]["shapes"]
        assert got_p == want
        for part in ("m", "v"):
            assert got_o[part] == {
                k: _local_shape(shapes[k], opt_specs[part][k].spec, m)
                for k in shapes} == want


@pytest.mark.parametrize("name", list(CASES))
def test_flash_runs_on_each_ranks_heads(runs, name):
    """Every flash call of a rank saw its batch slice times H / m heads:
    each layer's forward, and again in the backward's recompute."""
    case = runs.cases[name]
    cfg = case["cfg"]
    (d, m), b = case["mesh"], case["batch"]
    for out in runs.ranks:
        seen = out[f"train/{name}"]["flash_bh"]
        assert seen == [b // d * cfg.n_heads // m] * (
            2 * cfg.n_layers * STEPS)


@pytest.mark.parametrize("name", list(CASES))
def test_step_runs_only_all_reduces_and_c10d_all_gathers(runs, name):
    for out in runs.ranks:
        comm = out[f"train/{name}"]["comm"]
        assert comm and set(comm) <= ALLOWED, comm


def test_grad_accum_2_equals_grad_accum_1_at_2x2(runs):
    for out in runs.ranks:
        got, want = out["accum2"], out["train/qwen2_2x2"]
        for s in range(STEPS):
            np.testing.assert_allclose(got["metrics"][s]["loss"],
                                       want["metrics"][s]["loss"], **TOL)
            np.testing.assert_allclose(got["metrics"][s]["gnorm"],
                                       want["metrics"][s]["gnorm"], **TOL)
        _close_tree(got["params"], want["params"])


@pytest.mark.parametrize("name", worker.OUTSIDE + ("adafactor", "zero1",
                                                   "resume zero1"))
def test_what_is_not_ported_raises_naming_13g(runs, name):
    """Every family outside the slice and Adafactor at a model axis of
    4, and ZeRO-1 over two data ranks, raise before any step: nothing
    runs replicated in their place."""
    for out in runs.ranks:
        assert "13g" in out["raises"][name], out["raises"][name]


def _same_state(got, want):
    step, params, opt = got
    assert step == STEPS
    _close_tree(params, want[0], exact=True)
    for part in ("m", "v"):
        _close_tree(opt[part], want[1][part], exact=True)
    assert int(opt["step"]) == int(want[1]["step"]) == STEPS


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), None])
def test_checkpoint_from_1x4_resumes_bit_for_bit(runs, shape):
    """`train_loop`'s checkpoint at (1, 4) (gathered whole, rank 0
    writing) resumes through `resume_elastic` at (2, 2), at (4, 1) and in
    one process: parameters and AdamW state bit for bit."""
    final = runs.ranks[0]["tp/final"]
    for out in runs.ranks:
        _close_tree(out["tp/final"][0], final[0], exact=True)
    if shape is not None:
        for out in runs.ranks:
            _same_state(out[f"resumed/ckpt_tp/{shape}"], final)
        return
    model = build_model(runs.small)
    params, opt, step = resume_elastic(
        os.path.join(runs.work, "ckpt_tp"), model,
        make_train_step(model)[0], None, device="cpu")
    _same_state((step, convert.lm_params_to_numpy(
        dict(params.named_parameters()), runs.small),
        convert.adamw_state_to_numpy(opt, runs.small)), final)


def test_checkpoint_without_a_mesh_resumes_at_1x4(runs):
    for out in runs.ranks:
        _same_state(out["resumed/ckpt_plain/(1, 4)"], runs.plain)


def test_tensor_parallel_train_loop_equals_one_process(runs):
    """`train_loop` at (1, 4) from a zero AdamW state against the same
    loop without a mesh: the losses; the parameters but the key bias,
    whose gradient is rounding noise that AdamW's first step turns into
    a step of about lr (`test_torch_mesh_train.py`), within TOL, the key
    bias within that step."""
    for out in runs.ranks:
        got = out["tp/final"][0]
        want = dict(runs.plain[0], dense_layers=dict(
            runs.plain[0]["dense_layers"],
            attn=dict(runs.plain[0]["dense_layers"]["attn"])))
        bk = want["dense_layers"]["attn"].pop("bk")
        np.testing.assert_allclose(got["dense_layers"]["attn"]["bk"], bk,
                                   rtol=0, atol=2 * LR["peak_lr"] * STEPS)
        _close_tree(got, want)


def test_a_full_size_rank_holds_half_of_qwen2_1_5b():
    """At Qwen2-1.5B's full size and a model axis of 2, every tensor but
    the 57 norms (87,552 values) splits in two: a rank holds
    (1,543,910,912 - 87,552) / 2 + 87,552 = 771,999,232 values."""
    cfg = registry.get_config("qwen2-1.5b")
    params = build_model(cfg).abstract_params()
    specs = sharding.param_shardings(
        params, cfg, sharding.AbstractMesh(("data", "model"), (1, 2)))
    whole = {k: p.numel() for k, p in params.named_parameters()}
    assert sum(whole.values()) == 1_543_910_912
    assert sum(n for k, n in whole.items()
               if "model" not in specs[k].spec) == 87_552
    assert sum(n // 2 if "model" in specs[k].spec else n
               for k, n in whole.items()) == 771_999_232


def test_remat_recomputes_under_the_forwards_mesh_in_another_thread():
    """Autograd runs a CUDA tensor's backward in a thread of its own, where
    no mesh context is installed: a layer's recompute there re-installs
    the one its forward ran under, so `shard_act` places alike."""
    import threading

    from repro_torch.distributed.meshctx import current_mesh, mesh_context
    from repro_torch.models.transformer import remat
    mesh = sharding.AbstractMesh(("data", "model"), (1, 2))
    seen = []

    def layer(x):
        seen.append(current_mesh())
        return x * x
    x = torch.ones(3, requires_grad=True)
    with mesh_context(mesh):
        y = remat(_cfg("qwen2-1.5b"), layer, x)
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and seen == [mesh, mesh]
    assert torch.equal(x.grad, 2 * x.detach())
