"""The port's mesh on four gloo ranks, against the reference on four host
devices: DTensor placements and `shard_act` at (2, 2), the int8
error-feedback all-reduce, data-parallel training at (4, 1) (Qwen2-1.5B's
smoke config, and Qwen2-MoE's with 6 experts padded to 8 and the
hierarchical dispatch, both in float32), and elastic resume across
meshes.

One `torch.multiprocessing.spawn` of four ranks (`_torch_mesh_worker.py`)
runs every rank check, beside one subprocess of the reference
(`_torch_mesh_ref.py`) that jits its `make_train_step` with its
shardings under an Auto-axis (4, 1) mesh of four host devices; both
start from the same parameters (the reference's, its zero-initialised
leaves drawn at random, carried across by `convert`, and a nonzero AdamW
state: from zeros, AdamW's first step turns a gradient that is only
rounding noise, as the key bias's is, into a full step). Tolerances:
training rtol 1e-5 with atol 1e-6 (float32; each side sums the four
ranks' gradients in its own order, and XLA fuses the optimizer's chains);
the all-reduce's mean at four ranks rtol 1e-6 of the reference's formula
evaluated in numpy (the float32 sum of four scales in gloo's order), its
integer sums and residuals exactly; at one rank, and every resume, bit
for bit.
"""
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AxisType

import _torch_mesh_worker as worker
from _torch_lm_ref import ref_params
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.distributed import compression as rcomp
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import compression as pcomp
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import resume_elastic
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train_loop
from repro_torch.models.model import build_model

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_TESTS), "src")
TOL = dict(rtol=1e-5, atol=1e-6)
PADDED = dict(n_experts=6, top_k=2, n_shared=1, d_ff_expert=64,
              n_experts_padded=8, dispatch="hierarchical")
# name: (arch, MoE overrides, global batch, sequence length)
CASES = {"dense": ("qwen2-1.5b", None, 8, 16),
         "moe": ("qwen2-moe-a2.7b", PADDED, 8, 16)}


def _configs(arch, moe):
    rcfg = ref_smoke_config(arch).replace(dtype="float32")
    cfg = registry.get_smoke_config(arch).replace(dtype="float32")
    if moe:
        rcfg = rcfg.replace(moe=RefMoEConfig(**moe))
        cfg = cfg.replace(moe=MoEConfig(**moe))
    return rcfg, cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, run once."""
    work = str(tmp_path_factory.mktemp("mesh"))
    ref_cases, port_cases = {}, {}
    for name, (arch, moe, b, l) in CASES.items():
        rcfg, cfg = _configs(arch, moe)
        _, pnp = ref_params(rcfg, perturb=True)
        rng = np.random.default_rng(5)
        state = {"step": np.int32(worker.FIRST_STEP),
                 "m": jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
                     np.float32) * 1e-2, pnp),
                 "v": jax.tree.map(lambda x: rng.uniform(
                     size=x.shape).astype(np.float32) * 1e-4, pnp)}
        case = {"params": pnp, "opt": state, "batch": b, "seq": l}
        ref_cases[name] = dict(case, rcfg=rcfg)
        port_cases[name] = dict(case, cfg=cfg)
    with open(os.path.join(work, "ref_inputs.pkl"), "wb") as f:
        pickle.dump(ref_cases, f)
    small = registry.get_smoke_config("qwen2-1.5b").replace(dtype="float32")
    torch.save({"cases": port_cases,
                "flat_cfg": registry.get_smoke_config(
                    "qwen2-moe-a2.7b").replace(dtype="float32"),
                "elastic_cfg": small}, os.path.join(work, "inputs.pt"))
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
    return types.SimpleNamespace(ranks=ranks, ref=ref_out, work=work,
                                 elastic_cfg=small, cases=port_cases)


def _close_tree(got, want, exact=False):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, exact)
        elif exact:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, err_msg=k, **TOL)


def test_placements_and_distribute_at_2x2(runs):
    """Each rank's local shard is its slice of the full tensor; an
    all-replicated spec leaves the tensor plain."""
    from torch.distributed.tensor import Shard
    for r, out in enumerate(runs.ranks):
        for k, (is_dtensor, equal) in out["placements"].items():
            assert is_dtensor and equal, (r, k)
        assert out["placements_of"] == (Shard(1), Shard(0))


def test_shard_act_redistributes_and_drops_an_indivisible_axis(runs):
    for out in runs.ranks:
        for k, (placed, equal) in out["shard_act"].items():
            assert placed == out["shard_act_want"][k] and equal, k


def _np_quantize(x):
    amax = np.max(np.abs(x))
    scale = np.float32(amax / np.float32(127.0)) if amax > 0 else \
        np.float32(1.0)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def test_compressed_allreduce_at_four_ranks_equals_the_formula(runs):
    """sum(q) x (sum(scale) / n) / n with each rank's error-feedback
    residual, two steps, evaluated in numpy; every rank gets the same
    mean."""
    n = worker.WORLD
    comp = [out["compression"] for out in runs.ranks]
    res = [{k: np.zeros(v.shape, np.float32)
            for k, v in comp[0]["grads"][0].items()} for _ in range(n)]
    for step in range(2):
        for k in res[0]:
            qs, scales = [], []
            for r in range(n):
                g = comp[r]["grads"][step][k].numpy() + res[r][k]
                q, s = _np_quantize(g)
                qs.append(q.astype(np.int32))
                scales.append(s)
                res[r][k] = g - q.astype(np.float32) * s
                np.testing.assert_array_equal(
                    comp[r]["out"][step][1][k].numpy(), res[r][k])
            want = (np.sum(qs, axis=0).astype(np.float32)
                    * (np.float32(np.sum(np.float32(scales))) / n) / n)
            for r in range(n):
                got = comp[r]["out"][step][0][k].numpy()
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
                np.testing.assert_array_equal(
                    got, comp[0]["out"][step][0][k].numpy())


def test_compressed_allreduce_at_one_rank_is_the_references_bit_for_bit():
    """No group against the reference on a (1,) mesh, over two
    error-feedback steps (a zero gradient included)."""
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    rng = np.random.default_rng(0)
    shapes = {"a": (33, 17), "b": (129,), "z": (4, 4)}
    steps = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-3, 2)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(2)]
    for st in steps:
        st["z"][:] = 0
    rres = rcomp.init_residuals({k: jnp.asarray(v)
                                 for k, v in steps[0].items()})
    pres = pcomp.init_residuals({k: torch.as_tensor(v)
                                 for k, v in steps[0].items()})
    for st in steps:
        rmean, rres = rcomp.compressed_allreduce(
            {k: jnp.asarray(v) for k, v in st.items()}, rres, mesh)
        pmean, pres = pcomp.compressed_allreduce(
            {k: torch.as_tensor(v) for k, v in st.items()}, pres)
        for k in shapes:
            assert np.array_equal(np.asarray(rmean[k]).view(np.int32),
                                  pmean[k].numpy().view(np.int32)), k
            assert np.array_equal(np.asarray(rres[k]).view(np.int32),
                                  pres[k].numpy().view(np.int32)), k
    q, s = pcomp.quantize_int8(torch.tensor([0.5, -1.5, 2.5, 127.0]))
    rq, rs = rcomp.quantize_int8(jnp.asarray([0.5, -1.5, 2.5, 127.0]))
    assert q.tolist() == np.asarray(rq).tolist() and float(s) == float(rs)


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_train_equals_the_reference(runs, name):
    """Two steps at (4, 1): every metric (the MoE's global `aux`
    included) and every parameter against the reference's jitted step;
    the four ranks' parameters the same bits."""
    want = runs.ref[name]
    for r, out in enumerate(runs.ranks):
        got = out[f"train/{name}"]
        for s in range(worker.STEPS):
            assert set(got["metrics"][s]) == set(want["metrics"][s])
            for k, v in want["metrics"][s].items():
                np.testing.assert_allclose(got["metrics"][s][k], v,
                                           err_msg=f"rank {r} step {s} {k}",
                                           **TOL)
        _close_tree(got["params"], want["params"])
        _close_tree(got["params"], runs.ranks[0][f"train/{name}"]["params"],
                    exact=True)
    if name == "moe":
        assert all("aux" in m for m in want["metrics"])


def test_hierarchical_moe_in_one_process_takes_the_meshs_shards(runs):
    """One process under an abstract (4, 1) mesh splits the global batch
    into the reference's 4 dispatch shards (capacity a shard; the
    reference's 4-device step's first loss terms), where without a mesh
    it is one flat dispatch at the capacity of every token."""
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.distributed.meshctx import mesh_context
    from repro_torch.launch.train import to_device
    from repro_torch.models import moe
    case = runs.cases["moe"]
    cfg = case["cfg"]
    params = convert.decoder_params_to_torch(case["params"], cfg, "cpu")
    bt = to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=case["seq"],
                                         global_batch=case["batch"]),
                              worker.FIRST_STEP + 1), torch.device("cpu"))
    mesh = sharding.AbstractMesh(("data", "model"), (worker.WORLD, 1))
    t = case["batch"] * case["seq"]
    with torch.no_grad(), mesh_context(mesh):
        assert moe.shards(case["batch"], t, cfg.moe) == worker.WORLD
        _, met = build_model(cfg).loss_fn(params, bt)
    want = runs.ref["moe"]["metrics"][0]
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(met[k]), want[k], err_msg=k, **TOL)
    assert moe.shards(case["batch"], t, cfg.moe) == 1


def test_flat_moe_dispatch_raises_under_data_parallelism(runs):
    for out in runs.ranks:
        assert "hierarchical" in out["flat_raises"], out["flat_raises"]


def test_train_loop_at_four_ranks_equals_one_process(runs):
    """`train_loop` at (4, 1) against the same loop in one process: each
    rank's slice of the global batch, gradients averaged. The loop starts
    from a zero AdamW state, whose first step moves every parameter by
    about lr x sign(gradient); the key bias's gradient is zero but for
    rounding (a bias on every key shifts a query's scores alike), so its
    value is held within that step's size, the rest to TOL."""
    one = train_loop(cfg=runs.elastic_cfg, steps=worker.STEPS, batch=8,
                     seq=16, ckpt_dir="", lr_kwargs=worker.LR,
                     log=lambda *a: None, device="cpu")
    want = convert.lm_params_to_numpy(dict(one["params"].named_parameters()),
                                      runs.elastic_cfg)
    bk = want["dense_layers"]["attn"].pop("bk")
    for out in runs.ranks:
        np.testing.assert_allclose(out["elastic/losses"], one["losses"],
                                   **TOL)
        got = out["elastic/final"]
        np.testing.assert_allclose(got["dense_layers"]["attn"]["bk"], bk,
                                   rtol=0, atol=2 * worker.LR["peak_lr"]
                                   * worker.STEPS)
        _close_tree(got, want)


def test_resume_elastic_across_meshes_bit_for_bit(runs):
    """The checkpoint written at (4, 1) (rank 0 alone writes) resumes at
    (2, 1) and in one process: parameters and AdamW state bit for bit."""
    final = runs.ranks[0]["elastic/final"]
    opt = runs.ranks[0]["elastic/opt"]
    for out in runs.ranks[:2]:
        step, params, state = out["elastic/resumed"]
        assert step == worker.STEPS
        _close_tree(params, final, exact=True)
        _close_tree(state["m"], opt["m"], exact=True)
        _close_tree(state["v"], opt["v"], exact=True)
        assert int(state["step"]) == int(opt["step"]) == worker.STEPS
    cfg = runs.elastic_cfg
    model = build_model(cfg)
    opt_init, _ = make_train_step(model)
    params, state, step = resume_elastic(os.path.join(runs.work, "ckpt"),
                                         model, opt_init, None, device="cpu")
    assert step == worker.STEPS
    _close_tree(convert.lm_params_to_numpy(dict(params.named_parameters()),
                                           cfg), final, exact=True)
    _close_tree(convert.adamw_state_to_numpy(state, cfg)["v"], opt["v"],
                exact=True)


def test_meshes_without_a_card():
    """The host mesh on the CPU is (1, 1) over a one-rank gloo group; the
    production meshes are abstract without 256 or 512 ranks."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = pmesh.make_host_mesh("cpu")
        assert sharding.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    for multi, shape in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        m = pmesh.make_production_mesh(multi_pod=multi)
        assert isinstance(m, sharding.AbstractMesh)
        assert m.shape == shape and m.size == (512 if multi else 256)
