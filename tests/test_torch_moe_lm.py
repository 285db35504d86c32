"""The MoE family (Qwen2-MoE; DeepSeek-V3 with multi-head latent
attention and multi-token prediction) on the CPU against the reference:
prefill logits, the cache in the reference's layout and decode steps,
`generate`, the loss with its "xent", "aux" and "mtp" terms and every
parameter's gradient, three AdamW train steps, and the registry,
`build_model` and the CLIs (DeepSeek-V3's Adafactor steps are in
`test_torch_adafactor.py`).

The smoke configs (Qwen2-MoE: 2 MoE layers of 8 experts, top 2, one
shared expert, GQA with a QKV bias; DeepSeek-V3: 1 dense and 3 MoE
layers, MLA, MTP) and a Qwen2-MoE variant with the full config's
dispatch: 6 experts padded to 8 and `hierarchical`, the reference run
under an Auto-axis mesh (one data shard, so its per-shard dispatch is
the flat one). Its 32-token prompts overflow some experts' capacity, so
slots drop in its prefill. The reference's parameters are carried by
`convert`, with the leaves it initialises to zeros (norms, biases)
drawn at random (`_torch_lm_ref.ref_params(perturb=True)`). Tolerances
as `_torch_lm_ref` states them: float32 1e-4; bfloat16 against the
reference's float32 answer at its own cross-path tolerance and against
its bfloat16 run at twice it. The padded variant is held in float32:
in bfloat16 the reference's loss differs by 1.2e-3 with and without the
mesh, the reference against itself. DeepSeek-V3's serving path is held
in float32: in bfloat16 a route flips at depth (`CASES`). The
reference's parameters are shared through a module-scoped fixture.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import (TOL, auto_mesh, cast_params, check, check_tree,
                           ref_params, ref_run, to_np)
from _torch_parity import RoutesRecorded, one_torch_thread  # noqa: F401
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.distributed.meshctx import mesh_context
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import serve
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model

QWEN, DSV3 = "qwen2-moe-a2.7b", "deepseek-v3-671b"
# the full Qwen2-MoE's dispatch at smoke size: experts padded, the
# reference's hierarchical dispatch
PADDED = dict(n_experts=6, top_k=2, n_shared=1, d_ff_expert=64,
              n_experts_padded=8, dispatch="hierarchical")
# (arch, dtype, variant). DeepSeek-V3 is held in float32 only: in
# bfloat16 its routes flip at depth (2 of 32 tokens in its second and
# third MoE layers' prefill), and the reference's own bfloat16 prefill
# logits are then 0.58 from its float32 answer. MLA at two attention
# tiles is held in `test_torch_mla.py`
CASES = [(QWEN, "float32", "smoke"), (QWEN, "bfloat16", "smoke"),
         (QWEN, "float32", "padded"), (DSV3, "float32", "smoke")]
PROMPT = {"smoke": 16, "padded": 32}


def _configs(arch, dtype="float32", variant="smoke"):
    kw = dict(dtype=dtype, remat=False)
    rcfg = ref_smoke_config(arch).replace(**kw)
    cfg = registry.get_smoke_config(arch).replace(**kw)
    if variant == "padded":
        rcfg = rcfg.replace(moe=RefMoEConfig(**PADDED))
        cfg = cfg.replace(moe=MoEConfig(**PADDED))
    return rcfg, cfg


def _mesh(variant):
    """The reference's hierarchical dispatch runs under a mesh."""
    return (mesh_context(auto_mesh()) if variant == "padded" else
            contextlib.nullcontext())


@pytest.fixture(scope="module")
def refs():
    """{(arch, dtype, variant): the reference's parameters, as float32
    numpy}, made once a module."""
    cache = {}

    def get(arch, dtype="float32", variant="smoke"):
        key = (arch, dtype, variant)
        if key not in cache:
            cache[key] = ref_params(_configs(arch, dtype, variant)[0],
                                    perturb=True, jit=True)[1]
        return cache[key]
    return get


def _port(pnp, cfg):
    return convert.decoder_params_to_torch(pnp, cfg, "cpu")


@pytest.mark.parametrize("arch,dtype,variant", CASES)
def test_prefill_and_decode_match_reference(refs, arch, dtype, variant):
    """Prefill logits and the cache (the reference's {"dense", "moe"}
    layout: K/V, or MLA's latents), then three decode steps' logits and
    the cache after them. One flash call a layer in the prefill (its
    plain version here); in the padded variant's prefill, slots drop."""
    rcfg, cfg = _configs(arch, dtype, variant)
    pnp = refs(arch, dtype, variant)
    model, tp = build_model(cfg), _port(pnp, cfg)
    b, l, steps = 2, PROMPT[variant], 3
    cap = l + steps + 1
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, l + steps))
    with _mesh(variant):
        ref_same = ref_run(rcfg, pnp, toks, l, cap, steps, jit=True)
        ref_f32 = (ref_same if dtype == "float32" else
                   ref_run(rcfg.replace(dtype="float32"), pnp, toks, l, cap,
                           steps, jit=True))
    pfa.reset_counts()
    with torch.inference_mode(), RoutesRecorded() as routes:
        lp, cache = model.prefill_fn(tp, {"tokens": torch.as_tensor(
            toks[:, :l])}, cap)
        c0 = convert.decoder_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            lds.append(to_np(ld))
    assert pfa.flash_attention.plain_calls == cfg.n_layers
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    assert len(routes.idx) == n_moe * (1 + steps)
    drops = [int(pmoe.dropped(i, cfg.moe.e_padded,
                              pmoe.capacity(b * l, cfg.moe)).sum())
             for i in routes.idx[:n_moe]]
    if variant == "padded":
        assert sum(drops) > 0, drops
    assert set(c0) == set(ref_same[2])
    check(to_np(lp), ref_same[0], ref_f32[0], dtype)
    for got, want, want32 in zip(lds, ref_same[1], ref_f32[1]):
        check(got, want, want32, dtype)
    check_tree(c0, ref_same[2], ref_f32[2], dtype)
    check_tree(convert.decoder_cache_to_numpy(cache, cfg), ref_same[3],
               ref_f32[3], dtype)


@pytest.mark.parametrize("arch", [QWEN, DSV3])
def test_generate_matches_reference(refs, arch):
    """`generate` end to end, float32: the same greedy tokens as the
    reference's."""
    rcfg, cfg = _configs(arch)
    pnp = refs(arch)
    want, _ = rserve.generate(rcfg, batch=2, prompt_len=16, gen=4,
                              mesh=auto_mesh(),
                              params=cast_params(pnp, jnp.float32),
                              log=lambda *a: None)
    got, _ = serve.generate(cfg, batch=2, prompt_len=16, gen=4,
                            device="cpu", params=_port(pnp, cfg),
                            log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(want))


def _batch(vocab, b, l, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, l + 1)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[:, : l // 4] = 0.0
    mask[0, -1] = 0.5
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _close_tree(got, want, **tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k], to_np(w), err_msg=k,
                                       **(tol or TOL["float32"]))


@pytest.mark.parametrize("arch,variant", [(QWEN, "smoke"), (QWEN, "padded"),
                                          (DSV3, "smoke")])
def test_loss_and_every_gradient_equal_the_reference(refs, arch, variant):
    """The loss and its metrics ({"xent", "aux"}, and "mtp" for
    DeepSeek-V3) over a masked batch, and every parameter's gradient
    (routers, experts, shared experts, MLA, the MTP head) against
    `jax.value_and_grad` of the reference's, float32."""
    rcfg, cfg = _configs(arch, "float32", variant)
    pnp = refs(arch, "float32", variant)
    bt = _batch(cfg.vocab, 2, PROMPT[variant])
    with mesh_context(auto_mesh()):
        (wl, wmet), wg = jax.jit(jax.value_and_grad(
            ref_build_model(rcfg).loss_fn, has_aux=True))(
            cast_params(pnp, jnp.float32),
            {k: jnp.asarray(v) for k, v in bt.items()})
    tp = _port(pnp, cfg).requires_grad_(True)
    loss, met = build_model(cfg).loss_fn(tp, {k: torch.as_tensor(v)
                                              for k, v in bt.items()})
    assert set(met) == set(wmet) == (
        {"xent", "aux", "mtp"} if arch == DSV3 else {"xent", "aux"})
    np.testing.assert_allclose(float(loss.detach()), float(wl),
                               **TOL["float32"])
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(wmet[k]),
                                   err_msg=k, **TOL["float32"])
    named = dict(tp.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    _close_tree(convert.lm_params_to_numpy(grads, cfg), wg)


def test_train_steps_equal_the_reference(refs):
    """Three `make_train_step` AdamW steps of Qwen2-MoE from the same
    parameters and a nonzero AdamW state carried by the converters (from
    a zero state, Adam's first steps move every parameter by about the
    learning rate along the sign of its gradient, and the K bias's
    gradient is rounding noise: softmax does not see it): every step's
    metrics ("xent", "aux", "loss", "gnorm", "lr"), then the parameters,
    m and v, against the reference's jitted step."""
    rcfg, cfg = _configs(QWEN)
    pnp = refs(QWEN)
    lr_kwargs = {"warmup": 2, "total": 20, "peak_lr": 1e-2}
    _, rstep = rsteps.make_train_step(ref_build_model(rcfg),
                                      lr_kwargs=lr_kwargs)
    _, pstep = psteps.make_train_step(build_model(cfg), lr_kwargs=lr_kwargs)
    rng = np.random.default_rng(5)
    m = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32)
                     * 1e-2, pnp)
    v = jax.tree.map(lambda x: rng.uniform(size=x.shape).astype(np.float32)
                     * 1e-4, pnp)
    params = cast_params(pnp, jnp.float32)
    rstate = {"step": jnp.int32(3), "m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v)}
    tp = _port(pnp, cfg).requires_grad_(True)
    tstate = convert.adamw_state_to_torch({"step": 3, "m": m, "v": v}, cfg,
                                          "cpu")
    jstep = jax.jit(rstep)
    for step in range(3):
        bt = _batch(cfg.vocab, 2, 16, seed=step)
        with mesh_context(auto_mesh()):
            params, rstate, wmet = jstep(
                params, rstate, {k: jnp.asarray(x) for k, x in bt.items()},
                jnp.int32(step))
        tp, tstate, met = pstep(tp, tstate, {k: torch.as_tensor(x)
                                             for k, x in bt.items()}, step)
        assert set(met) == set(wmet) == {"xent", "aux", "loss", "gnorm",
                                         "lr"}
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(wmet[k]),
                                       err_msg=f"step {step} {k}",
                                       **TOL["float32"])
    _close_tree(convert.lm_params_to_numpy(dict(tp.named_parameters()),
                                           cfg), params)
    got = convert.adamw_state_to_numpy(tstate, cfg)
    _close_tree(got["m"], rstate["m"])
    _close_tree(got["v"], rstate["v"])


@pytest.mark.parametrize("arch", [QWEN, DSV3])
def test_registry_and_build_model_resolve(arch):
    """Both archs resolve to the reference's configs (field for field,
    sub-configs included) and build: layer blocks in order (DeepSeek-V3:
    3 dense, then MoE; its smoke config 1 dense), the MTP head where
    the config has one."""
    from repro.configs.registry import get_config as ref_config
    for get, rget in ((registry.get_config, ref_config),
                      (registry.get_smoke_config, ref_smoke_config)):
        cfg, rcfg = get(arch), rget(arch)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "vocab", "use_mtp", "optimizer", "qkv_bias"):
            assert getattr(cfg, f) == getattr(rcfg, f), f
        assert vars(cfg.moe) == vars(rcfg.moe)
        assert (cfg.mla is None) == (rcfg.mla is None)
        if cfg.mla is not None:
            assert vars(cfg.mla) == vars(rcfg.mla)
    assert arch in registry.ARCH_IDS
    cfg = registry.get_smoke_config(arch)
    model = build_model(cfg)
    assert model.cfg.family == "moe"
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    kinds = [type(b).__name__ for b in params.layers]
    n_dense = cfg.moe.n_dense_layers
    assert kinds == ["DenseBlock"] * n_dense + ["MoEBlock"] * (
        cfg.n_layers - n_dense)
    assert hasattr(params, "mtp") == cfg.use_mtp
    assert TF.layer_counts(registry.get_config(arch)) == (
        registry.get_config(arch).moe.n_dense_layers,
        registry.get_config(arch).n_layers
        - registry.get_config(arch).moe.n_dense_layers)


def test_train_and_serve_clis_run_the_moe_family(capsys):
    """`launch/train.py --arch qwen2-moe-a2.7b --smoke --device cpu`
    prints its JSON line of the same form as for the other families
    (finite losses), and `launch/serve.py`'s `generate` runs both MoE
    archs' smoke configs."""
    ptrain.main(["--arch", QWEN, "--smoke", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"first_loss", "last_loss", "n_flagged"}
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    for arch in (QWEN, DSV3):
        toks, stats = serve.generate(registry.get_smoke_config(arch),
                                     batch=2, prompt_len=8, gen=3,
                                     device="cpu", log=lambda *a: None)
        assert toks.shape == (2, 3) and set(stats) == {"prefill_s",
                                                       "decode_s"}
