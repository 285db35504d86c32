"""Gemma3 (the dense decoder with 5:1 local:global attention) on the CPU
against the reference: prefill, the grouped K/V cache and decode, at
attention tiles that do and do not divide the window, the exact plain
window, the loss and every gradient, one train step and the converters
on the reference's (n_groups, global_every, ...) layout.

The smoke config has 6 layers in 2 groups of 3 (layers 0, 1, 3, 4 local
with window 16, layers 2 and 5 global). Prompts of 48 tokens are longer
than the window, so every local layer's window bites. The reference runs
as `_torch_lm_ref` runs it (its zero-initialised leaves drawn at random,
jitted calls under an Auto-axis mesh); tolerances as there: float32
1e-4, bfloat16 against the reference's float32 answer at its own
cross-path tolerance and against its bfloat16 run at twice it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import TOL, auto_mesh, check, check_tree, ref_params, \
    ref_run, to_np
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.distributed.meshctx import mesh_context
from repro.launch import steps as rsteps
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import steps as psteps
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model

ARCH = "gemma3-12b"
# config variants: the smoke config (one attention tile: the prompt);
# tiles of 8 and 16 keys (window // tile KV tiles back); a window of 12
# at a tile of 8, where the reference's tile bound drops the keys 8 to
# 11 back of rows 0-2 of each tile; the reference's plain attention,
# whose window is exact
VARIANTS = {"smoke": {}, "chunk8": {"attn_chunk": 8},
            "chunk16": {"attn_chunk": 16},
            "window12_chunk8": {"attn_chunk": 8, "window": 12},
            "plain": {"attn_impl": "plain"}}
CASES = ([("float32", v) for v in VARIANTS] + [("bfloat16", "smoke")])


def _configs(dtype="float32", variant="smoke"):
    kw = dict(dtype=dtype, remat=False, **VARIANTS[variant])
    return (ref_smoke_config(ARCH).replace(**kw),
            registry.get_smoke_config(ARCH).replace(**kw))


def _port(pnp, cfg):
    return convert.decoder_params_to_torch(pnp, cfg, "cpu")


@pytest.mark.parametrize("dtype,variant", CASES)
def test_prefill_and_decode_match_reference(dtype, variant):
    """Prefill logits and the grouped K/V cache of a 48-token prompt,
    then three decode steps' logits and the cache after them."""
    rcfg, cfg = _configs(dtype, variant)
    assert (cfg.window, cfg.global_every) == (rcfg.window, 3)
    _, pnp = ref_params(rcfg, perturb=True)
    model, tp = build_model(cfg), _port(pnp, cfg)
    b, l, cap, steps = 2, 48, 52, 3
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, l + steps))
    ref_same = ref_run(rcfg, pnp, toks, l, cap, steps)
    ref_f32 = (ref_same if dtype == "float32" else
               ref_run(rcfg.replace(dtype="float32"), pnp, toks, l, cap,
                       steps))
    pfa.reset_counts()
    with torch.inference_mode():
        lp, cache = model.prefill_fn(tp, {"tokens": torch.as_tensor(
            toks[:, :l])}, cap)
        c0 = convert.decoder_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            lds.append(to_np(ld))
    assert cache["k"].shape[0] == cfg.n_layers
    assert c0["dense"]["k"].shape[:2] == (2, 3)
    assert pfa.flash_attention.plain_calls == (
        0 if variant == "plain" else cfg.n_layers)
    check(to_np(lp), ref_same[0], ref_f32[0], dtype)
    for got, want, want32 in zip(lds, ref_same[1], ref_f32[1]):
        check(got, want, want32, dtype)
    check_tree(c0, ref_same[2], ref_f32[2], dtype)
    check_tree(convert.decoder_cache_to_numpy(cache, cfg), ref_same[3],
               ref_f32[3], dtype)


def test_window_bites_and_the_tile_bound_counts():
    """The local layers' window and the reference's tile bound change
    the answer: logits with window 12 at tile 8 differ from those at one
    tile, and from a global model's, by far more than the tolerance (so
    the cases above pin both)."""
    outs = {}
    for name, kw in (("tile8", dict(attn_chunk=8, window=12)),
                     ("one_tile", dict(window=12)),
                     ("global", dict(global_every=1))):
        cfg = registry.get_smoke_config(ARCH).replace(dtype="float32", **kw)
        params = build_model(cfg).init_params(
            torch.Generator().manual_seed(0), "cpu")
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, 48)))
        with torch.inference_mode():
            h, _ = TF.decoder_forward(params, cfg, toks)
            outs[name] = to_np(TF.logits_fn(params, cfg, h))
    for a, b in (("tile8", "one_tile"), ("one_tile", "global")):
        assert np.abs(outs[a] - outs[b]).max() > 100 * TOL["float32"]["atol"]


def test_generate_matches_reference():
    """`generate` end to end, float32, from a prompt longer than the
    window: the same greedy tokens as the reference's."""
    from repro.launch import serve as rserve
    from repro_torch.launch import serve
    rcfg, cfg = _configs()
    params, pnp = ref_params(rcfg, perturb=True)
    want, _ = rserve.generate(rcfg, batch=2, prompt_len=32, gen=4,
                              mesh=auto_mesh(), params=params,
                              log=lambda *a: None)
    got, _ = serve.generate(cfg, batch=2, prompt_len=32, gen=4,
                            device="cpu", params=_port(pnp, cfg),
                            log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(want))


def _batch(vocab, b, l, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, l + 1)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[:, : l // 4] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _close_tree(got, want, **tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k], to_np(w), err_msg=k,
                                       **(tol or TOL["float32"]))


@pytest.mark.parametrize("variant", ["smoke", "window12_chunk8"])
def test_loss_and_every_gradient_equal_the_reference(variant):
    """The smoke loss over 48 tokens and every parameter's gradient
    against `jax.value_and_grad` of the reference's: the windowed
    backward (the plain version of the kernel's) under the window and
    the tile bound."""
    rcfg, cfg = _configs("float32", variant)
    params, pnp = ref_params(rcfg, perturb=True)
    bt = _batch(cfg.vocab, 2, 48)
    with mesh_context(auto_mesh()):
        (wl, _), wg = jax.jit(jax.value_and_grad(
            ref_build_model(rcfg).loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in bt.items()})
    tp = _port(pnp, cfg).requires_grad_(True)
    pfa.reset_counts()
    loss, _ = build_model(cfg).loss_fn(tp, {k: torch.as_tensor(v)
                                            for k, v in bt.items()})
    np.testing.assert_allclose(float(loss.detach()), float(wl),
                               **TOL["float32"])
    named = dict(tp.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    assert pfa.flash_attention.bwd_plain_calls == cfg.n_layers
    _close_tree(convert.lm_params_to_numpy(grads, cfg), wg)


def test_train_step_equals_the_reference():
    """One `make_train_step` AdamW step from a nonzero state carried by
    the converters: parameters, m, v and the metrics."""
    rcfg, cfg = _configs()
    params, pnp = ref_params(rcfg, perturb=True)
    rng = np.random.default_rng(5)
    m = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32)
                     * 1e-2, pnp)
    v = jax.tree.map(lambda x: rng.uniform(size=x.shape).astype(np.float32)
                     * 1e-4, pnp)
    rstate = {"step": jnp.int32(3), "m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v)}
    bt = _batch(cfg.vocab, 2, 48, seed=1)
    lr_kwargs = {"warmup": 2, "total": 20, "peak_lr": 1e-2}
    _, rstep = rsteps.make_train_step(ref_build_model(rcfg),
                                      lr_kwargs=lr_kwargs)
    with mesh_context(auto_mesh()):
        wp, wstate, wmet = jax.jit(rstep)(
            params, rstate, {k: jnp.asarray(x) for k, x in bt.items()},
            jnp.int32(4))
    _, pstep = psteps.make_train_step(build_model(cfg), lr_kwargs=lr_kwargs)
    tp = _port(pnp, cfg).requires_grad_(True)
    tstate = convert.adamw_state_to_torch({"step": 3, "m": m, "v": v}, cfg,
                                          "cpu")
    tp, tstate, met = pstep(tp, tstate, {k: torch.as_tensor(x)
                                         for k, x in bt.items()}, 4)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]),
                                   **TOL["float32"])
    _close_tree(convert.lm_params_to_numpy(dict(tp.named_parameters()),
                                           cfg), wp)
    got = convert.adamw_state_to_numpy(tstate, cfg)
    _close_tree(got["m"], wstate["m"])
    _close_tree(got["v"], wstate["v"])


def test_converters_round_trip_the_grouped_layout():
    """Parameters, AdamW state and the K/V cache through the converters
    and back, bit for bit, on the reference's (n_groups, g, ...) layout;
    the port's layer i is the reference's [i // g, i % g]."""
    rcfg, cfg = _configs()
    _, pnp = ref_params(rcfg, perturb=True)
    tp = _port(pnp, cfg)
    assert len(tp.layers) == cfg.n_layers
    np.testing.assert_array_equal(
        tp.layers[4].attn["wq"].numpy(),
        pnp["dense_layers"]["attn"]["wq"][1, 1])
    back = convert.lm_params_to_numpy(dict(tp.named_parameters()), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(pnp)
    _close_tree(back, pnp, rtol=0, atol=0)
    state = {"step": 7, "m": pnp, "v": jax.tree.map(np.abs, pnp)}
    got = convert.adamw_state_to_numpy(
        convert.adamw_state_to_torch(state, cfg, "cpu"), cfg)
    _close_tree(got["m"], state["m"], rtol=0, atol=0)
    _close_tree(got["v"], state["v"], rtol=0, atol=0)
    rng = np.random.default_rng(2)
    cache = {"dense": {k: rng.normal(size=(2, 3, 2, 8, 2, 16)).astype(
        np.float32) for k in ("k", "v")}}
    port = convert.decoder_cache_to_torch(cache, cfg, "cpu")
    assert port["k"].shape == (6, 2, 8, 2, 16)
    torch.testing.assert_close(port["v"][5], torch.as_tensor(
        cache["dense"]["v"][1, 2]), rtol=0, atol=0)
    _close_tree(convert.decoder_cache_to_numpy(port, cfg), cache, rtol=0,
                atol=0)
