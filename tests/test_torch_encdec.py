"""The audio family (Whisper, the encoder-decoder) on the CPU against the
reference: the encoder, prefill logits and the self- and cross-attention
caches, three decode steps, the loss and every parameter's gradient,
`generate`, one AdamW and one Adafactor `make_train_step` step, the
converters, and the registry and `build_model`.

The smoke config: 2 encoder and 2 decoder layers, D 48, 4 heads of 12,
16 frames. The encoder's attention runs on `flash_attention` without a
causal mask at one tile of every frame (its plain version here): a
variant at 150 frames, which no tile of 128 divides (as none divides
Whisper's 1,500), holds that tile. The reference runs as
`_torch_lm_ref` runs it (its zero-initialised leaves drawn at random,
jitted calls under an Auto-axis mesh); tolerances as there: float32
1e-4; bfloat16 against the reference's float32 answer at its own
cross-path tolerance and against its bfloat16 run at twice it (`check`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import (TOL, auto_mesh, cast_params, check, check_tree,
                           ref_params, to_np)
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.distributed.meshctx import mesh_context
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import encdec as red
from repro.models.model import build_model as ref_build_model
from repro.optim import optimizers as ropt
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import serve
from repro_torch.launch import steps as psteps
from repro_torch.models import encdec as ED
from repro_torch.models.model import build_model

ARCH = "whisper-tiny"
# (dtype, frames)
CASES = [("float32", 16), ("float32", 150), ("bfloat16", 16)]


def _configs(dtype="float32", frames=16, **kw):
    kw = dict(dtype=dtype, remat=False, n_audio_frames=frames, **kw)
    return (ref_smoke_config(ARCH).replace(**kw),
            registry.get_smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def refs():
    """{dtype: the reference's parameters as float32 numpy} (the frame
    count changes no parameter)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = ref_params(_configs(dtype)[0], perturb=True,
                                      jit=True)[1]
        return cache[dtype]
    return get


def _port(pnp, cfg):
    return convert.encdec_params_to_torch(pnp, cfg, "cpu")


def _frames(rng, b, t, d):
    """N(0, 1) frame embeddings, bfloat16-valued, as `generate` draws
    them."""
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    return to_np(torch.from_numpy(x).to(torch.bfloat16))


def _ref_serve(rcfg, pnp, frames, toks, l, steps):
    rm = ref_build_model(rcfg)
    params = cast_params(pnp, jnp.dtype(rcfg.dtype))
    with mesh_context(auto_mesh()):
        lp, cache = jax.jit(rm.prefill_fn, static_argnums=2)(
            params, {"frames": jnp.asarray(frames),
                     "tokens": jnp.asarray(toks[:, :l])}, l + steps)
        c0 = jax.tree.map(to_np, cache)
        decode = jax.jit(rm.decode_fn)
        lds = []
        for i in range(steps):
            ld, cache = decode(params, cache,
                               jnp.asarray(toks[:, l + i:l + i + 1]),
                               jnp.int32(l + i))
            lds.append(to_np(ld))
    return to_np(lp), lds, c0, jax.tree.map(to_np, cache)


@pytest.mark.parametrize("dtype,frames", CASES)
def test_prefill_and_decode_match_reference(refs, dtype, frames):
    """Encode the frames, prefill a 4-token prompt: last logits and the
    cache (self K/V with room for 3 more, cross K/V over every frame),
    then three decode steps: logits and the cache. One flash call an
    encoder layer (non-causal) and one a decoder layer (causal)."""
    rcfg, cfg = _configs(dtype, frames)
    pnp = refs(dtype)
    b, l, steps = 2, 4, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (b, l + steps))
    fr = _frames(rng, b, frames, cfg.d_model)
    ref_same = _ref_serve(rcfg, pnp, fr, toks, l, steps)
    ref_f32 = (ref_same if dtype == "float32" else _ref_serve(
        rcfg.replace(dtype="float32"), pnp, fr, toks, l, steps))
    model, tp = build_model(cfg), _port(pnp, cfg)
    pfa.reset_counts()
    with torch.inference_mode():
        lp, cache = model.prefill_fn(tp, {
            "frames": torch.as_tensor(fr),
            "tokens": torch.as_tensor(toks[:, :l])}, l + steps)
        c0 = convert.encdec_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            lds.append(to_np(ld))
    assert pfa.flash_attention.plain_calls == cfg.n_enc_layers + cfg.n_layers
    assert c0["cross_k"].shape[2] == frames
    check(to_np(lp), ref_same[0], ref_f32[0], dtype)
    for got, want, want32 in zip(lds, ref_same[1], ref_f32[1]):
        check(got, want, want32, dtype)
    check_tree(c0, ref_same[2], ref_f32[2], dtype)
    check_tree(convert.encdec_cache_to_numpy(cache, cfg), ref_same[3],
               ref_f32[3], dtype)


@pytest.mark.parametrize("frames", [16, 150])
def test_encoder_matches_reference(refs, frames):
    """`encode` alone, float32: the reference's plain bidirectional
    attention against flash without a mask at one tile of every frame."""
    rcfg, cfg = _configs("float32", frames)
    pnp = refs("float32")
    fr = _frames(np.random.default_rng(3), 2, frames, cfg.d_model)
    with mesh_context(auto_mesh()):
        want = to_np(jax.jit(red.encode, static_argnums=1)(
            cast_params(pnp, jnp.float32), rcfg, jnp.asarray(fr)))
    with torch.inference_mode():
        got = to_np(ED.encode(_port(pnp, cfg), cfg, torch.as_tensor(fr)))
    np.testing.assert_allclose(got, want, **TOL["float32"])


def _batch(rng, cfg, b, l, frames):
    toks = rng.integers(0, cfg.vocab, (b, l + 1)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[:, :2] = 0.0
    mask[0, -1] = 0.5
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask,
            "frames": _frames(rng, b, frames, cfg.d_model)}


def _close_tree(got, want, **tol):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k], to_np(w), err_msg=k,
                                       **(tol or TOL["float32"]))


@pytest.mark.parametrize("frames", [16, 150])
def test_loss_and_every_gradient_equal_the_reference(refs, frames):
    """The loss over a masked batch and every parameter's gradient
    (encoder, decoder self- and cross-attention, norms, embedding, head)
    against `jax.value_and_grad` of the reference's, float32; the
    encoder's attention differentiated through flash's plain backward
    without a mask."""
    rcfg, cfg = _configs("float32", frames)
    pnp = refs("float32")
    bt = _batch(np.random.default_rng(2), cfg, 2, 8, frames)
    with mesh_context(auto_mesh()):
        (wl, wmet), wg = jax.jit(jax.value_and_grad(
            ref_build_model(rcfg).loss_fn, has_aux=True))(
            cast_params(pnp, jnp.float32),
            {k: jnp.asarray(v) for k, v in bt.items()})
    tp = _port(pnp, cfg).requires_grad_(True)
    pfa.reset_counts()
    loss, met = build_model(cfg).loss_fn(tp, {k: torch.as_tensor(v)
                                              for k, v in bt.items()})
    assert set(met) == set(wmet) == {"xent"}
    np.testing.assert_allclose(float(loss.detach()), float(wl),
                               **TOL["float32"])
    named = dict(tp.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    assert pfa.flash_attention.bwd_plain_calls == (cfg.n_enc_layers
                                                   + cfg.n_layers)
    _close_tree(convert.lm_params_to_numpy(grads, cfg),
                jax.tree.map(to_np, wg))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_equals_the_reference(refs, optimizer):
    """One `make_train_step` step from a nonzero state (step 3) carried
    by the converters: the metrics, every parameter and the optimizer's
    state in the reference's layout (Adafactor's over the stacked
    `enc_layers` and `dec_layers`)."""
    rcfg, cfg = _configs("float32", 16, optimizer=optimizer)
    pnp = refs("float32")
    lr_kwargs = {"warmup": 2, "total": 20, "peak_lr": 1e-2}
    _, rstep = rsteps.make_train_step(ref_build_model(rcfg),
                                      lr_kwargs=lr_kwargs)
    _, pstep = psteps.make_train_step(build_model(cfg), lr_kwargs=lr_kwargs)
    rng = np.random.default_rng(5)
    params = cast_params(pnp, jnp.float32)
    tp = _port(pnp, cfg).requires_grad_(True)
    if optimizer == "adamw":
        m = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32) * 1e-2, pnp)
        v = jax.tree.map(lambda x: rng.uniform(size=x.shape).astype(
            np.float32) * 1e-4, pnp)
        rstate = {"step": jnp.int32(3), "m": m, "v": v}
        tstate = convert.adamw_state_to_torch({"step": 3, "m": m, "v": v},
                                              cfg, "cpu")
    else:
        vs = jax.tree.map(lambda x: (rng.uniform(size=x.shape) * 1e-4
                                     + 1e-6).astype(np.float32),
                          jax.tree.map(to_np, ropt.adafactor_init(
                              params)["vs"]))
        rstate = {"step": jnp.int32(3), "vs": vs}
        tstate = convert.adafactor_state_to_torch(rstate, "cpu")
    bt = _batch(np.random.default_rng(6), cfg, 2, 8, 16)
    with mesh_context(auto_mesh()):
        wp, wstate, wmet = jax.jit(rstep)(
            params, jax.tree.map(jnp.asarray, rstate),
            {k: jnp.asarray(x) for k, x in bt.items()}, jnp.int32(3))
    tp, tstate, met = pstep(tp, tstate, {k: torch.as_tensor(x)
                                         for k, x in bt.items()}, 3)
    assert set(met) == set(wmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]), err_msg=k,
                                   **TOL["float32"])
    _close_tree(convert.lm_params_to_numpy(dict(tp.named_parameters()),
                                           cfg), jax.tree.map(to_np, wp))
    if optimizer == "adamw":
        got = convert.adamw_state_to_numpy(tstate, cfg)
        _close_tree(got["m"], jax.tree.map(to_np, wstate["m"]))
        _close_tree(got["v"], jax.tree.map(to_np, wstate["v"]))
    else:
        got = convert.adafactor_state_to_numpy(tstate)
        _close_tree(got["vs"], jax.tree.map(to_np, wstate["vs"]),
                    rtol=1e-4, atol=1e-10)


def test_generate_matches_reference(refs):
    """`generate` end to end, float32: the frames drawn after the prompt
    from `default_rng(seed)`, as the reference's `generate` draws them;
    the same greedy tokens."""
    rcfg, cfg = _configs()
    pnp = refs("float32")
    want, _ = rserve.generate(rcfg, batch=2, prompt_len=4, gen=4,
                              mesh=auto_mesh(),
                              params=cast_params(pnp, jnp.float32),
                              log=lambda *a: None)
    got, _ = serve.generate(cfg, batch=2, prompt_len=4, gen=4,
                            device="cpu", params=_port(pnp, cfg),
                            log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_converters_invert_each_other(refs):
    """`encdec_params_to_torch` and `lm_params_to_numpy` bit for bit;
    the cache converters likewise; `init_encdec`'s tree and shapes are
    the reference's."""
    rcfg, cfg = _configs()
    pnp = refs("float32")
    back = convert.lm_params_to_numpy(dict(_port(pnp, cfg)
                                           .named_parameters()), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(pnp)
    _close_tree(back, pnp, rtol=0, atol=0)
    rng = np.random.default_rng(4)
    cache = {k: rng.normal(size=x.shape).astype(np.float32) for k, x in
             red.encdec_init_cache(rcfg, 2, 8).items()}
    got = convert.encdec_cache_to_numpy(
        convert.encdec_cache_to_torch(cache, cfg, "cpu"), cfg)
    _close_tree(got, cache, rtol=0, atol=0)
    own = convert.lm_params_to_numpy(dict(build_model(cfg).init_params(
        torch.Generator().manual_seed(0), "cpu").named_parameters()), cfg)
    assert jax.tree.structure(own) == jax.tree.structure(pnp)
    for a, w in zip(jax.tree.leaves(own), jax.tree.leaves(pnp)):
        assert a.shape == w.shape
    assert {k: tuple(v.shape) for k, v in ED.encdec_init_cache(
        cfg, 2, 8, "cpu").items()} == {k: v.shape for k, v in cache.items()}


def test_registry_and_build_model_resolve():
    """The full and smoke configs are the reference's, field for field;
    the family builds on the encoder-decoder, and its random parameters
    serve through `generate` (bfloat16, the smoke config)."""
    for get, rget in ((registry.get_config, ref_config),
                      (registry.get_smoke_config, ref_smoke_config)):
        assert vars(get(ARCH)) == vars(rget(ARCH))
    assert ARCH in registry.ARCH_IDS
    cfg = registry.get_smoke_config(ARCH)
    assert cfg.family == "audio"
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          "cpu")
    assert isinstance(params, ED.EncDecLM)
    toks, stats = serve.generate(cfg, batch=2, prompt_len=4, gen=3,
                                 device="cpu", params=params,
                                 log=lambda *a: None)
    assert toks.shape == (2, 3) and set(stats) == {"prefill_s", "decode_s"}
