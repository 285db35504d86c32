"""The VLM family (LLaVA-NeXT; image patches prepended to the tokens) on
the CPU against the reference: prefill logits and the K/V cache over
patches and prompt, three decode steps at positions that count the
patches, the loss over the text positions and every parameter's
gradient, `generate`, and the registry and `build_model`.

The smoke config: 2 layers, D 64, GQA 4/2 at head dim 16, 8 patches.
The reference's `generate` sizes its cache without the patches and
raises for this family (ROADMAP.md, queue 3), so `generate` is held to
the reference's `prefill_fn` and `decode_fn` at the capacity and the
positions the port counts. The reference runs as `_torch_lm_ref` runs it
(its zero-initialised leaves drawn at random, jitted calls); tolerances
as there: float32 1e-4; bfloat16 against the reference's float32 answer
at its own cross-path tolerance and against its bfloat16 run at twice
it (`check`).
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
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import serve
from repro_torch.models.model import build_model

ARCH = "llava-next-34b"
# (dtype, config overrides): the smoke config (one attention tile over
# patches and prompt); a tile of 8, which splits the patches from the
# prompt
CASES = [("float32", {}), ("float32", {"attn_chunk": 8}),
         ("bfloat16", {})]


def _configs(dtype="float32", **kw):
    kw = dict(dtype=dtype, remat=False, **kw)
    return (ref_smoke_config(ARCH).replace(**kw),
            registry.get_smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def refs():
    """{dtype: the reference's parameters as float32 numpy}."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = ref_params(_configs(dtype)[0], perturb=True,
                                      jit=True)[1]
        return cache[dtype]
    return get


def _patches(rng, b, cfg):
    """N(0, 1) patch embeddings, bfloat16-valued, as `generate` draws
    them."""
    x = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return to_np(torch.from_numpy(x).to(torch.bfloat16))


def _ref_serve(rcfg, pnp, toks, patches, l, steps):
    """The reference's prefill (capacity n_patches + l + steps) and
    `steps` decode steps at n_patches + l + i: logits and caches."""
    rm = ref_build_model(rcfg)
    params = cast_params(pnp, jnp.dtype(rcfg.dtype))
    p = patches.shape[1]
    cap = p + l + steps
    prefill = jax.jit(rm.prefill_fn, static_argnums=2)
    lp, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :l]),
                                 "patches": jnp.asarray(patches)}, cap)
    c0 = jax.tree.map(to_np, cache)
    lds = []
    decode = jax.jit(rm.decode_fn)
    for i in range(steps):
        ld, cache = decode(params, cache,
                           jnp.asarray(toks[:, l + i:l + i + 1]),
                           jnp.int32(p + l + i))
        lds.append(to_np(ld))
    return to_np(lp), lds, c0, jax.tree.map(to_np, cache)


@pytest.mark.parametrize("dtype,kw", CASES)
def test_prefill_and_decode_match_reference(refs, dtype, kw):
    """Prefill over 8 patches and an 8-token prompt: last logits and the
    K/V cache (16 positions filled), then three decode steps at 16, 17,
    18: logits and the cache. One flash call a layer in the prefill."""
    rcfg, cfg = _configs(dtype, **kw)
    pnp = refs(dtype)
    b, l, steps = 2, 8, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (b, l + steps))
    patches = _patches(rng, b, cfg)
    ref_same = _ref_serve(rcfg, pnp, toks, patches, l, steps)
    ref_f32 = (ref_same if dtype == "float32" else _ref_serve(
        rcfg.replace(dtype="float32"), pnp, toks, patches, l, steps))
    model = build_model(cfg)
    tp = convert.decoder_params_to_torch(pnp, cfg, "cpu")
    p = cfg.n_patches
    pfa.reset_counts()
    with torch.inference_mode():
        lp, cache = model.prefill_fn(tp, {
            "tokens": torch.as_tensor(toks[:, :l]),
            "patches": torch.as_tensor(patches)}, p + l + steps)
        c0 = convert.decoder_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), p + l + i)
            lds.append(to_np(ld))
    assert pfa.flash_attention.plain_calls == cfg.n_layers
    assert np.any(c0["dense"]["k"][:, :, :p]) and not np.any(
        c0["dense"]["k"][:, :, p + l:])
    check(to_np(lp), ref_same[0], ref_f32[0], dtype)
    for got, want, want32 in zip(lds, ref_same[1], ref_f32[1]):
        check(got, want, want32, dtype)
    check_tree(c0, ref_same[2], ref_f32[2], dtype)
    check_tree(convert.decoder_cache_to_numpy(cache, cfg), ref_same[3],
               ref_f32[3], dtype)


@pytest.mark.parametrize("kw", [{}, {"attn_chunk": 8}])
def test_loss_and_every_gradient_equal_the_reference(refs, kw):
    """The loss over the text positions only (a masked batch after 8
    patches) and every parameter's gradient against
    `jax.value_and_grad` of the reference's, float32; the patches'
    gradient too."""
    rcfg, cfg = _configs(**kw)
    pnp = refs("float32")
    rng = np.random.default_rng(2)
    b, l = 2, 8
    toks = rng.integers(0, cfg.vocab, (b, l + 1)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[:, :2] = 0.0
    bt = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask,
          "patches": _patches(rng, b, cfg)}

    def ref_loss(params, patches):
        return ref_build_model(rcfg).loss_fn(
            params, dict({k: jnp.asarray(v) for k, v in bt.items()},
                         patches=patches))
    with mesh_context(auto_mesh()):
        (wl, wmet), (wg, wgp) = jax.jit(jax.value_and_grad(
            ref_loss, argnums=(0, 1), has_aux=True))(
            cast_params(pnp, jnp.float32), jnp.asarray(bt["patches"]))
    tp = convert.decoder_params_to_torch(pnp, cfg, "cpu").requires_grad_(
        True)
    patches = torch.as_tensor(bt["patches"]).requires_grad_(True)
    loss, met = build_model(cfg).loss_fn(tp, dict(
        {k: torch.as_tensor(v) for k, v in bt.items()}, patches=patches))
    assert set(met) == set(wmet) == {"xent"}
    np.testing.assert_allclose(float(loss.detach()), float(wl),
                               **TOL["float32"])
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()) + [patches])
    got = convert.lm_params_to_numpy(dict(zip(named, grads[:-1])), cfg)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(wg)):
        np.testing.assert_allclose(g, to_np(w), err_msg=str(path),
                                   **TOL["float32"])
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(to_np, wg))
    np.testing.assert_allclose(to_np(grads[-1]), to_np(wgp),
                               **TOL["float32"])


def test_generate_counts_the_patches(refs):
    """`generate` (float32): the greedy tokens of the reference's
    `prefill_fn` and `decode_fn` at capacity n_patches + prompt_len +
    gen and positions n_patches + prompt_len + i, on the prompt and the
    patches drawn from `default_rng(seed)` as the reference's `generate`
    draws them."""
    rcfg, cfg = _configs()
    pnp = refs("float32")
    b, l, gen = 2, 8, 4
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (b, l))
    patches = rng.normal(size=(b, cfg.n_patches, cfg.d_model))
    rm = ref_build_model(rcfg)
    params = cast_params(pnp, jnp.float32)
    p = cfg.n_patches
    lp, cache = rm.prefill_fn(params, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "patches": jnp.asarray(patches, jnp.bfloat16)}, p + l + gen)
    want = [jnp.argmax(lp[..., :cfg.vocab], -1).astype(jnp.int32)]
    for i in range(gen - 1):
        ld, cache = rm.decode_fn(params, cache, want[-1],
                                 jnp.int32(p + l + i))
        want.append(jnp.argmax(ld[..., :cfg.vocab], -1).astype(jnp.int32))
    got, _ = serve.generate(cfg, batch=b, prompt_len=l, gen=gen,
                            device="cpu", params=convert.
                            decoder_params_to_torch(pnp, cfg, "cpu"),
                            log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(jnp.concatenate(want, 1)))


def test_reference_generate_cannot_serve_the_vlm():
    """The finding the port's `generate` departs for: the reference's
    sizes the cache prompt_len + gen, which the patches overflow."""
    rcfg, _ = _configs()
    with pytest.raises(ValueError, match="negative"):
        rserve.generate(rcfg, batch=2, prompt_len=8, gen=4,
                        mesh=auto_mesh(), log=lambda *a: None)


def test_registry_and_build_model_resolve():
    """The full and smoke configs are the reference's, field for field;
    the family builds on the decoder, and its random parameters serve
    through `generate` (bfloat16, the smoke config)."""
    for get, rget in ((registry.get_config, ref_config),
                      (registry.get_smoke_config, ref_smoke_config)):
        assert vars(get(ARCH)) == vars(rget(ARCH))
    assert ARCH in registry.ARCH_IDS
    cfg = registry.get_smoke_config(ARCH)
    assert cfg.family == "vlm" and cfg.n_patches == 8
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          "cpu")
    assert type(params).__name__ == "DecoderLM"
    toks, stats = serve.generate(cfg, batch=2, prompt_len=8, gen=3,
                                 device="cpu", params=params,
                                 log=lambda *a: None)
    assert toks.shape == (2, 3) and set(stats) == {"prefill_s", "decode_s"}
