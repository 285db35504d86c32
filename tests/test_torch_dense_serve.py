"""The port's dense decoder serving path (`models/transformer.py`,
`models/model.py`, `launch/serve.py`) against the reference on the
Qwen2-1.5B, Qwen2.5-14B and Minitron-8B smoke configs, with the
reference's parameters carried across by `convert`. The leaves the
reference initialises to zeros (the QKV bias, the norms) are drawn at
random on both sides, so that each moves the logits. Tolerances:
`_torch_lm_ref` (float32 1e-4; bfloat16 rtol 6e-2 / atol 8e-2 against
the reference's float32 answer, twice it against its bfloat16 run).
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import (TOL, auto_mesh, check, check_tree,
                           drift_at_depth, ref_params, ref_run, to_np)
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch import serve as rserve
from repro.models import layers as rlayers
from repro.models import transformer as rtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import serve
from repro_torch.models import layers as players
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model, count_params

ARCHS = ("qwen2-1.5b", "qwen2.5-14b", "minitron-8b")
# config variants: the smoke config; an attention tile of 4 under a
# 12-token prompt (3 query and 3 KV tiles); the reference's plain
# attention; its prefill triangle skip
VARIANTS = {"smoke": {}, "tiles": {"attn_chunk": 4},
            "plain": {"attn_impl": "plain"},
            "triangle": {"prefill_triangle_skip": True}}
CASES = ([(a, d, "smoke") for a in ARCHS for d in ("float32", "bfloat16")]
         + [("qwen2.5-14b", "float32", "tiles"),
            ("minitron-8b", "float32", "plain"),
            ("qwen2-1.5b", "float32", "triangle")])


def _configs(arch, dtype, variant="smoke"):
    kw = dict(dtype=dtype, remat=False, **VARIANTS[variant])
    return (ref_smoke_config(arch).replace(**kw),
            registry.get_smoke_config(arch).replace(**kw))


def _port(pnp, cfg):
    return convert.decoder_params_to_torch(pnp, cfg, "cpu")


@pytest.mark.parametrize("arch,dtype,variant", CASES)
def test_prefill_and_decode_match_reference(arch, dtype, variant):
    """Prefill logits and K/V cache, then three decode steps' logits and
    the cache after them."""
    rcfg, cfg = _configs(arch, dtype, variant)
    _, pnp = ref_params(rcfg, perturb=True)
    model = build_model(cfg)
    tp = _port(pnp, cfg)
    b, l, cap, steps = 2, 12, 16, 3
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, l + steps))
    ref_same = ref_run(rcfg, pnp, toks, l, cap, steps)
    ref_f32 = ref_run(rcfg.replace(dtype="float32"), pnp, toks, l, cap,
                      steps)
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
    assert lp.shape == ref_same[0].shape and lp.dtype == TF.torch_dtype(cfg)
    assert pfa.flash_attention.plain_calls == (
        0 if variant == "plain" else cfg.n_layers)
    check(to_np(lp), ref_same[0], ref_f32[0], dtype)
    for got, want, want32 in zip(lds, ref_same[1], ref_f32[1]):
        check(got, want, want32, dtype)
    check_tree(c0, ref_same[2], ref_f32[2], dtype)
    check_tree(convert.decoder_cache_to_numpy(cache, cfg), ref_same[3],
               ref_f32[3], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_reference_cache(arch):
    """decode_step alone, float32: the reference's prefill cache carried
    into the port by `decoder_cache_to_torch`, two steps on both sides."""
    rcfg, cfg = _configs(arch, "float32")
    _, pnp = ref_params(rcfg, seed=3, perturb=True)
    b, l, cap = 2, 8, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, l + 2))
    _, _, cache, _ = ref_run(rcfg, pnp, toks, l, cap, 0)
    _, lds, _, after = ref_run(rcfg, pnp, toks, l, cap, 2, cache=cache)
    model, tp = build_model(cfg), _port(pnp, cfg)
    cp = convert.decoder_cache_to_torch(cache, cfg, "cpu")
    with torch.inference_mode():
        for i in range(2):
            ld, cp = model.decode_fn(tp, cp, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            np.testing.assert_allclose(to_np(ld), lds[i], **TOL["float32"])
    check_tree(convert.decoder_cache_to_numpy(cp, cfg), after, after,
               "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """decoder_forward's hidden states and the logits over them."""
    rcfg, cfg = _configs(arch, "float32")
    params, pnp = ref_params(rcfg, seed=1, perturb=True)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 10))
    want, aux = rtf.decoder_forward(params, rcfg, jnp.asarray(toks))
    want_logits = rtf.logits_fn(params, rcfg, want)
    tp = _port(pnp, cfg)
    with torch.inference_mode():
        got, got_aux = TF.decoder_forward(tp, cfg, torch.as_tensor(toks))
        got_logits = TF.logits_fn(tp, cfg, got)
    assert float(aux) == got_aux == 0.0
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL["float32"])
    np.testing.assert_allclose(to_np(got_logits), to_np(want_logits),
                               **TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """`generate` end to end, float32: the same prompt draw and the same
    greedy tokens as the reference's `generate` on an Auto-axis mesh."""
    rcfg, cfg = _configs(arch, "float32")
    params, pnp = ref_params(rcfg, perturb=True)
    want, _ = rserve.generate(rcfg, batch=2, prompt_len=16, gen=6,
                              mesh=auto_mesh(), params=params,
                              log=lambda *a: None)
    got, stats = serve.generate(cfg, batch=2, prompt_len=16, gen=6,
                                device="cpu", params=_port(pnp, cfg),
                                log=lambda *a: None)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_path_matches_forward(dtype):
    """Prefill on 8 tokens and 3 decode steps reproduce the full
    forward's logits at positions 7-10, with a QKV bias and an untied
    head (Qwen2.5-14B's smoke config)."""
    _, cfg = _configs("qwen2.5-14b", dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    for k in ("bq", "bk", "bv"):
        params.layers[0].attn[k].normal_(0.0, 0.1)
    b, l, steps = 2, 8, 4
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, l + steps)))
    v = cfg.vocab
    with torch.inference_mode():
        h, _ = TF.decoder_forward(params, cfg, toks)
        full = TF.logits_fn(params, cfg, h[:, l - 1:])[..., :v]
        lp, cache = model.prefill_fn(params, {"tokens": toks[:, :l]},
                                     l + steps)
        got = [lp[:, 0, :v]]
        for i in range(steps - 1):
            ld, cache = model.decode_fn(params, cache,
                                        toks[:, l + i:l + i + 1], l + i)
            got.append(ld[:, 0, :v])
    for i, g in enumerate(got):
        np.testing.assert_allclose(to_np(g), to_np(full[:, i]),
                                   **TOL[dtype])


# local:global attention, served since Gemma3: a window on the local
# layer of each pair, and a window with global_every 0 (every layer
# global, as the reference's `_window_for` makes it)
_WINDOWED = {"window": {"window": 16, "global_every": 2},
             "window_only": {"window": 16}}


@pytest.mark.parametrize("what", sorted(_WINDOWED))
def test_windowed_configs_serve_against_the_reference(what):
    """The configs that pinned windows as unported now serve: prefill
    logits and cache, then two decode steps, against the reference, from
    a 24-token prompt (longer than the window)."""
    kw = _WINDOWED[what]
    rcfg, cfg = (c.replace(**kw) for c in _configs("qwen2-1.5b", "float32"))
    _, pnp = ref_params(rcfg, perturb=True)
    model, tp = build_model(cfg), _port(pnp, cfg)
    b, l, cap, steps = 2, 24, 28, 2
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (b, l + steps))
    want = ref_run(rcfg, pnp, toks, l, cap, steps)
    with torch.inference_mode():
        lp, cache = model.prefill_fn(tp, {"tokens": torch.as_tensor(
            toks[:, :l])}, cap)
        c0 = convert.decoder_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            lds.append(to_np(ld))
    check(to_np(lp), want[0], want[0], "float32")
    for got, w in zip(lds, want[1]):
        check(got, w, w, "float32")
    check_tree(c0, want[2], want[2], "float32")


# MoE, MLA and multi-token prediction, served since the MoE family: the
# dense smoke config with each (a sub-config as (its class's name, its
# fields), built from each package's `configs/base.py`), and the moe
# family without an MoE config (every layer dense, as the reference
# builds it)
_MOE_MLA_MTP = {
    "moe": {"moe": ("MoEConfig", dict(n_experts=4, top_k=2,
                                      d_ff_expert=32))},
    "mla": {"mla": ("MLAConfig", dict(q_lora_rank=16, kv_lora_rank=8,
                                      qk_nope_head_dim=8, qk_rope_head_dim=8,
                                      v_head_dim=8))},
    "mtp": {"use_mtp": True},
    "family_moe": {"family": "moe"},
}


@pytest.mark.parametrize("what", sorted(_MOE_MLA_MTP))
def test_moe_mla_mtp_configs_serve_against_the_reference(what):
    """The configs that pinned MoE, MLA and MTP as unported now serve:
    prefill logits and cache, then two decode steps, against the
    reference, float32."""
    from repro.configs import base as rbase
    from repro_torch.configs import base as pbase

    def kw(pkg):
        return {k: getattr(pkg, v[0])(**v[1])
                if isinstance(v, tuple) else v
                for k, v in _MOE_MLA_MTP[what].items()}
    rcfg, cfg = _configs("qwen2-1.5b", "float32")
    rcfg, cfg = rcfg.replace(**kw(rbase)), cfg.replace(**kw(pbase))
    _, pnp = ref_params(rcfg, perturb=True)
    model, tp = build_model(cfg), _port(pnp, cfg)
    assert hasattr(tp, "mtp") == cfg.use_mtp
    b, l, cap, steps = 2, 12, 16, 2
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (b, l + steps))
    want = ref_run(rcfg, pnp, toks, l, cap, steps)
    with torch.inference_mode():
        lp, cache = model.prefill_fn(tp, {"tokens": torch.as_tensor(
            toks[:, :l])}, cap)
        c0 = convert.decoder_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            lds.append(to_np(ld))
    check(to_np(lp), want[0], want[0], "float32")
    for got, w in zip(lds, want[1]):
        check(got, w, w, "float32")
    check_tree(c0, want[2], want[2], "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_layout_and_scales(arch):
    rcfg, cfg = _configs(arch, "bfloat16")
    _, pnp = ref_params(rcfg)
    want = _port(pnp, cfg).state_dict()
    params = build_model(cfg).init_params(device="cpu")
    got = params.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
    assert count_params(params) == sum(np.size(x) for x in
                                       jax.tree.leaves(pnp))
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
    assert ("layers.0.attn.bq" in got) == cfg.qkv_bias
    for k in ("layers.1.ln2", "final_norm") + (
            ("layers.0.attn.bk",) if cfg.qkv_bias else ()):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    std = got["embed"].float().std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("what", ["qkv_bias", "decode_window",
                                  "plain_attention"])
def test_layers_match_reference(what):
    """The layers this slice adds or changes, float32: `attn_qkv` with a
    QKV bias, `decode_attention` with a window, `plain_attention` with a
    window and a query offset."""
    rng = np.random.default_rng(5)
    b, l, h, hkv, d, dm = 2, 9, 4, 2, 8, 16

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)
    if what == "qkv_bias":
        p = {"wq": r(dm, h, d), "wk": r(dm, hkv, d), "wv": r(dm, hkv, d),
             "bq": r(h, d), "bk": r(hkv, d), "bv": r(hkv, d)}
        x, pos = r(b, l, dm), np.arange(l)[None]
        want = rlayers.attn_qkv({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jnp.asarray(pos), 1e4)
        got = players.attn_qkv({k: torch.as_tensor(v) for k, v in p.items()},
                               torch.as_tensor(x), torch.as_tensor(pos), 1e4)
    elif what == "decode_window":
        q, kc, vc = r(b, 1, h, d), r(b, l, hkv, d), r(b, l, hkv, d)
        want = [rlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), 7, window=3)]
        got = [players.decode_attention(torch.as_tensor(q),
                                        torch.as_tensor(kc),
                                        torch.as_tensor(vc), 7, window=3)]
    else:
        q, k, v = r(b, 4, h, d), r(b, l, hkv, d), r(b, l, hkv, d)
        want, got = [], []
        for kw in (dict(window=3, q_offset=5), dict(window=0),
                   dict(bidirectional=True)):
            want.append(rlayers.plain_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
            got.append(players.plain_attention(
                torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **TOL["float32"])


def test_bfloat16_drift_at_depth_matches_the_reference():
    """At Qwen2.5-14B's depth, 48 layers (smoke widths), the bfloat16
    forward's logits drift from the float32 answer on the same
    bfloat16-valued parameters by a few percent (relative L2): the
    reference's own run as much as the port's (within 1.25x), while the
    float32 answers agree to 1e-4 (see the SSM file's twin)."""
    rcfg, cfg = (c.replace(n_layers=48)
                 for c in _configs("qwen2.5-14b", "bfloat16"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))

    def forward(model, c, t):
        return TF.decoder_forward(model, c, t)[0]

    def ref_forward(p, rc, t):
        return rtf.decoder_forward(p, rc, t)[0]
    f32, port, ref = drift_at_depth(rcfg, cfg, convert.decoder_params_to_torch,
                                    forward, ref_forward, toks)
    assert f32 < 1e-4 and port <= 1.25 * ref and ref > 0.01, (f32, port,
                                                              ref)


def test_serve_cli_defaults_to_qwen2(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve` with no --arch serves the
    reference's default, qwen2-1.5b."""
    seen = []
    real = serve.generate

    def spy(cfg, **kw):
        seen.append(cfg.name)
        return real(cfg, **kw)
    monkeypatch.setattr(serve, "generate", spy)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--smoke", "--batch", "2", "--prompt-len", "8", "--gen",
        "3", "--device", "cpu"])
    serve.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen == ["qwen2-1.5b"] and out["shape"] == [2, 3]
