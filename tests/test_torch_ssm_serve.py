"""The port's Mamba2 LM serving path (`models/ssm.py`, `models/model.py`,
`launch/serve.py`) against the reference on the Mamba2-1.3B smoke
config (3 layers, SSD chunk 32, tied embedding), with the reference's
parameters carried across by `convert`; the prompts span two chunks.
The leaves the reference initialises to zeros (norms, conv biases,
dt_bias) are drawn at random on both sides. Tolerances: `_torch_lm_ref`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import (TOL, auto_mesh, cast_params, check, check_tree,
                           drift_at_depth, ref_params, ref_run, to_np)
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch import serve as rserve
from repro.models import ssm as rssm
from repro.models import transformer as rtf
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ssd_scan as pss
from repro_torch.launch import serve
from repro_torch.models import ssm as SM
from repro_torch.models.model import build_model, count_params
from repro_torch.models.transformer import logits_fn, torch_dtype

ARCH = "mamba2-1.3b"


def _configs(dtype):
    kw = dict(dtype=dtype, remat=False)
    return (ref_smoke_config(ARCH).replace(**kw),
            registry.get_smoke_config(ARCH).replace(**kw))


def _port(pnp, cfg):
    return convert.ssm_params_to_torch(pnp, cfg, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill over two chunks (logits, each layer's SSM state and conv
    windows), then three decode steps' logits and the state after."""
    rcfg, cfg = _configs(dtype)
    _, pnp = ref_params(rcfg, perturb=True)
    model = build_model(cfg)
    tp = _port(pnp, cfg)
    b, l, cap, steps = 2, 2 * cfg.ssm.chunk, 2 * cfg.ssm.chunk + 4, 3
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, l + steps))
    ref_same = ref_run(rcfg, pnp, toks, l, cap, steps)
    ref_f32 = ref_run(rcfg.replace(dtype="float32"), pnp, toks, l, cap,
                      steps)
    pss.reset_counts()
    with torch.inference_mode():
        lp, cache = model.prefill_fn(tp, {"tokens": torch.as_tensor(
            toks[:, :l])}, cap)
        c0 = convert.ssm_cache_to_numpy(cache, cfg)
        lds = []
        for i in range(steps):
            ld, cache = model.decode_fn(tp, cache, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            lds.append(to_np(ld))
    assert lp.shape == ref_same[0].shape and lp.dtype == torch_dtype(cfg)
    assert cache["ssm"].dtype == torch.float32
    assert pss.ssd_scan.plain_calls == cfg.n_layers
    check(to_np(lp), ref_same[0], ref_f32[0], dtype)
    for got, want, want32 in zip(lds, ref_same[1], ref_f32[1]):
        check(got, want, want32, dtype)
    check_tree(c0, ref_same[2], ref_f32[2], dtype)
    check_tree(convert.ssm_cache_to_numpy(cache, cfg), ref_same[3],
               ref_f32[3], dtype)


def test_decode_from_the_reference_state():
    """ssm_decode_step alone, float32: the reference's prefill state
    carried into the port by `ssm_cache_to_torch`, two steps."""
    rcfg, cfg = _configs("float32")
    _, pnp = ref_params(rcfg, seed=3, perturb=True)
    b, l = 2, cfg.ssm.chunk
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, l + 2))
    _, _, cache, _ = ref_run(rcfg, pnp, toks, l, l + 2, 0)
    _, lds, _, after = ref_run(rcfg, pnp, toks, l, l + 2, 2, cache=cache)
    model, tp = build_model(cfg), _port(pnp, cfg)
    cp = convert.ssm_cache_to_torch(cache, cfg, "cpu")
    with torch.inference_mode():
        for i in range(2):
            ld, cp = model.decode_fn(tp, cp, torch.as_tensor(
                toks[:, l + i:l + i + 1]), l + i)
            np.testing.assert_allclose(to_np(ld), lds[i], **TOL["float32"])
    check_tree(convert.ssm_cache_to_numpy(cp, cfg), after, after, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    """ssm_forward's hidden states and the tied-embedding logits over
    them, against the reference's float32 answer on the same
    parameters (bfloat16: at the stated tolerance)."""
    rcfg, cfg = _configs(dtype)
    _, pnp = ref_params(rcfg, seed=1, perturb=True)
    r32 = rcfg.replace(dtype="float32")
    params32 = cast_params(pnp, "float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64))
    want = rssm.ssm_forward(params32, r32, jnp.asarray(toks))
    want_logits = rtf.logits_fn(params32, r32, want)
    tp = _port(pnp, cfg)
    with torch.inference_mode():
        got = SM.ssm_forward(tp, cfg, torch.as_tensor(toks))
        got_logits = logits_fn(tp, cfg, got)
    np.testing.assert_allclose(to_np(got_logits), to_np(want_logits),
                               **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])


def test_generate_matches_reference():
    """`generate` end to end, float32, a prompt of two chunks: the same
    greedy tokens as the reference's `generate` on an Auto-axis mesh."""
    rcfg, cfg = _configs("float32")
    params, pnp = ref_params(rcfg, perturb=True)
    want, _ = rserve.generate(rcfg, batch=2, prompt_len=64, gen=6,
                              mesh=auto_mesh(), params=params,
                              log=lambda *a: None)
    got, _ = serve.generate(cfg, batch=2, prompt_len=64, gen=6,
                            device="cpu", params=_port(pnp, cfg),
                            log=lambda *a: None)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_path_matches_forward(dtype):
    """Prefill on 64 tokens and 3 decode steps reproduce the full
    forward's logits at positions 63-66. The forward runs over 96
    tokens (a whole number of chunks); the tokens after those positions
    do not reach them."""
    _, cfg = _configs(dtype)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    b, l, steps = 2, 64, 4
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, 96)))
    v = cfg.vocab
    with torch.inference_mode():
        h = SM.ssm_forward(params, cfg, toks)
        full = logits_fn(params, cfg, h[:, l - 1:l + steps - 1])[..., :v]
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


def test_prefill_runs_the_scan_once_per_layer():
    """On the CPU the wrapper takes its plain version: one SSD scan per
    layer in prefill, none in decode, and no attention at all."""
    _, cfg = _configs("float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(1), "cpu")
    pss.reset_counts()
    pfa.reset_counts()
    toks = torch.zeros((1, 32), dtype=torch.int64)
    with torch.inference_mode():
        _, cache = model.prefill_fn(params, {"tokens": toks}, 40)
        assert pss.ssd_scan.plain_calls == cfg.n_layers
        model.decode_fn(params, cache, toks[:, :1], 32)
    assert (pss.ssd_scan.plain_calls, pss.ssd_scan.launches,
            pfa.flash_attention.plain_calls) == (cfg.n_layers, 0, 0)


def test_init_has_the_reference_layout():
    rcfg, cfg = _configs("bfloat16")
    _, pnp = ref_params(rcfg)
    want = _port(pnp, cfg).state_dict()
    params = build_model(cfg).init_params(device="cpu")
    got = params.state_dict()
    assert list(got) == list(want) and "lm_head" not in got
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
    assert count_params(params) == sum(np.size(x)
                                       for x in jax.tree.leaves(pnp))
    torch.testing.assert_close(got["layers.2.mamba.D"],
                               want["layers.2.mamba.D"], rtol=0, atol=0)
    cache = build_model(cfg).init_cache(3, 999, "cpu")
    st = convert.ssm_cache_to_numpy(cache, cfg)["states"]
    ref = rssm.ssm_init_cache(rcfg, 3, 999)["states"]
    assert {k: v.shape for k, v in st.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def test_bfloat16_drift_at_depth_matches_the_reference():
    """At Mamba2-1.3B's depth, 48 layers (smoke widths), the bfloat16
    forward's logits drift from the float32 answer on the same
    bfloat16-valued parameters by several percent (relative L2), far
    past the smoke configs' elementwise tolerance: the reference's own
    run as much as the port's (within 1.25x), while the float32 answers
    agree to 1e-4. This is why `chip_smoke.py` holds the full models'
    bfloat16 cache path by its drift against the float32 forward."""
    rcfg, cfg = (c.replace(n_layers=48) for c in _configs("bfloat16"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64))
    f32, port, ref = drift_at_depth(rcfg, cfg, convert.ssm_params_to_torch,
                                    SM.ssm_forward, rssm.ssm_forward, toks)
    assert f32 < 1e-4 and port <= 1.25 * ref and ref > 0.02, (f32, port,
                                                              ref)
