"""The port's hybrid serving path (`models/hybrid.py`, `models/model.py`,
`launch/serve.py`) against the reference on the Zamba2 smoke config,
with the reference's parameters carried across by `convert`.

Tolerances (`_torch_lm_ref`): float32 (the algorithm; the port and the
reference differ only in the order of sums and in the chunking of the
SSD scan and the attention) 1e-4. bfloat16 at the reference's own
cross-path tolerance, rtol 6e-2 and atol 8e-2 (`tests/test_consistency.py`),
against the reference's float32 answer on the same bfloat16-valued
parameters: the port and the reference round in different places, and
each side's rounding alone moves the smoke model's logits by about 0.1
(the reference's own bfloat16 run breaks that tolerance against its
float32 answer at one of 512 logits), so the two bfloat16 runs are held
to twice it of each other.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_lm_ref import (TOL, auto_mesh, check as _check,
                           check_tree as _check_tree,
                           ref_params as _ref_params, ref_run as _ref_run,
                           to_np as _np)
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.launch import serve as rserve
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ssd_scan as pss
from repro_torch.launch import serve
from repro_torch.models import hybrid as HY
from repro_torch.models.model import build_model, count_params
from repro_torch.models.transformer import logits_fn

_ROOT = pathlib.Path(__file__).resolve().parent.parent
# the smoke config (9 layers: 3 groups of 3, no tail) and one with a
# one-layer Mamba tail after its groups, as the full model's 81 = 13 x 6
# + 3
CONFIGS = {"smoke": {}, "tail": {"n_layers": 10}}


def _configs(dtype, which):
    kw = dict(dtype=dtype, remat=False, **CONFIGS[which])
    return (ref_smoke_config("zamba2-7b").replace(**kw),
            registry.get_smoke_config("zamba2-7b").replace(**kw))


@pytest.mark.parametrize("which", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, which):
    rcfg, cfg = _configs(dtype, which)
    _, pnp = _ref_params(rcfg)
    model = build_model(cfg)
    tp = convert.hybrid_params_to_torch(pnp, cfg, "cpu")
    b, l, cap = 2, 11, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, l + 1))
    ref_same = _ref_run(rcfg, pnp, toks, l, cap, 1)
    ref_f32 = _ref_run(rcfg.replace(dtype="float32"), pnp, toks, l, cap, 1)
    with torch.inference_mode():
        lp, cp = model.prefill_fn(tp, {"tokens": torch.as_tensor(
            toks[:, :l])}, cap)
        cp_np = convert.hybrid_cache_to_numpy(cp, cfg)
        ldp, cp2 = model.decode_fn(tp, cp, torch.as_tensor(toks[:, l:]), l)
    assert lp.shape == ref_same[0].shape and lp.dtype == HY.torch_dtype(cfg)
    _check(_np(lp), ref_same[0], ref_f32[0], dtype)
    _check(_np(ldp), ref_same[1][0], ref_f32[1][0], dtype)
    _check_tree(cp_np, ref_same[2], ref_f32[2], dtype)
    _check_tree(convert.hybrid_cache_to_numpy(cp2, cfg), ref_same[3],
                ref_f32[3], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_from_the_reference_cache(dtype):
    """hybrid_decode_step alone: the reference's prefill cache carried
    into the port, three decode steps on both sides."""
    rcfg, cfg = _configs(dtype, "tail")
    _, pnp = _ref_params(rcfg, seed=3)
    model = build_model(cfg)
    tp = convert.hybrid_params_to_torch(pnp, cfg, "cpu")
    b, l, cap = 2, 8, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, l + 3))
    _, _, cache, _ = _ref_run(rcfg, pnp, toks, l, cap, 0)
    ref_same = _ref_run(rcfg, pnp, toks, l, cap, 3, cache=cache)
    ref_f32 = _ref_run(rcfg.replace(dtype="float32"), pnp, toks, l, cap, 3,
                       cache=cache)
    cp = convert.hybrid_cache_to_torch(cache, cfg, "cpu")
    for i in range(3):
        pos = l + i
        with torch.inference_mode():
            ldp, cp = model.decode_fn(tp, cp, torch.as_tensor(
                toks[:, pos:pos + 1]), pos)
        _check(_np(ldp), ref_same[1][i], ref_f32[1][i], dtype)
    _check_tree(convert.hybrid_cache_to_numpy(cp, cfg), ref_same[3],
                ref_f32[3], dtype)


def test_generate_matches_reference():
    """`generate` end to end, float32: the same prompt draw and the same
    greedy tokens as the reference's `generate` (on a one-device mesh
    with Auto axes: the reference's `make_host_mesh` makes Explicit axes
    under JAX 0.9, which its `shard_act` refuses)."""
    rcfg, cfg = _configs("float32", "smoke")
    params, pnp = _ref_params(rcfg)
    want, _ = rserve.generate(rcfg, batch=2, prompt_len=32, gen=6,
                              mesh=auto_mesh(),
                              params=params, log=lambda *a: None)
    got, stats = serve.generate(
        cfg, batch=2, prompt_len=32, gen=6, device="cpu",
        params=convert.hybrid_params_to_torch(pnp, cfg, "cpu"),
        log=lambda *a: None)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_teacher_forcing(dtype):
    """`test_consistency.py`'s check on the port: prefill on l - 1
    tokens then decode token l - 1 reproduce the full forward's logits
    at l - 2 and l - 1."""
    _, cfg = _configs(dtype, "tail")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    b, l = 2, 12
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, l)))
    with torch.inference_mode():
        full = logits_fn(params, cfg, HY.hybrid_forward(params, cfg, toks))
        lp, cache = model.prefill_fn(params, {"tokens": toks[:, :l - 1]},
                                     l + 4)
        ld, _ = model.decode_fn(params, cache, toks[:, l - 1:l], l - 1)
    v = cfg.vocab
    tol = dict(rtol=6e-2, atol=8e-2)
    np.testing.assert_allclose(_np(lp[:, 0, :v]), _np(full[:, l - 2, :v]),
                               **tol)
    np.testing.assert_allclose(_np(ld[:, 0, :v]), _np(full[:, l - 1, :v]),
                               **tol)


def test_prefill_runs_every_kernel_once_per_layer():
    """On the CPU the wrappers take their plain versions: one SSD scan
    per Mamba layer and one attention per shared-block invocation in
    prefill, none in decode."""
    _, cfg = _configs("float32", "tail")
    period, n_groups, _ = HY.split_counts(cfg)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(1), "cpu")
    pfa.reset_counts()
    pss.reset_counts()
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with torch.inference_mode():
        _, cache = model.prefill_fn(params, {"tokens": toks}, 10)
        counts = (pss.ssd_scan.plain_calls, pfa.flash_attention.plain_calls)
        model.decode_fn(params, cache, toks[:, :1], 8)
    assert counts == (cfg.n_layers, n_groups)
    assert (pss.ssd_scan.plain_calls, pfa.flash_attention.plain_calls,
            pss.ssd_scan.launches, pfa.flash_attention.launches) == (
        cfg.n_layers, n_groups, 0, 0)


def test_init_has_the_reference_layout_and_scales():
    rcfg, cfg = _configs("bfloat16", "tail")
    _, pnp = _ref_params(rcfg)
    want = convert.hybrid_params_to_torch(pnp, cfg, "cpu").state_dict()
    params = build_model(cfg).init_params(device="cpu")
    got = params.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape,
                                                want[k].dtype), k
    assert count_params(params) == sum(np.size(x) for x in
                                       jax.tree.leaves(pnp))
    for k in ("mamba.0.mamba.D", "shared.1.ln2"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # log(linspace(1, 16, H)): torch's and XLA's linspace round apart
    torch.testing.assert_close(got["mamba.0.mamba.A_log"],
                               want["mamba.0.mamba.A_log"], rtol=3e-7,
                               atol=0)
    std = got["mamba.0.mamba.wx"].float().std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05


def test_unported_archs_and_families_raise():
    """Every family of the reference is ported now: the VLM and audio
    archs resolve and their families build; an unknown id raises
    KeyError; the dense and SSM archs resolve."""
    assert registry.get_config("llava-next-34b").family == "vlm"
    assert registry.get_smoke_config("whisper-tiny").family == "audio"
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")
    cfg = registry.get_smoke_config("zamba2-7b")
    assert build_model(cfg.replace(family="vlm")).cfg.family == "vlm"
    assert registry.get_config("zamba2-7b").n_layers == 81
    assert registry.get_config("qwen2-1.5b").family == "dense"
    assert registry.get_smoke_config("mamba2-1.3b").family == "ssm"


def test_serve_cli_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-7b", "--smoke", "--batch", "2", "--prompt-len", "8",
         "--gen", "3", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 3]
