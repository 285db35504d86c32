"""The port's multi-head latent attention (`models/mla.py`) on the CPU
against the reference's `models/mla.py`, at the DeepSeek-V3 smoke
config's widths (q·k 16 + 8, v 16, latent 16): the prefill forward (V
zero-padded to the q·k width through the flash attention's plain
version) at one and at two attention tiles, its gradients, the latents
the cache keeps, and absorbed decode steps writing the cache in place;
then the converters' cache layouts for both MoE configs (MLA's latents
and Qwen2-MoE's K/V).

Inputs and the norms (which the reference initialises to zeros) are
drawn with numpy from a seed; the other parameters are the reference's
`init_mla`'s. float32, within 1e-4 (the two differ in the order of
sums and the attention's chunking only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import to_np
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models import mla as rmla
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as pfa
from repro_torch.models import mla as pmla
from repro_torch.models.model import build_model

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-v3-671b"
THETA = 10000.0


def _setup(seed=0):
    rcfg = ref_smoke_config(ARCH)
    m, d, h = rcfg.mla, rcfg.d_model, rcfg.n_heads
    p = rmla.init_mla(jax.random.key(seed), d, h, m, jnp.float32)
    rng = np.random.default_rng(seed)
    pnp = {k: (rng.normal(0.0, 0.1, v.shape).astype(np.float32)
               if k.endswith("_norm") else to_np(v)) for k, v in p.items()}
    return (registry.get_smoke_config(ARCH).mla, m, d,
            {k: jnp.asarray(v) for k, v in pnp.items()},
            {k: torch.tensor(v) for k, v in pnp.items()})


def _x(b, l, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, l, d)).astype(
        np.float32)


@pytest.mark.parametrize("chunk", [8, 1024])
def test_mla_forward_matches_reference(chunk):
    """The prefill forward of 16 positions at a tile of 8 (two query and
    two KV tiles) and of 16 (one): q and k of width 24, V padded from 16;
    one flash call, its plain version here."""
    pm, m, d, p, tp = _setup()
    x = _x(2, 16, d)
    want = jax.jit(lambda p, x: rmla.mla_forward(p, x, m, THETA,
                                                 chunk=chunk))(
        p, jnp.asarray(x))
    pfa.reset_counts()
    with torch.no_grad():
        got, _ = pmla.mla_forward(tp, torch.as_tensor(x), pm, THETA,
                                  chunk=chunk)
    assert pfa.flash_attention.plain_calls == 1
    np.testing.assert_allclose(got.numpy(), to_np(want), **TOL)


def test_mla_forward_gradients_match_reference():
    """d/dx and every parameter's gradient of a weighted sum of the
    forward (two tiles) against `jax.grad`: the flash backward's plain
    version at the q·k width, through the padded V."""
    pm, m, d, p, tp = _setup()
    x = _x(2, 16, d)
    w = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    wgp, wgx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(rmla.mla_forward(p, x, m, THETA, chunk=8) * w),
        argnums=(0, 1)))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.as_tensor(x).requires_grad_(True)
    out, _ = pmla.mla_forward(tp, tx, pm, THETA, chunk=8)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(w)),
                                [tx] + list(tp.values()))
    np.testing.assert_allclose(grads[0].numpy(), to_np(wgx), **TOL)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), to_np(wgp[k]), err_msg=k,
                                   **TOL)


def test_mla_prefill_latents_match_the_reference_cache():
    """The latents of a 12-token prompt, as `mla_prefill_latents` and
    `mla_forward` return them, placed in a zero cache of 20 positions,
    against the reference's `mla_prefill_cache`."""
    pm, m, d, p, tp = _setup()
    x = _x(3, 12, d)
    want = rmla.mla_prefill_cache(p, jnp.asarray(x), m, THETA, 20)
    cache = pmla.mla_init_cache(1, 3, 20, pm, torch.float32, "cpu")
    with torch.no_grad():
        lat = pmla.mla_prefill_latents(tp, torch.as_tensor(x), pm, THETA)
        _, lat_fwd = pmla.mla_forward(tp, torch.as_tensor(x), pm, THETA)
    for name, v, v_fwd in zip(("c_kv", "k_rope"), lat, lat_fwd):
        torch.testing.assert_close(v_fwd, v, rtol=0, atol=0)
        cache[name][0, :, :12] = v
    assert cache["c_kv"].shape == (1, 3, 20, m.kv_lora_rank)
    assert cache["k_rope"].shape == (1, 3, 20, m.qk_rope_head_dim)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[name][0].numpy(),
                                   to_np(want[name]), **TOL)


def test_mla_decode_steps_match_reference():
    """Four absorbed decode steps after a 12-token prefill: each step's
    output and the cache it wrote (in place on the port's side) against
    the reference's `mla_decode_step`."""
    pm, m, d, p, tp = _setup()
    b, l, cap = 2, 12, 16
    x = _x(b, cap, d, seed=3)
    rcache = rmla.mla_prefill_cache(p, jnp.asarray(x[:, :l]), m, THETA, cap)
    cache = {k: torch.tensor(to_np(v)) for k, v in rcache.items()}
    views = dict(cache)
    step = jax.jit(lambda p, x, c, pos: rmla.mla_decode_step(p, x, c, pos, m,
                                                            THETA))
    for pos in range(l, cap):
        want, rcache = step(p, jnp.asarray(x[:, pos:pos + 1]), rcache,
                            jnp.int32(pos))
        with torch.no_grad():
            got, cache = pmla.mla_decode_step(
                tp, torch.as_tensor(x[:, pos:pos + 1]), cache, pos, pm, THETA)
        np.testing.assert_allclose(got.numpy(), to_np(want), **TOL)
        for k in cache:
            assert cache[k] is views[k]           # written in place
            np.testing.assert_allclose(cache[k].numpy(), to_np(rcache[k]),
                                       **TOL)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen2-moe-a2.7b"])
def test_cache_converters_map_the_reference_layout(arch):
    """The port's one stack a cache leaf against the reference's
    {"dense", "moe"} groups: DeepSeek-V3's latents (1 dense, 3 MoE
    layers), Qwen2-MoE's K/V (no dense layer); the port's layer i is
    dense[i] then moe[i - n_dense], and the round trip is exact."""
    cfg = registry.get_smoke_config(arch).replace(dtype="float32")
    cache = build_model(cfg).init_cache(2, 8, "cpu")
    rng = np.random.default_rng(5)
    for v in cache.values():
        v.copy_(torch.as_tensor(rng.normal(size=v.shape)))
    ref = convert.decoder_cache_to_numpy(cache, cfg)
    n_dense = cfg.moe.n_dense_layers
    keys = ("c_kv", "k_rope") if cfg.mla else ("k", "v")
    assert set(ref) == ({"dense", "moe"} if n_dense else {"moe"})
    for k in keys:
        assert cache[k].shape[0] == cfg.n_layers
        if n_dense:
            np.testing.assert_array_equal(ref["dense"][k],
                                          cache[k][:n_dense].numpy())
        np.testing.assert_array_equal(ref["moe"][k][-1],
                                      cache[k][-1].numpy())
    back = convert.decoder_cache_to_torch(ref, cfg, "cpu")
    for k in keys:
        torch.testing.assert_close(back[k], cache[k], rtol=0, atol=0)
