"""The port's MoE layer (`models/moe.py`) on the CPU against the
reference's `models/moe.py`: the router (float32 logits, padded experts
masked before the softmax, top-k in order), the capacity arithmetic, the
sorted capacity dispatch with its drops, and `moe_ffn` end to end: flat,
with capacity forced low enough that slots drop, with padded experts,
with the reference's `hierarchical` dispatch under an Auto-axis mesh,
and at decode's one token a request. Also the converters on the MoE
family's parameters: the router stays float32 in a bfloat16 model.

Inputs are drawn with numpy from a seed and fed to both packages; the
parameters are the reference's `init_moe`'s, carried as numpy. Routes
(top-k indices) must be equal; outputs, probabilities and aux losses
within 1e-4 in float32 (the two differ in the order of sums only).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import auto_mesh, to_np
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.distributed.meshctx import mesh_context
from repro.models import moe as rmoe
from repro.models.model import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as pmoe
from repro_torch.models.model import build_model

TOL = dict(rtol=1e-4, atol=1e-4)
D = 32
# MoE configs: the smoke configs' (no padding, flat dispatch); 6 experts
# padded to 8; the same padded and hierarchical (the reference dispatches
# per data shard under a mesh: one shard here); top-4 of 8 with 2 shared
# experts
MOE = {"flat": dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=24),
       "padded": dict(n_experts=6, top_k=2, n_shared=1, d_ff_expert=24,
                      n_experts_padded=8),
       "hierarchical": dict(n_experts=6, top_k=2, n_shared=1,
                            d_ff_expert=24, n_experts_padded=8,
                            dispatch="hierarchical"),
       "top4": dict(n_experts=8, top_k=4, n_shared=2, d_ff_expert=16)}


def _mcfgs(name, **kw):
    kw = dict(MOE[name], **kw)
    return RefMoEConfig(**kw), MoEConfig(**kw)


def _params(rm, seed=0):
    """The reference's `init_moe` parameters (float32) as numpy, and the
    port's `MoEParams` of the same values."""
    p = rmoe.init_moe(jax.random.key(seed), D, rm, jnp.float32)
    pnp = jax.tree.map(to_np, p)
    tp = pmoe.MoEParams({k: {kk: torch.tensor(vv) for kk, vv in v.items()}
                         if isinstance(v, dict) else torch.tensor(v)
                         for k, v in pnp.items()})
    return p, pnp, tp


def _x(b, l, seed=1):
    return np.random.default_rng(seed).normal(size=(b, l, D)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["flat", "padded", "top4"])
def test_router_topk_matches_reference(name):
    """Routes equal, renormalised probabilities and the aux loss within
    1e-4; a padded expert is never chosen."""
    rm, pm = _mcfgs(name)
    logits = np.random.default_rng(3).normal(
        size=(5, 7, rm.e_padded)).astype(np.float32) * 3
    wp, wi, wa = rmoe.router_topk(jnp.asarray(logits), rm)
    gp, gi, ga = pmoe.router_topk(torch.as_tensor(logits), pm)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(float(ga), float(wa), **TOL)
    assert int(gi.max()) < pm.n_experts
    # idx[..., 0] is the most probable expert: probs come in order
    assert bool((gp[..., :-1] >= gp[..., 1:]).all())


@pytest.mark.parametrize("t", [1, 2, 8, 63, 64, 640, 4096, 32768])
def test_capacity_matches_reference(t):
    """The per-call capacity of t tokens for the smoke, padded and both
    full configs' MoE, integer for integer."""
    cfgs = [_mcfgs(n) for n in MOE] + [
        (get(a).moe, pget(a).moe)
        for a in ("qwen2-moe-a2.7b", "deepseek-v3-671b")
        for get, pget in ((ref_config, registry.get_config),
                          (ref_smoke_config, registry.get_smoke_config))]
    for rm, pm in cfgs:
        assert pmoe.capacity(t, pm) == rmoe._capacity(t, rm)
    assert pmoe.capacity(32768, registry.get_config(
        "deepseek-v3-671b").moe) == 1280
    assert pmoe.capacity(32768, registry.get_config(
        "qwen2-moe-a2.7b").moe) == 2560


def test_route_slots_keep_each_experts_first_slots():
    """`route_slots` against a plain loop: expert j's slots in (token,
    choice) order, the first c kept at places 0 .. c - 1, the rest
    dropped (row E x C); `dropped` counts them."""
    rng = np.random.default_rng(4)
    e, k, t, c = 5, 3, 40, 8
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    row, keep = pmoe.route_slots(torch.as_tensor(idx), e, c)
    want_row = np.full(t * k, e * c)
    seen = np.zeros(e, int)
    for s, j in enumerate(idx.reshape(-1)):
        if seen[j] < c:
            want_row[s] = j * c + seen[j]
        seen[j] += 1
    np.testing.assert_array_equal(row.numpy(), want_row)
    np.testing.assert_array_equal(keep.numpy(), want_row < e * c)
    np.testing.assert_array_equal(
        pmoe.dropped(torch.as_tensor(idx), e, c).numpy(),
        np.maximum(seen - c, 0))
    assert int((~keep).sum()) == int(np.maximum(seen - c, 0).sum()) > 0


# (config, x shape, capacity factor): the configs' 1.25 (24 places an
# expert for 64 tokens x 2 choices); 0.5, which gives 8 places where 16
# slots an expert come on average, so many drop; padded experts; the
# hierarchical dispatch, its reference run under an Auto-axis mesh; top-4
# with two shared experts; decode's one token a request (t = B)
FFN_CASES = {"flat": ("flat", (2, 32), 1.25),
             "drops": ("flat", (2, 32), 0.5),
             "padded": ("padded", (2, 32), 1.25),
             "padded_drops": ("padded", (2, 32), 0.5),
             "hierarchical": ("hierarchical", (2, 32), 1.25),
             "hierarchical_drops": ("hierarchical", (2, 32), 0.5),
             "top4": ("top4", (4, 16), 1.25),
             "decode": ("padded", (3, 1), 1.25)}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case):
    """`moe_ffn` output and aux loss within 1e-4 of the reference's, the
    routes equal; at capacity factor 0.5 (8 places an expert), at least a
    tenth of the slots dropped."""
    name, (b, l), cf = FFN_CASES[case]
    rm, pm = _mcfgs(name, capacity_factor=cf)
    p, pnp, tp = _params(rm)
    x = _x(b, l)
    ref = jax.jit(lambda p, x: rmoe.moe_ffn(p, x, rm))
    with (mesh_context(auto_mesh()) if name == "hierarchical" else
          contextlib.nullcontext()):
        want, waux = ref(p, jnp.asarray(x))
    with torch.no_grad():
        got, gaux = pmoe.moe_ffn(tp, torch.as_tensor(x), pm)
    np.testing.assert_allclose(got.numpy(), to_np(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    logits = x.reshape(-1, D) @ pnp["router"]
    _, wi, _ = rmoe.router_topk(jnp.asarray(logits), rm)
    _, gi, _ = pmoe.router_topk(torch.as_tensor(logits), pm)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    c = pmoe.capacity(b * l, pm)
    n_drop = int(pmoe.dropped(gi, pm.e_padded, c).sum())
    if cf < 1:
        assert c == 8 and n_drop >= b * l * pm.top_k // 10, (c, n_drop)


def test_moe_ffn_gradients_match_reference():
    """The gradients of a loss through `moe_ffn` (with drops: capacity
    factor 0.5) as to x and every parameter, router included, against
    `jax.grad`."""
    rm, pm = _mcfgs("padded", capacity_factor=0.5)
    p, pnp, tp = _params(rm)
    x = _x(2, 32)
    w = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def ref_loss(p, x):
        out, aux = rmoe.moe_ffn(p, x, rm)
        return jnp.sum(out * w) + aux

    wgp, wgx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp.requires_grad_(True)
    tx = torch.as_tensor(x).requires_grad_(True)
    out, aux = pmoe.moe_ffn(tp, tx, pm)
    loss = torch.sum(out * torch.as_tensor(w)) + aux
    named = dict(tp.named_parameters())
    grads = torch.autograd.grad(loss, [tx] + list(named.values()))
    np.testing.assert_allclose(grads[0].numpy(), to_np(wgx), **TOL)
    for (name, _), g in zip(named.items(), grads[1:]):
        want = wgp
        for part in name.split("."):
            want = want[part]
        np.testing.assert_allclose(g.numpy(), to_np(want), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_router_stays_float32_in_a_bfloat16_model(arch):
    """In a bfloat16 model every router is float32, whether the port
    initialises it or `convert` carries the reference's tree (its leaves'
    shapes from `jax.eval_shape` of its init, filled with float32 values
    that bfloat16 cannot hold); the other leaves are bfloat16, and the
    round trip back gives the routers exactly, the rest rounded to
    bfloat16."""
    rcfg = ref_smoke_config(arch).replace(dtype="bfloat16")
    cfg = registry.get_smoke_config(arch).replace(dtype="bfloat16")
    rng = np.random.default_rng(0)
    pnp = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jax.eval_shape(ref_build_model(rcfg).init_params, jax.random.key(0)))
    routers = pnp["moe_layers"]["moe"]["router"]
    assert not np.array_equal(routers, to_np(jnp.asarray(routers).astype(
        jnp.bfloat16))), "the router's values need float32"
    for tp in (convert.decoder_params_to_torch(pnp, cfg, "cpu"),
               build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                            "cpu")):
        named = dict(tp.named_parameters())
        for name, t in named.items():
            want = torch.float32 if name.endswith(".router") else \
                torch.bfloat16
            assert t.dtype == want, (name, t.dtype)
        assert sum(n.endswith(".router") for n in named) == \
            cfg.n_layers - cfg.moe.n_dense_layers
    tp = convert.decoder_params_to_torch(pnp, cfg, "cpu")
    np.testing.assert_array_equal(tp.layers[-1].moe.router.numpy(),
                                  routers[-1])
    back = convert.lm_params_to_numpy(dict(tp.named_parameters()), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(pnp)

    def rounded(tree):
        """pnp as the bfloat16 model holds it: the routers exact."""
        return {k: rounded(v) if isinstance(v, dict) else v if k == "router"
                else to_np(jnp.asarray(v).astype(jnp.bfloat16))
                for k, v in tree.items()}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rounded(pnp))):
        np.testing.assert_array_equal(a, b)
