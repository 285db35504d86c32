"""The JAX reference's side of the port's LM serving tests
(`test_torch_serve.py`, `test_torch_dense_serve.py`,
`test_torch_ssm_serve.py`, `test_torch_moe_lm.py`): its parameters and
runs as float32 numpy, and the stated tolerances.

Tolerances: float32 (the algorithm; the port and the reference differ
only in the order of sums and in the chunking of the SSD scan and the
attention) 1e-4. bfloat16 at the reference's own cross-path tolerance,
rtol 6e-2 and atol 8e-2 (`tests/test_consistency.py`), against the
reference's float32 answer on the same bfloat16-valued parameters: the
port and the reference round in different places, and each side's
rounding alone moves a smoke model's logits by about 0.1, so the two
bfloat16 runs are held to twice it of each other (`check`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.models.model import build_model as ref_build_model

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=6e-2, atol=8e-2)}
# the leaves the reference keeps in float32 whatever the model's dtype:
# the Mamba layers' and the MoE router
F32_LEAVES = ("A_log", "dt_bias", "D", "router")


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def auto_mesh():
    """A one-device mesh with Auto axes: the reference's
    `make_host_mesh` makes Explicit axes under JAX 0.9, which its
    `shard_act` refuses."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def ref_params(rcfg, seed=0, perturb=False, jit=False):
    """The reference's parameters for rcfg, and the same as float32 numpy
    (bfloat16-valued where rcfg is bfloat16). With `perturb`, every leaf
    the reference initialises to zeros (norms, biases) is drawn from
    N(0, 0.1^2) instead, rounded to rcfg's dtype, so that each one moves
    the logits; both returns hold the perturbed values. `jit` runs the
    reference's init under `jax.jit` (one compile in place of one an
    operation: faster for the deeper configs)."""
    init = ref_build_model(rcfg).init_params
    params = (jax.jit(init) if jit else init)(jax.random.key(seed))
    pnp = jax.tree.map(to_np, params)
    if perturb:
        rng = np.random.default_rng(seed)
        dt = jnp.dtype(rcfg.dtype)

        def fix(x):
            if np.any(x):
                return x
            x = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
            return to_np(jnp.asarray(x).astype(dt))
        pnp = jax.tree.map(fix, pnp)
        params = cast_params(pnp, dt)
    return params, pnp


def with_f32_leaves(params, pnp):
    def fix(tree, ref):
        return {k: fix(v, ref[k]) if isinstance(v, dict) else
                (jnp.asarray(ref[k], jnp.float32) if k in F32_LEAVES
                 else v) for k, v in tree.items()}
    return fix(params, pnp)


def with_f32_ssm(cache):
    def fix(tree):
        return {k: fix(v) if isinstance(v, dict) else
                (v.astype(jnp.float32) if k == "ssm" else v)
                for k, v in tree.items()}
    return fix(cache)


def cast_params(pnp, dtype):
    """The reference's parameters from float32 numpy, in `dtype` but the
    leaves it keeps in float32."""
    dt = jnp.dtype(dtype)
    return with_f32_leaves(
        jax.tree.map(lambda x: jnp.asarray(x).astype(dt), pnp), pnp)


def drift_at_depth(rcfg, cfg, to_torch, forward, ref_forward, toks):
    """Relative L2 distance of the bfloat16 logits from the reference's
    float32 answer on the same bfloat16-valued parameters: (the port's
    float32, the port's bfloat16, the reference's bfloat16).
    `forward(model, cfg, tokens)` and `ref_forward(params, rcfg, tokens)`
    return final hidden states; `to_torch` is the convert function."""
    from repro.models import transformer as rtf
    from repro_torch.models.transformer import logits_fn
    _, pnp = ref_params(rcfg.replace(dtype="bfloat16"))
    out = {}
    for dt in ("float32", "bfloat16"):
        rc, c = rcfg.replace(dtype=dt), cfg.replace(dtype=dt)
        p = cast_params(pnp, dt)
        want = to_np(rtf.logits_fn(p, rc, ref_forward(p, rc,
                                                      jnp.asarray(toks))))
        tp = to_torch(pnp, c, "cpu")
        with torch.inference_mode():
            got = to_np(logits_fn(tp, c, forward(tp, c,
                                                 torch.as_tensor(toks))))
        out[dt] = (want, got)
    base = out["float32"][0]

    def rel(a):
        return float(np.linalg.norm(a - base) / np.linalg.norm(base))
    return (rel(out["float32"][1]), rel(out["bfloat16"][1]),
            rel(out["bfloat16"][0]))


def ref_run(rcfg, pnp, toks, l, cap, steps, cache=None, jit=False):
    """The reference's prefill on toks[:, :l] (or `cache`, in the
    reference's layout as numpy) and `steps` decode steps after it, with
    the parameters `pnp` (numpy) cast to rcfg's dtype. Returns the
    prefill logits, each decode step's logits and the caches after
    prefill and after the last step, as float32 numpy. `jit` runs the
    prefill and the decode step under `jax.jit`."""
    rm = ref_build_model(rcfg)
    dt = jnp.dtype(rcfg.dtype)
    params = cast_params(pnp, dt)
    prefill_fn, decode_fn = rm.prefill_fn, rm.decode_fn
    if jit:
        prefill_fn = jax.jit(prefill_fn, static_argnums=2)
        decode_fn = jax.jit(decode_fn)
    lp = None
    if cache is None:
        lp, cache = prefill_fn(params, {"tokens": jnp.asarray(
            toks[:, :l], jnp.int32)}, cap)
        lp = to_np(lp)
    else:
        cache = jax.tree.map(lambda x: jnp.asarray(x).astype(dt), cache)
        cache = with_f32_ssm(cache)
    cache0 = jax.tree.map(to_np, cache)
    lds = []
    for i in range(steps):
        pos = l + i
        ld, cache = decode_fn(params, cache, jnp.asarray(
            toks[:, pos:pos + 1], jnp.int32), jnp.int32(pos))
        lds.append(to_np(ld))
    return lp, lds, cache0, jax.tree.map(to_np, cache)


def check(port, ref_same, ref_f32, dtype):
    """float32: the port against the reference, tight. bfloat16: the
    port against the reference's float32 answer on the same
    (bfloat16-valued) parameters, at the reference's tolerance; and
    against the reference's own bfloat16 run, which rounds in other
    places, at twice it (each side within the tolerance of the float32
    answer puts them within twice it of each other)."""
    if dtype == "float32":
        np.testing.assert_allclose(port, ref_same, **TOL[dtype])
        return
    tol = TOL[dtype]
    np.testing.assert_allclose(port, ref_f32, **tol)
    np.testing.assert_allclose(port, ref_same, rtol=2 * tol["rtol"],
                               atol=2 * tol["atol"])


def check_tree(port, ref_same, ref_f32, dtype):
    for k in ref_same:
        if isinstance(ref_same[k], dict):
            check_tree(port[k], ref_same[k], ref_f32[k], dtype)
        else:
            check(port[k], ref_same[k], ref_f32[k], dtype)
