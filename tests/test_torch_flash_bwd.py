"""The backward of the port's flash attention on the CPU: its plain
version `flash_attention_bwd_plain` (the formula the `flash_attention_bwd`
kernel is held to on the card) and the `FlashAttention` autograd Function
through `flash_attention` and `ops.gqa_flash_attention`.

Witnesses: torch.autograd through `flash_attention_plain` (the forward
the kernel computes, its key bound included), and `jax.vjp` of the
reference's `kernels/ref.py::attention_ref`, whose plain causal mask is
the forward's function wherever the bound keeps every key below the
diagonal: tq = tk, and tq a multiple of tk. With tq < tk the bound drops
keys below the diagonal, and only autograd through the forward witnesses.
The reference's Pallas kernel has no VJP rule. Tolerance: float32 1e-4
(the sums run in another order); the forward's log-sum-exp 1e-5.

The bfloat16 kernels' rounding model
(`_torch_flash_wgmma.flash_bwd_wgmma_emulation`, the blocks and sum
order of `flash_bwd_dq_wgmma` and `flash_bwd_dkdv_wgmma` at every head
dim): S and dP from the bfloat16 inputs with float32 sums; P =
exp2(S scale log2 e - lse log2 e) in float32, 0 outside each row's key
limits; P and dS = P (dP - D) rounded to bfloat16 before P^T dO, dS k
and dS^T q; the scale applied to the float32 dQ and dK. It is held to
`flash_attention_bwd_plain` within the card's bfloat16 tolerance,
1e-2 x max(1, largest |gradient|) (`chip_smoke.py`'s `LM_TOL`), which
shows on the CPU that the tolerance admits the kernels' two roundings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_wgmma import flash_bwd_wgmma_emulation
from _torch_parity import one_torch_thread  # noqa: F401
from repro.kernels import ref as rref
from repro.models import layers as rlayers
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops

TOL = dict(rtol=1e-4, atol=1e-4)
# (BH, L, D, tq, tk)
SHAPES = [(3, 16, 8, 16, 16), (2, 24, 12, 8, 8), (2, 24, 8, 8, 4),
          (2, 24, 8, 12, 4), (2, 24, 8, 4, 8), (2, 24, 8, 4, 12)]


def _inputs(bh, l, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, l, d)).astype(np.float32)
            for _ in range(4)]


def _t(x, grad=False):
    return torch.from_numpy(x.copy()).requires_grad_(grad)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_equals_autograd_of_the_forward(shape, causal):
    bh, l, d, tq, tk = shape
    q, k, v, do = _inputs(bh, l, d)
    tq_, tk_, tv = _t(q, True), _t(k, True), _t(v, True)
    o, lse = pfa.flash_attention_plain(tq_, tk_, tv, causal=causal, tq=tq,
                                       tk=tk, return_lse=True)
    want = torch.autograd.grad(o, (tq_, tk_, tv), _t(do))
    o, lse = o.detach(), lse.detach()
    got = pfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, _t(do), lse,
                                        causal=causal, tq=tq, tk=tk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    # the log-sum-exp is the scaled scores' over each row's keys
    s = (q @ k.transpose(0, 2, 1)) * d ** -0.5
    keep = np.ones((l, l), bool)
    if causal:
        qp = np.arange(l)[:, None]
        up = np.minimum(np.maximum((qp // tq + 1) * tq // tk, 1), l // tk)
        keep = np.arange(l)[None, :] < np.minimum(qp + 1, up * tk)
    want_lse = np.log(np.sum(np.where(keep, np.exp(s), 0.0), -1))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[3] % s[4] == 0])
def test_bwd_plain_equals_jax_vjp_of_attention_ref(shape, causal):
    bh, l, d, tq, tk = shape
    q, k, v, do = _inputs(bh, l, d, seed=1)
    o_ref, vjp = jax.vjp(lambda q, k, v: rref.attention_ref(
        q[None], k[None], v[None], causal=causal)[0], *map(jnp.asarray,
                                                           (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, lse = pfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                       tq=tq, tk=tk, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    got = pfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, _t(do), lse,
                                        causal=causal, tq=tq, tk=tk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_runs_the_plain_backward(causal):
    """On the CPU `flash_attention` with inputs that need a gradient goes
    through `FlashAttention`: the plain forward, then the plain backward,
    one call each; without a gradient it stays the serving forward."""
    bh, l, d, tq, tk = 2, 24, 8, 4, 8
    q, k, v, do = _inputs(bh, l, d, seed=2)
    pfa.reset_counts()
    tq_, tk_, tv = _t(q, True), _t(k, True), _t(v, True)
    o = pfa.flash_attention(tq_, tk_, tv, causal=causal, tq=tq, tk=tk,
                            device="cpu")
    got = torch.autograd.grad(o, (tq_, tk_, tv), _t(do))
    assert (pfa.flash_attention.plain_calls,
            pfa.flash_attention.bwd_plain_calls) == (1, 1)
    assert (pfa.flash_attention.launches,
            pfa.flash_attention.bwd_launches) == (0, 0)
    x = [_t(a, True) for a in (q, k, v)]
    want = torch.autograd.grad(pfa.flash_attention_plain(
        *x, causal=causal, tq=tq, tk=tk), x, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    with torch.no_grad():
        o2 = pfa.flash_attention(tq_, tk_, tv, causal=causal, tq=tq, tk=tk,
                                 device="cpu")
    assert o2.grad_fn is None and torch.equal(o2, o.detach())
    assert pfa.flash_attention.bwd_plain_calls == 1


def test_gqa_backward_sums_the_group():
    """`ops.gqa_flash_attention` repeats K and V outside the Function, so
    autograd sums their gradients over each group: equal to autograd
    through the reference layout's plain attention."""
    from repro_torch.models import layers as players
    rng = np.random.default_rng(3)
    b, l, h, hkv, d = 2, 16, 6, 2, 8
    q, do = (rng.normal(size=(b, l, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, l, hkv, d)).astype(np.float32)
            for _ in range(2))
    xs = [_t(a, True) for a in (q, k, v)]
    got = torch.autograd.grad(ops.gqa_flash_attention(
        *xs, causal=True, tq=8, tk=8, device="cpu"), xs, _t(do))
    ys = [_t(a, True) for a in (q, k, v)]
    want = torch.autograd.grad(players.plain_attention(*ys, causal=True),
                               ys, _t(do))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


# (window, tile): windows below, at and above the tile, and window % tile
# > 1, where the reference's tile bound drops keys inside the window
WINDOWS = [(5, 4), (8, 8), (12, 8), (16, 8), (20, 4)]


@pytest.mark.parametrize("window,t", WINDOWS)
def test_windowed_bwd_plain_equals_autograd_of_the_forward(window, t):
    q, k, v, do = _inputs(2, 24, 8, seed=4)
    x = [_t(a, True) for a in (q, k, v)]
    o, lse = pfa.flash_attention_plain(*x, tq=t, tk=t, window=window,
                                       return_lse=True)
    want = torch.autograd.grad(o, x, _t(do))
    got = pfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o.detach(),
                                        _t(do), lse.detach(), tq=t, tk=t,
                                        window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("window,t", WINDOWS)
def test_windowed_bwd_plain_equals_jax_vjp_of_chunked_attention(window, t):
    """The reference trains local layers through its windowed
    `chunked_attention` and autodiff: the plain backward under the window
    and the reference's tile bound is its VJP."""
    q, k, v, do = _inputs(2, 24, 8, seed=5)

    def ref(q, k, v):      # (BH, L, D) as (1, L, BH, D): one KV head each
        return rlayers.chunked_attention(
            *(x.transpose(1, 0, 2)[None] for x in (q, k, v)), causal=True,
            window=window, chunk=t)[0].transpose(1, 0, 2)
    o_ref, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, lse = pfa.flash_attention_plain(_t(q), _t(k), _t(v), tq=t, tk=t,
                                       window=window, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    got = pfa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, _t(do), lse,
                                        tq=t, tk=t, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_windowed_function_runs_the_plain_backward():
    """`flash_attention` with a window and inputs that need a gradient:
    the plain forward and backward on the CPU, one call each."""
    q, k, v, do = _inputs(2, 24, 8, seed=6)
    pfa.reset_counts()
    x = [_t(a, True) for a in (q, k, v)]
    got = torch.autograd.grad(pfa.flash_attention(
        *x, tq=8, tk=8, window=12, device="cpu"), x, _t(do))
    assert (pfa.flash_attention.plain_calls,
            pfa.flash_attention.bwd_plain_calls) == (1, 1)
    y = [_t(a, True) for a in (q, k, v)]
    want = torch.autograd.grad(pfa.flash_attention_plain(
        *y, tq=8, tk=8, window=12), y, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("what", ["tq_ne_tk", "not_causal", "negative"])
def test_window_needs_equal_tiles_and_causality(what):
    """The reference defines the windowed function over one chunk size,
    with the causal mask: anything else raises ValueError, forward and
    backward, before any work."""
    q = torch.zeros(1, 16, 4)
    lse = torch.zeros(1, 16)
    kw = {"tq_ne_tk": dict(tq=4, tk=8, window=8),
          "not_causal": dict(tq=8, tk=8, window=8, causal=False),
          "negative": dict(tq=8, tk=8, window=-1)}[what]
    with pytest.raises(ValueError, match="window"):
        pfa.flash_attention(q, q, q, device="cpu", **kw)
    with pytest.raises(ValueError, match="window"):
        pfa.flash_attention_bwd(q, q, q, q, q, lse, device="cpu", **kw)


def test_bwd_wrapper_checks_its_inputs():
    q = torch.zeros(1, 8, 4)
    lse = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="divide"):
        pfa.flash_attention_bwd(q, q, q, q, q, lse, tq=3, tk=8,
                                device="cpu")
    if not torch.cuda.is_available():      # device=None means the card
        with pytest.raises(RuntimeError, match="cuda"):
            pfa.flash_attention_bwd(q, q, q, q, q, lse, tq=8, tk=8)


# ------------------------------------------ the bfloat16 kernel's rounding

BF16 = torch.bfloat16
LM_TOL_BF16 = 1e-2


def _bf16_inputs(bh, l, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(bh, l, d)).astype(np.float32))
            .to(BF16) for _ in range(4)]


# (BH, L, D, tq, tk): Qwen2-1.5B's per-head training shape (D 128, tile
# 512) for a few heads, tq != tk both ways, ragged L and D
BF16_SHAPES = [(3, 512, 128, 512, 512), (2, 200, 64, 50, 100),
               (2, 200, 64, 100, 50), (2, 13, 5, 13, 13),
               (2, 130, 40, 130, 130), (2, 200, 112, 200, 200)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_kernel_rounding_within_the_card_tolerance(shape, causal):
    bh, l, d, tq, tk = shape
    q, k, v, do = _bf16_inputs(bh, l, d, [l, d, tq, tk])
    o, lse = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq, tk=tk,
                                       return_lse=True)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=tq, tk=tk)
    got = flash_bwd_wgmma_emulation(q, k, v, o, do, lse, causal=causal,
                                    tq=tq, tk=tk)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == BF16 and g.shape == q.shape
        assert torch.isfinite(g.float()).all()
        err = float((g.float() - w.float()).abs().max())
        tol = LM_TOL_BF16 * max(1.0, float(w.float().abs().max()))
        assert err <= tol, (f"d{name}", err, tol)


# (BH, L, D, tile, window): Gemma3's head dim, 256, with and without a
# window, windows that are and are not multiples of 64 and of the tile;
# and D 192 (the two roundings at wide heads; the model's own cases are
# in test_torch_flash_bwd_wgmma.py)
WIDE_BF16_SHAPES = [(2, 256, 256, 128, 0), (2, 256, 256, 128, 100),
                    (2, 256, 256, 64, 64), (1, 256, 192, 32, 50)]


@pytest.mark.parametrize("shape", WIDE_BF16_SHAPES)
def test_bf16_kernel_rounding_at_wide_heads_and_windows(shape):
    bh, l, d, t, w = shape
    q, k, v, do = _bf16_inputs(bh, l, d, [l, d, t, w])
    o, lse = pfa.flash_attention_plain(q, k, v, tq=t, tk=t, window=w,
                                       return_lse=True)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, tq=t, tk=t,
                                         window=w)
    got = flash_bwd_wgmma_emulation(q, k, v, o, do, lse, causal=True,
                                    tq=t, tk=t, window=w)
    for name, g, w_ in zip("qkv", got, want):
        assert torch.isfinite(g.float()).all()
        err = float((g.float() - w_.float()).abs().max())
        tol = LM_TOL_BF16 * max(1.0, float(w_.float().abs().max()))
        assert err <= tol, (f"d{name}", err, tol)
