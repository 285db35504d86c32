"""The design of the bfloat16 flash backward (`flash_bwd_dq_wgmma`,
`flash_bwd_dkdv_wgmma`) at every head dim, on the CPU (no card, no
nvcc), on numpy-seeded inputs.

`tests/_torch_flash_wgmma.py::flash_bwd_wgmma_emulation` is its rounding
model: at D <= 128, 128-row query blocks whose warpgroups each sum
every key of the block's 64-key tiles for their own 64 rows into one
sum, and 128-key blocks whose warpgroups each take 64 of the keys;
past 128, 64-row query blocks whose two warpgroups each take 32 keys of
a 64-key tile with sums of their own, added once, and 64-key blocks
walking exactly their 64-query tiles, with P^T in float32 shared between
the roles; P and dS rounded to bfloat16 for their products; the
wrapper's zero columns up to a multiple of 8. It is held to
`flash_attention_bwd_plain` and to the reference's gradients (`jax.vjp`
of `kernels/ref.py::attention_ref` where the forward's key bound keeps
every key below the diagonal: tq = tk or tq a multiple of tk; with a
window, of its windowed `chunked_attention`) within the card's tolerance
for bfloat16 outputs, 1e-2 times max(1, largest |gradient|)
(`chip_smoke.py`'s `LM_TOL`): one bfloat16 step is 2^-7 = 0.0078. The
padding on its own: the plain backward on the padded tensors at the true
D's scale equals the plain backward on the unpadded ones to float32
rounding, with zero gradients in the padded columns.
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

BF16, F32 = torch.bfloat16, torch.float32
LM_TOL_BF16 = 1e-2

# (BH, L, D, tq, tk, causal, window): D 256, 192 and the padded 250 and
# 136; causal with tq != tk both ways; a window of 100 at tile 64 (a
# multiple of neither); non-causal; L 200 and 320, which leave ragged
# 64-row and 64-key tiles, and L 13, less than one. The narrow builds':
# D 128, 112, 64, 40, 12 and 5 (the last two padded to 16 and 8 and
# read at the 64 build's width), tq != tk both ways, a non-causal single
# tile of a ragged L 300 (Whisper's encoder's form), a window at D 128,
# and L 13
CASES = [(2, 256, 256, 64, 64, True, 0),
         (2, 256, 192, 128, 128, True, 0),
         (3, 320, 250, 64, 64, True, 0),
         (2, 256, 192, 64, 128, True, 0),
         (2, 256, 256, 128, 64, True, 0),
         (2, 320, 256, 64, 64, True, 100),
         (2, 256, 192, 64, 64, True, 100),
         (1, 320, 136, 64, 64, True, 100),
         (2, 200, 256, 200, 200, False, 0),
         (3, 128, 136, 64, 64, False, 0),
         (2, 200, 192, 40, 40, True, 0),
         (2, 13, 200, 13, 13, True, 0),
         (2, 256, 128, 128, 128, True, 0),
         (2, 200, 112, 200, 200, True, 0),
         (2, 320, 64, 64, 64, True, 0),
         (2, 200, 40, 50, 100, True, 0),
         (2, 200, 12, 100, 50, True, 0),
         (2, 300, 64, 300, 300, False, 0),
         (2, 320, 128, 64, 64, True, 100),
         (2, 13, 5, 13, 13, True, 0)]

def _id(case):
    bh, l, d, tq, tk, causal, w = case
    return (f"bh{bh}-l{l}-d{d}-tq{tq}-tk{tk}-"
            f"{'causal' if causal else 'full'}-w{w}")


def _inputs(bh, l, d, seed):
    """q, k, v, dO as the same bfloat16 values in numpy float32 and
    torch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        t = torch.from_numpy(rng.normal(size=(bh, l, d)).astype(np.float32))
        t = t.to(BF16)
        out.append((t.to(F32).numpy(), t))
    return out


def _check(got, want, what):
    for name, g, w in zip("qkv", got, want):
        if not torch.is_tensor(w):
            w = torch.from_numpy(np.array(w, dtype=np.float32))
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        err = float((g.float() - w.float()).abs().max())
        tol = LM_TOL_BF16 * max(1.0, float(w.float().abs().max()))
        assert err <= tol, (what, f"d{name}", err, tol)


def _forward(q, k, v, causal, tq, tk, w):
    """o (bfloat16) and the log-sum-exp, as the forward kernel hands
    them to the backward."""
    return pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq, tk=tk,
                                     window=w, return_lse=True)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_bwd_wgmma_design_within_the_card_tolerance(case):
    bh, l, d, tq, tk, causal, w = case
    ins = _inputs(bh, l, d, seed=[l, d, tq, tk, w, 31])
    (_, q), (_, k), (_, v), (_, do) = ins
    o, lse = _forward(q, k, v, causal, tq, tk, w)
    got = flash_bwd_wgmma_emulation(q, k, v, o, do, lse, causal=causal,
                                    tq=tq, tk=tk, window=w)
    assert all(g.dtype == BF16 and g.shape == q.shape for g in got)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=tq, tk=tk, window=w)
    _check(got, want, "against the plain backward")


def _keeps_every_key(case):
    _, _, _, tq, tk, causal, w = case
    return not causal or (w == 0 and tq % tk == 0)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] or
                                  _keeps_every_key(c)], ids=_id)
def test_bwd_wgmma_design_against_the_reference_vjp(case):
    """The reference's gradients of the same function: `attention_ref`
    where the key bound keeps every key below the diagonal, its
    windowed `chunked_attention` (chunk = the tile) with a window."""
    bh, l, d, tq, tk, causal, w = case
    ins = _inputs(bh, l, d, seed=[l, d, tq, tk, w, 32])
    (nq, q), (nk, k), (nv, v), (ndo, do) = ins
    if w:
        def ref(q, k, v):  # (BH, L, D) as (1, L, BH, D): one KV head each
            return rlayers.chunked_attention(
                *(x.transpose(1, 0, 2)[None] for x in (q, k, v)),
                causal=True, window=w, chunk=tq)[0].transpose(1, 0, 2)
    else:
        def ref(q, k, v):
            return rref.attention_ref(q[None], k[None], v[None],
                                      causal=causal)[0]
    _, vjp = jax.vjp(ref, *map(jnp.asarray, (nq, nk, nv)))
    want = vjp(jnp.asarray(ndo))
    o, lse = _forward(q, k, v, causal, tq, tk, w)
    got = flash_bwd_wgmma_emulation(q, k, v, o, do, lse, causal=causal,
                                    tq=tq, tk=tk, window=w)
    _check(got, want, "against the reference's VJP")


@pytest.mark.parametrize("d", [130, 250, 255, 5, 12, 100])
@pytest.mark.parametrize("window", [0, 100])
def test_bwd_zero_padding_keeps_the_gradients(d, window):
    """`wgmma_operand`'s zero columns at the true D's scale: the plain
    backward on the padded float32 tensors (q scaled so that the padded
    width's scale is the true D's), sliced back to D, equals it on the
    unpadded ones to float32 rounding (dq scaled back likewise), and
    every gradient's padded columns are zero."""
    rng = np.random.default_rng(d + window + 31)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 192, d))
                                    .astype(np.float32)) for _ in range(4))
    d8 = pfa.wgmma_width(d)
    up = (d8 / d) ** 0.5
    pq, pk, pv, pdo = (pfa.wgmma_operand(t) for t in (q, k, v, do))
    assert pq.shape == (2, 192, d8) and not pq[..., d:].any()
    po, plse = pfa.flash_attention_plain(pq * up, pk, pv, tq=64, tk=64,
                                         window=window, return_lse=True)
    o, lse = pfa.flash_attention_plain(q, k, v, tq=64, tk=64, window=window,
                                       return_lse=True)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), rtol=1e-6,
                               atol=1e-6)
    got = pfa.flash_attention_bwd_plain(pq * up, pk, pv, po, pdo, plse,
                                        tq=64, tk=64, window=window)
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, tq=64, tk=64,
                                         window=window)
    for name, g, w, mul in zip("qkv", got, want, (up, 1.0, 1.0)):
        assert not g[..., d:].any(), f"d{name}'s padded columns"
        np.testing.assert_allclose((g[..., :d] * mul).numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f"d{name}")

