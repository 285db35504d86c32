"""The design of the bfloat16 flash forward (`flash_fwd_wgmma`, every
head dim), on the CPU (no card, no nvcc), on numpy-seeded inputs.

`tests/_torch_flash_wgmma.py::flash_wgmma_emulation` is its rounding
model: 128-row blocks of two 64-row halves, 64-key softmax steps, the
running max with P rounded to bfloat16 against it at each step, the
denominator from float32 P, and the wrapper's zero columns up to a
multiple of 8. It is held to `flash_attention_plain` and to the
reference (its TPU kernel in interpret mode; with a window, its windowed
`chunked_attention`) within the card's tolerance for bfloat16 outputs,
1e-2 times max(1, largest |output|) (`chip_smoke.py`'s `LM_TOL`): one
bfloat16 step is 2^-7 = 0.0078. The padding on its own: the plain
version on the padded tensors at the true D's scale equals the plain
version on the unpadded ones to float32 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_wgmma import flash_wgmma_emulation
from _torch_parity import one_torch_thread  # noqa: F401
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.models import layers as rlayers
from repro_torch.kernels import flash_attention as pfa

BF16, F32 = torch.bfloat16, torch.float32
LM_TOL_BF16 = 1e-2


def _inputs(bh, l, d, seed):
    """q, k, v as the same bfloat16 values in numpy float32 and torch."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        t = torch.from_numpy(rng.normal(size=(bh, l, d)).astype(np.float32))
        t = t.to(BF16)
        out.append((t.to(F32).numpy(), t))
    return out


def _lm_err(got, want):
    if not torch.is_tensor(want):
        want = torch.from_numpy(np.array(want, dtype=np.float32))
    err = float((got.float() - want.float()).abs().max())
    return err, LM_TOL_BF16 * max(1.0, float(want.float().abs().max()))


def _reference(q, k, v, causal, tq, tk, window):
    """The reference's function on the same values: its TPU kernel in
    interpret mode, or with a window its windowed chunked attention."""
    if not window:
        return r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, tq=tq, tk=tk, interpret=True)
    return rlayers.chunked_attention(
        *(jnp.asarray(x).transpose(1, 0, 2)[None] for x in (q, k, v)),
        causal=True, window=window, chunk=tq)[0].transpose(1, 0, 2)


# (BH, L, D, tq, tk, causal, window): D 192 and 256 and D 250 (padded to
# 256), causal with tq != tk both ways, a window of 100 at tile 64 (a
# multiple of neither), non-causal, and L 320 and 200, which leave a
# ragged last 128-row block (one half of it past L at 320 - 256 = 64);
# the narrow builds: D 12 (padded to 16), 64, 112 and 128, causal and
# non-causal; one ragged non-causal tile of 300 like Whisper's encoder's
# (its last 64-key tile holds 44 keys); tq != tk both ways at L 200, D
# 64; a window of 100 at tile 64 at D 64 and 128
CASES = [(2, 256, 256, 64, 64, True, 0),
         (2, 256, 192, 128, 128, True, 0),
         (3, 320, 250, 64, 64, True, 0),
         (2, 256, 192, 64, 128, True, 0),
         (2, 256, 256, 128, 64, True, 0),
         (2, 320, 256, 64, 64, True, 100),
         (2, 256, 192, 64, 64, True, 100),
         (2, 320, 250, 64, 64, True, 100),
         (2, 200, 256, 200, 200, False, 0),
         (4, 128, 192, 64, 64, False, 0),
         (2, 256, 12, 64, 64, True, 0),
         (2, 200, 12, 100, 100, False, 0),
         (2, 320, 64, 64, 64, True, 0),
         (2, 256, 64, 128, 128, False, 0),
         (2, 256, 112, 128, 128, True, 0),
         (2, 200, 112, 200, 200, False, 0),
         (2, 384, 128, 128, 128, True, 0),
         (3, 256, 128, 64, 64, False, 0),
         (2, 300, 64, 300, 300, False, 0),
         (2, 200, 64, 50, 100, True, 0),
         (2, 200, 64, 100, 50, True, 0),
         (2, 320, 64, 64, 64, True, 100),
         (2, 320, 128, 64, 64, True, 100)]


def _id(case):
    bh, l, d, tq, tk, causal, w = case
    return (f"bh{bh}-l{l}-d{d}-tq{tq}-tk{tk}-"
            f"{'causal' if causal else 'full'}-w{w}")


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_wgmma_design_within_the_card_tolerance(case, with_lse):
    bh, l, d, tq, tk, causal, w = case
    (nq, q), (nk, k), (nv, v) = _inputs(bh, l, d, seed=[l, d, tq, tk, w])
    got = flash_wgmma_emulation(q, k, v, causal=causal, tq=tq, tk=tk,
                                window=w, return_lse=with_lse)
    want = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq, tk=tk,
                                     window=w, return_lse=with_lse)
    if with_lse:
        (got, lse), (want, plse) = got, want
        # float32 of the same scores, in another order and base
        np.testing.assert_allclose(lse.numpy(), plse.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert got.dtype == BF16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err, tol = _lm_err(got, want)
    assert err <= tol, (err, tol)
    err, tol = _lm_err(got, _reference(nq, nk, nv, causal, tq, tk, w))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("d", [130, 250, 255])
@pytest.mark.parametrize("window", [0, 100])
def test_zero_padding_keeps_the_function(d, window):
    """`wgmma_operand`'s zero columns at the true D's scale: the plain
    version on the padded float32 tensors, sliced back to D, equals it
    on the unpadded ones to float32 rounding, and its padded output
    columns and log-sum-exp are those of the unpadded call."""
    rng = np.random.default_rng(d + window)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 192, d))
                                .astype(np.float32)) for _ in range(3))
    padded = [pfa.wgmma_operand(t) for t in (q, k, v)]
    assert padded[0].shape == (2, 192, pfa.wgmma_width(d))
    assert pfa.wgmma_width(d) % 8 == 0 and 0 < pfa.wgmma_width(d) - d < 8
    for t, p in zip((q, k, v), padded):
        assert torch.equal(p[..., :d], t) and not p[..., d:].any()
    # q's scale D8^-1/2 made the true D's, D^-1/2, by a float32 factor
    d8 = pfa.wgmma_width(d)
    got, lse = pfa.flash_attention_plain(padded[0] * (d8 / d) ** 0.5,
                                         *padded[1:], tq=64, tk=64,
                                         window=window, return_lse=True)
    want, plse = pfa.flash_attention_plain(q, k, v, tq=64, tk=64,
                                           window=window, return_lse=True)
    assert not got[..., d:].any()
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wgmma_operand_passes_aligned_multiples_of_8():
    """A head dim that is a multiple of 8, on a 16-byte aligned tensor,
    goes to the kernel as it is: no copy."""
    t = torch.zeros((2, 64, 192), dtype=BF16)
    assert pfa.wgmma_operand(t) is t
    off = torch.zeros(2 * 64 * 192 + 1, dtype=BF16)[1:].view(2, 64, 192)
    moved = pfa.wgmma_operand(off)
    assert moved is not off and moved.data_ptr() % 16 == 0
    assert torch.equal(moved, off)

