"""The bfloat16 scan forward's design on the CPU (no card, no nvcc):
`tests/_torch_ssd_wgmma.py::ssd_wgmma_emulation`, the rounding model of
`ssd_fwd_wgmma` (csrc/ssd_scan.cu: per head and chunk, 64 x 64 tile
pairs at or below the diagonal, W, S and (B w)^T rounded to bfloat16 for
their products, exp2 of the cumsum times log2 e, the float32 state over
the chunks), on numpy-seeded bfloat16 inputs, held to `ssd_scan_plain`
(y, the final state and the chunk-entry states the backward reads), to
the reference's TPU kernel in interpret mode (y; B and C repeated per
head) and to its sequential oracle `ref.ssd_ref` (the final state), all
within the card's bfloat16 tolerance: 1e-2 times max(1, largest |value|)
(`chip_smoke.py`'s `LM_TOL`, one bfloat16 step is 2^-7). Cases: rep 1
and rep > 1; one, two and three chunks; chunks of 11, 64, 100 and 256
steps (inside one 64-row tile, whole tiles, ragged tiles); P, N at 20/40
and 16/8 (the wrapper zero-pads them to a multiple of 8); P 64 with N
128 (Mamba2's), and P = N = 128 (two 64-column slices of P, two boxes of
N). Also: the wrapper's model of the kernel's shared memory
(`fwd_wgmma_smem`, `fwd_wgmma_max_q`) agrees with the source's constants
and takes the card tests' longest chunk.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ssd_wgmma import ssd_wgmma_emulation
from repro.kernels import ref as rref
from repro.kernels.ssd_scan import ssd_scan as r_ssd
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as pss

BF16 = torch.bfloat16
LM_TOL_BF16 = 1e-2


def _bf16_pair(a):
    """One numpy array as the same bfloat16 values in JAX and torch."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _lm_err(got, want):
    g, w = _np(got), _np(want)
    return (float(np.abs(g - w).max()),
            LM_TOL_BF16 * max(1.0, float(np.abs(w).max())))


def _inputs(shape):
    """Numpy-seeded (JAX, torch) inputs for (batch, heads, L, P, N, chunk,
    groups)."""
    bt, h, l, p, n, q, groups = shape
    rng = np.random.default_rng([l, p, n, q, h])
    jx, x = _bf16_pair(rng.normal(size=(bt * h, l, p)))
    dt = np.log1p(np.exp(rng.normal(size=(bt * h, l)))).astype(np.float32)
    a = np.tile(-np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32), bt)
    jb, b = _bf16_pair(rng.normal(size=(bt * groups, l, n)) * 0.5)
    jc, c = _bf16_pair(rng.normal(size=(bt * groups, l, n)) * 0.5)
    return (a, dt, jx, jb, jc), (torch.from_numpy(a), x, torch.from_numpy(dt),
                                 b, c)


# (batch, heads, L, P, N, chunk, groups)
_CASES = [(1, 2, 64, 16, 8, 64, 2),       # rep 1, one chunk of one tile
          (1, 4, 22, 20, 40, 11, 2),      # rep 2, two chunks inside a tile
          (1, 2, 33, 16, 8, 11, 1),       # three chunks of 11
          (1, 3, 300, 20, 40, 100, 1),    # rep 3, three ragged chunks
          (1, 2, 512, 64, 128, 256, 1),   # Mamba2's P, N and chunk
          (1, 2, 256, 128, 128, 256, 2),  # P = N = 128, one chunk
          (2, 2, 192, 128, 128, 64, 1)]   # P = N = 128, three chunks


@pytest.mark.parametrize("shape", _CASES)
def test_ssd_wgmma_design_within_the_card_tolerance(shape):
    bt, h, l, p, n, q, groups = shape
    rep = h // groups
    (a, dt, jx, jb, jc), (ta, x, tdt, b, c) = _inputs(shape)
    got_y, got_s, got_st = ssd_wgmma_emulation(ta, x, tdt, b, c, q=q,
                                               rep=rep, return_states=True)
    assert got_y.dtype == BF16 and torch.isfinite(got_y.float()).all()
    assert got_st.shape == (bt * h, l // q - 1, n, p)
    want = pss.ssd_scan_plain(ta, x, tdt, b, c, q=q, rep=rep,
                              return_states=True)
    for got, w in zip((got_y, got_s, got_st), want):
        if w.numel():
            err, tol = _lm_err(got, w)
            assert err <= tol, (err, tol)
    jbh, jch = (jnp.repeat(m, rep, axis=0) for m in (jb, jc))
    err, tol = _lm_err(got_y, r_ssd(jnp.asarray(a), jx, jnp.asarray(dt), jbh,
                                    jch, q=q, interpret=True))
    assert err <= tol, (err, tol)
    _, s_oracle = rref.ssd_ref(
        jx.reshape(bt, h, l, p), jnp.asarray(dt).reshape(bt, h, l),
        jnp.asarray(a[:h]), jbh.reshape(bt, h, l, n),
        jch.reshape(bt, h, l, n))
    err, tol = _lm_err(got_s, np.asarray(s_oracle).reshape(bt * h, n, p))
    assert err <= tol, (err, tol)


def _constant(name):
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_shared_memory_model_matches_the_source():
    """The wrapper's ring sizes are the source's, its sum is the one the
    source header states (69,680 bytes at N 64 and chunk 256: three
    blocks an SM; 110,640 at N 128: two), and its chunk limit is the
    longest within 227 KB: 13,760 steps at N <= 64, 10,368 at N <= 128,
    past the card tests' 3,072."""
    assert (pss._FWD_C_SLOTS, pss._FWD_STAGES) == (
        _constant("kCSlots"), _constant("kFwdStages"))
    assert pss.fwd_wgmma_smem(64, 256) == 69680
    assert pss.fwd_wgmma_smem(128, 256) == 110640
    assert 3 * (69680 + 1024) <= 228 * 1024 < 4 * (69680 + 1024)
    assert 2 * (110640 + 1024) <= 228 * 1024 < 3 * (110640 + 1024)
    for n, q_max in ((8, 13760), (64, 13760), (72, 10368), (128, 10368)):
        assert pss.fwd_wgmma_max_q(n) == q_max
        assert pss.fwd_wgmma_smem(n, q_max) <= pss._SMEM_LIMIT
        assert pss.fwd_wgmma_smem(n, q_max + 1) > pss._SMEM_LIMIT
    header = (_build.CSRC / "ssd_scan.cu").read_text()
    assert "10,368 at N\n// 128, 13,760 at N 64" in header


def test_emulation_zero_columns_change_nothing():
    """The wrapper hands the kernel x, B and C zero-padded to a multiple
    of 8 columns and slices the outputs back: in the design's arithmetic
    the zero columns add nothing (only the float32 sums' order may
    change: within 1e-5 of the scale, y within one bfloat16 step), and
    the padded columns of y and the states come out zero."""
    shape = (1, 2, 150, 13, 21, 50, 1)
    _, (ta, x, tdt, b, c) = _inputs(shape)
    pad = torch.nn.functional.pad
    got = ssd_wgmma_emulation(ta, x, tdt, b, c, q=50, rep=2,
                              return_states=True)
    padded = ssd_wgmma_emulation(ta, pad(x, (0, 3)), tdt, pad(b, (0, 3)),
                                 pad(c, (0, 3)), q=50, rep=2,
                                 return_states=True)
    cut = (padded[0][..., :13], padded[1][:, :21, :13],
           padded[2][:, :, :21, :13])
    for tol, u, v in zip((2.0 ** -7, 1e-5, 1e-5), cut, got):
        scale = max(1.0, float(v.float().abs().max()))
        assert float((u.float() - v.float()).abs().max()) <= tol * scale
    assert not padded[0][..., 13:].float().any()
    assert not padded[1][:, 21:].any() and not padded[1][..., 13:].any()
