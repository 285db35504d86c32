"""The arithmetic of the bfloat16 tensor-core paths of `bitplane_matmul`
and `flash_attention`, on the CPU (no card, no nvcc), on numpy-seeded
inputs.

- The bit-plane kernel's bfloat16 path runs in two phases: a repack of
  the planes into W_q as bfloat16, then a bfloat16 GEMM. The repack's
  plain version is held bit for bit to the reference's
  `quantize_weights`, the GEMM's plain version on that weight to the
  plain version of the whole function bit for bit (the same float32
  product of the same values) and to the reference's TPU kernel in
  interpret mode at the reference's test tolerance (2e-2).
- The flash kernel's bfloat16 design (float32 scores from bfloat16
  inputs, the scale applied to the float32 scores through exp2, P
  rounded to bfloat16 for P v, the denominator summed from float32 P),
  as `flash_fwd_wgmma` runs it at the narrow builds' head dims (128-row
  blocks in 64-row halves, 64-key tiles: `tests/_torch_flash_wgmma.py`'s
  `flash_wgmma_emulation`), is held to `flash_attention_plain` and to
  the reference's TPU kernel in interpret mode within the card's
  tolerance for bfloat16 outputs, 1e-2 times max(1, largest |output|)
  (`chip_smoke.py`'s `LM_TOL`, `tests/test_torch_gpu.py`'s `_LM_TOL`):
  one bfloat16 step is 2^-7 = 0.0078.
- The scan kernel's bfloat16 design (`ssd_fwd_wgmma`: per head and
  chunk, per 64 x 64 tile pair at or below the diagonal G = C B^T in
  float32, W = G exp2(cum_i - cum_j) dt_j rounded to bfloat16 as W x's
  operand, C S with S rounded to bfloat16, and the state update with B w
  rounded to bfloat16; float32 sums and state:
  `tests/_torch_ssd_wgmma.py`'s `ssd_wgmma_emulation`) is held to
  `ssd_scan_plain` and to the reference's TPU kernel in interpret mode (y)
  and its sequential oracle `ref.ssd_ref` (the final state) within the
  same tolerance, 1e-2 times max(1, largest |value|).
- The build tables: every header a source includes is hashed into its
  library's name, and every C entry's argument count matches its ctypes
  signature.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_wgmma import flash_wgmma_emulation
from _torch_ssd_wgmma import ssd_wgmma_emulation
from repro.kernels import ref as rref
from repro.kernels.bitplane_matmul import bitplane_matmul as r_bitplane
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.ssd_scan import ssd_scan as r_ssd
from repro_torch.kernels import _build, ref
from repro_torch.kernels import bitplane_matmul as pbp
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ssd_scan as pss

BF16 = torch.bfloat16
F32 = torch.float32
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
    """Largest |got - want| and the card's bfloat16 tolerance for it."""
    g, w = _np(got), _np(want)
    return (float(np.abs(g - w).max()),
            LM_TOL_BF16 * max(1.0, float(np.abs(w).max())))


# ------------------------------------------------------- bitplane matmul

@pytest.mark.parametrize("bits", range(1, 9))
def test_repack_plain_equals_quantize_weights(bits):
    w = np.random.default_rng(bits).normal(size=(96, 80)).astype(
        np.float32) * 0.1
    w[:, 5] = 0.0                                  # a zero column: scale 1
    _, _, rq = rref.quantize_weights(jnp.asarray(w), bits)
    planes, _, _ = ref.quantize_weights(torch.from_numpy(w), bits)
    got = pbp.bitplane_repack_plain(planes, bits=bits)
    assert got.dtype == BF16 and got.shape == (96, 80)
    want = np.asarray(rq)
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), want)
    # |W_q| <= 2^(B-1): bfloat16 holds every value exactly
    back = torch.tensor(want).to(BF16).to(torch.int32).numpy()
    np.testing.assert_array_equal(back, want)
    pbp.reset_counts()
    assert torch.equal(pbp.bitplane_repack(planes, bits=bits, device="cpu"),
                       got)
    assert (pbp.bitplane_repack.plain_calls,
            pbp.bitplane_repack.launches) == (1, 0)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_gemm_on_the_repacked_weight_is_the_function(bits):
    rng = np.random.default_rng([bits, 7])
    jx, tx = _bf16_pair(rng.normal(size=(128, 256)))
    w = rng.normal(size=(256, 384)).astype(np.float32) * 0.1
    rp, rs, _ = rref.quantize_weights(jnp.asarray(w), bits)
    planes, scales, _ = ref.quantize_weights(torch.from_numpy(w), bits)
    pbp.reset_counts()
    got = pbp.bitplane_gemm(tx, pbp.bitplane_repack_plain(planes, bits=bits),
                            scales, device="cpu")
    assert got.dtype == BF16 and got.shape == (128, 384)
    assert pbp.bitplane_gemm.plain_calls == 1
    np.testing.assert_array_equal(
        _np(got), _np(pbp.bitplane_matmul_plain(tx, planes, scales,
                                                bits=bits)))
    np.testing.assert_allclose(
        _np(got), _np(r_bitplane(jx, rp, rs, bits=bits, interpret=True)),
        rtol=2e-2, atol=2e-2)


# ------------------------------------------------------- flash attention

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 512, 112, 512, 512),
                                   (2, 200, 64, 50, 100),
                                   (2, 200, 64, 100, 50)])
def test_flash_bf16_design_within_the_card_tolerance(shape, causal):
    bh, l, d, tq, tk = shape
    rng = np.random.default_rng([l, d, tq, tk])
    (jq, q), (jk, k), (jv, v) = (_bf16_pair(rng.normal(size=(bh, l, d)))
                                 for _ in range(3))
    got = flash_wgmma_emulation(q, k, v, causal=causal, tq=tq, tk=tk)
    assert got.dtype == BF16 and torch.isfinite(got.float()).all()
    err, tol = _lm_err(got, pfa.flash_attention_plain(
        q, k, v, causal=causal, tq=tq, tk=tk))
    assert err <= tol, (err, tol)
    err, tol = _lm_err(got, r_flash(jq, jk, jv, causal=causal, tq=tq, tk=tk,
                                    interpret=True))
    assert err <= tol, (err, tol)


# ------------------------------------------------------- ssd scan

# (batch, heads, L, P, N, chunk, groups): rep 1 and rep > 1; two and
# three chunks; ragged P, N and a chunk under one 64-row tile; the main
# shape's P, N and chunk
_SSD_SHAPES = [(1, 2, 128, 32, 16, 64, 2),
               (2, 4, 192, 64, 64, 64, 1),
               (1, 6, 200, 20, 40, 100, 3),
               (1, 3, 22, 16, 8, 11, 1),
               (1, 5, 512, 64, 64, 256, 1)]


@pytest.mark.parametrize("shape", _SSD_SHAPES)
def test_ssd_bf16_design_within_the_card_tolerance(shape):
    bt, h, l, p, n, q, groups = shape
    rep = h // groups
    rng = np.random.default_rng([l, p, n, q])
    jx, x = _bf16_pair(rng.normal(size=(bt * h, l, p)))
    dt = np.log1p(np.exp(rng.normal(size=(bt * h, l)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    a = np.tile(a, bt)
    jb, b = _bf16_pair(rng.normal(size=(bt * groups, l, n)) * 0.5)
    jc, c = _bf16_pair(rng.normal(size=(bt * groups, l, n)) * 0.5)
    ta, tdt = torch.from_numpy(a), torch.from_numpy(dt)
    got_y, got_s = ssd_wgmma_emulation(ta, x, tdt, b, c, q=q, rep=rep)
    assert got_y.dtype == BF16 and torch.isfinite(got_y.float()).all()
    want_y, want_s = pss.ssd_scan_plain(ta, x, tdt, b, c, q=q, rep=rep)
    for got, want in ((got_y, want_y), (got_s, want_s)):
        err, tol = _lm_err(got, want)
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


# ------------------------------------------------------- build tables

def _includes(name):
    src = (_build.CSRC / name).read_text()
    return re.findall(r'#include "([^"]+)"', src)


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_every_included_header_is_hashed(lib):
    seen, todo = set(), _includes(f"{lib}.cu")
    while todo:
        h = todo.pop()
        if h not in seen:
            seen.add(h)
            todo += _includes(h)
    assert seen == set(_build.HEADERS[lib])


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_c_entries_match_their_signatures(lib):
    src = (_build.CSRC / f"{lib}.cu").read_text()
    for sym, argtypes in _build.SIGNATURES[lib].items():
        m = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)", src)
        assert m, sym
        assert len(m.group(1).split(",")) == len(argtypes), sym
