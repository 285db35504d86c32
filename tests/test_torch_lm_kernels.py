"""The port's LM kernels' plain versions (the CPU path of `flash_attention`,
`ssd_scan`, `bitplane_matmul` and `kernels/ops.py`) and its torch oracles
(`kernels/ref.py`) against the reference's kernels in interpret mode and
its oracles, on numpy-seeded inputs, at the shapes of
`tests/test_kernels.py` plus L = 11.

Tolerances. Where the port repeats the reference's arithmetic op for op
in float32 (the plain versions against the interpret-mode kernels),
sums differ only in their order: 1e-5. bfloat16 outputs are rounded
once from float32 that differs in the last bits, so they may land one
bfloat16 step apart: rtol 1e-2 (2^-7 is 0.0078). Against the oracles
the reference's own test tolerances hold (2e-3 attention and SSD, 2e-2
bit planes). `quantize_weights` is held bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.bitplane_matmul import bitplane_matmul as r_bitplane
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.models import layers as rlayers
from repro.models import mamba as rmamba
from repro_torch.kernels import ops, ref
from repro_torch.kernels import bitplane_matmul as pbp
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ssd_scan as pss
from repro_torch.models import layers as players
from repro_torch.models import mamba as pmamba

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype="f32"):
    """One numpy array as the same values in a JAX and a torch array of
    the dtype (bfloat16 rounded once, on the JAX side)."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jnp.float32).astype(jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="f32", **tol):
    np.testing.assert_allclose(_np(got), _np(want),
                               **(tol or (F32_TOL if dtype == "f32"
                                          else BF16_TOL)))


# ------------------------------------------------------- bitplane matmul

@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_weights_bit_for_bit(bits):
    w = np.random.default_rng(bits).normal(size=(128, 96)).astype(
        np.float32) * 0.1
    w[:, 3] = 0.0                                  # a zero column: scale 1
    rp, rs, rq = rref.quantize_weights(jnp.asarray(w), bits)
    tp_, ts, tq = ref.quantize_weights(torch.from_numpy(w), bits)
    assert tp_.dtype == torch.int8 and tq.dtype == torch.int32
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bitplane_plain_matches_reference_kernel(bits, shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng([bits, m])
    jx, tx = _pair(rng.normal(size=(m, k)), dtype)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    rp, rs, _ = rref.quantize_weights(jnp.asarray(w), bits)
    tp_, ts, _ = ref.quantize_weights(torch.from_numpy(w), bits)
    got = pbp.bitplane_matmul(tx, tp_, ts, bits=bits, device="cpu")
    assert got.dtype == tx.dtype and got.shape == (m, n)
    # the plain version is the reference's oracle op for op
    _close(got, rref.bitplane_matmul_ref(jx, rp, rs, bits=bits), dtype)
    _close(got, ref.bitplane_matmul_ref(tx, tp_, ts, bits=bits), dtype,
           rtol=0, atol=0)
    # the TPU kernel sums one product per plane: the reference's test
    # tolerance
    _close(got, r_bitplane(jx, rp, rs, bits=bits, interpret=True), dtype,
           rtol=2e-2, atol=2e-2)


def test_quantized_linear_pads_m_and_keeps_the_shape():
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.normal(size=(3, 50, 128)))
    w = rng.normal(size=(128, 256)).astype(np.float32) * 0.1
    want = rops.quantized_linear(jx, jnp.asarray(w), bits=4)
    got = ops.quantized_linear(tx, torch.from_numpy(w), bits=4,
                               device="cpu")
    assert got.shape == (3, 50, 256)
    _close(got, want, rtol=2e-2, atol=2e-2)
    _close(got, ref.bitplane_matmul_ref(
        tx.reshape(-1, 128), *ref.quantize_weights(torch.from_numpy(w), 4
                                                   )[:2], bits=4
    ).reshape(3, 50, 256), rtol=0, atol=0)


def test_bitplane_checks_the_tiles():
    x = torch.zeros((100, 128))
    planes, scales, _ = ref.quantize_weights(torch.ones((128, 128)), 4)
    with pytest.raises(ValueError, match="divide"):
        pbp.bitplane_matmul(x, planes, scales, bits=4, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        pbp.bitplane_matmul(x, planes, scales, bits=8, device="cpu")


# ------------------------------------------------------- flash attention

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 64), (1, 512, 128), (3, 11, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_reference_kernel(causal, shape, dtype):
    bh, l, d = shape
    rng = np.random.default_rng([l, d])
    (jq, tq_), (jk, tk_), (jv, tv) = (_pair(rng.normal(size=shape), dtype)
                                      for _ in range(3))
    t = min(128, l)
    want = r_flash(jq, jk, jv, causal=causal, tq=t, tk=t, interpret=True)
    got = pfa.flash_attention(tq_, tk_, tv, causal=causal, tq=t, tk=t,
                              device="cpu")
    assert got.dtype == tq_.dtype and got.shape == shape
    _close(got, want, dtype)
    oracle = rref.attention_ref(jq[:, None], jk[:, None], jv[:, None],
                                causal=causal)[:, 0]
    _close(ref.attention_ref(tq_[:, None], tk_[:, None], tv[:, None],
                             causal=causal)[:, 0], oracle, dtype)
    if dtype == "f32":
        _close(got, oracle, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("tiles", [(64, 128), (128, 64), (32, 96)])
def test_flash_plain_keeps_the_causal_tile_bound(tiles):
    """The TPU kernel reads KV tiles below clamp((qi+1) tq // tk, 1,
    L // tk); with tq < tk that bound drops keys below the diagonal, and
    the port keeps the same function."""
    tq, tk = tiles
    l = 384 if tk == 96 else 256
    rng = np.random.default_rng(tq)
    (jq, tq_), (jk, tk_), (jv, tv) = (_pair(rng.normal(size=(2, l, 32)))
                                      for _ in range(3))
    want = r_flash(jq, jk, jv, causal=True, tq=tq, tk=tk, interpret=True)
    got = pfa.flash_attention(tq_, tk_, tv, causal=True, tq=tq, tk=tk,
                              device="cpu")
    _close(got, want)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_wide_heads_match_reference_kernel(d, dtype):
    """Head dims past 128 (the kernels' D 192 and 256 builds; Gemma3's
    256) against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(d)
    (jq, tq_), (jk, tk_), (jv, tv) = (_pair(rng.normal(size=(2, 128, d)),
                                            dtype) for _ in range(3))
    want = r_flash(jq, jk, jv, causal=True, tq=64, tk=64, interpret=True)
    got = pfa.flash_attention(tq_, tk_, tv, causal=True, tq=64, tk=64,
                              device="cpu")
    _close(got, want, dtype)


# (window, tile): below, at and above the tile, window % tile > 1 (the
# reference's tile bound drops keys inside the window), wider than L
_WINDOWS = [(5, 4), (8, 8), (12, 8), (16, 8), (20, 4), (100, 16)]


@pytest.mark.parametrize("window,t", _WINDOWS)
def test_windowed_flash_plain_matches_reference_chunked(window, t):
    """The windowed plain forward, through `ops.gqa_flash_attention`'s
    grouping, and the port's windowed `chunked_attention`, against the
    reference's `chunked_attention(window=...)`."""
    b, l, h, hkv, d = 2, 48, 4, 2, 16
    rng = np.random.default_rng([window, t])
    jq, tq_ = _pair(rng.normal(size=(b, l, h, d)))
    jk, tk_ = _pair(rng.normal(size=(b, l, hkv, d)))
    jv, tv = _pair(rng.normal(size=(b, l, hkv, d)))
    want = rlayers.chunked_attention(jq, jk, jv, causal=True, window=window,
                                     chunk=t)
    got = ops.gqa_flash_attention(tq_, tk_, tv, causal=True, tq=t, tk=t,
                                  window=window, device="cpu")
    _close(got, want)
    _close(players.chunked_attention(tq_, tk_, tv, causal=True,
                                     window=window, chunk=t), want)


def test_flash_tile_of_one_is_the_exact_window():
    """At a tile of one key the tile bound bounds nothing: the plain
    version is the reference's exact `plain_attention` window, what
    `attn_impl="plain"` runs on the card."""
    b, l, h, hkv, d = 2, 40, 4, 2, 16
    rng = np.random.default_rng(11)
    jq, tq_ = _pair(rng.normal(size=(b, l, h, d)))
    jk, tk_ = _pair(rng.normal(size=(b, l, hkv, d)))
    jv, tv = _pair(rng.normal(size=(b, l, hkv, d)))
    want = rlayers.plain_attention(jq, jk, jv, causal=True, window=12)
    got = ops.gqa_flash_attention(tq_, tk_, tv, causal=True, tq=1, tk=1,
                                  window=12, device="cpu")
    _close(got, want)


def test_flash_checks_the_tiles():
    q = torch.zeros((1, 200, 16))
    with pytest.raises(ValueError, match="divide"):
        pfa.flash_attention(q, q, q, tq=128, tk=128, device="cpu")


@pytest.mark.parametrize("l", [256, 11])
def test_gqa_flash_wrapper_matches_model_attention(l):
    b, h, hkv, d = 2, 8, 2, 32
    rng = np.random.default_rng(7 + l)
    jq, tq_ = _pair(rng.normal(size=(b, l, h, d)))
    jk, tk_ = _pair(rng.normal(size=(b, l, hkv, d)))
    jv, tv = _pair(rng.normal(size=(b, l, hkv, d)))
    t = min(64, l)
    want = rlayers.chunked_attention(jq, jk, jv, causal=True, chunk=t)
    got = ops.gqa_flash_attention(tq_, tk_, tv, causal=True, tq=t, tk=t,
                                  device="cpu")
    _close(got, rops.gqa_flash_attention(jq, jk, jv, causal=True, tq=t,
                                         tk=t))
    _close(got, want, rtol=2e-3, atol=2e-3)
    _close(players.chunked_attention(tq_, tk_, tv, causal=True, chunk=t),
           want)


# ------------------------------------------------------------- ssd scan

def _ssd_inputs(bt, h, l, p, n, g, seed, dtype="f32"):
    rng = np.random.default_rng(seed)
    jx, tx = _pair(rng.normal(size=(bt, h, l, p)), dtype)
    dt = np.log1p(np.exp(rng.normal(size=(bt, h, l)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    jB, tB = _pair(rng.normal(size=(bt, g, l, n)) * 0.5, dtype)
    jC, tC = _pair(rng.normal(size=(bt, g, l, n)) * 0.5, dtype)
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jB, jC),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tB, tC))


@pytest.mark.parametrize("shape", [(2, 4, 128, 32, 16, 64),
                                   (1, 2, 256, 64, 32, 64),
                                   (1, 3, 11, 16, 8, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_plain_matches_reference_kernel(shape, dtype):
    bt, h, l, p, n, q = shape
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _ssd_inputs(
        bt, h, l, p, n, 1, l, dtype)
    want = rops.ssd(jx, jdt, ja, jB, jC, q=q)
    got = ops.ssd(tx, tdt, ta, tB, tC, q=q, device="cpu")
    assert got.dtype == tx.dtype and got.shape == (bt, h, l, p)
    _close(got, want, dtype)
    Bh = jnp.broadcast_to(jB, (bt, h, l, n))
    Ch = jnp.broadcast_to(jC, (bt, h, l, n))
    oracle, s_oracle = rref.ssd_ref(jx, jdt, ja, Bh, Ch)
    ty, ts = ref.ssd_ref(tx, tdt, ta, tB.expand(bt, h, l, n),
                         tC.expand(bt, h, l, n))
    _close(ty, oracle, dtype)
    _close(ts, s_oracle)
    if dtype == "f32":
        _close(got, oracle, rtol=2e-3, atol=2e-3)


def test_ssd_groups_index_their_heads():
    """G = 2 groups over H = 6 heads: the port's kernel path reads group
    h // 3 where the reference repeats B and C per head."""
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _ssd_inputs(
        2, 6, 96, 16, 8, 2, 11)
    _close(ops.ssd(tx, tdt, ta, tB, tC, q=32, device="cpu"),
           rops.ssd(jx, jdt, ja, jB, jC, q=32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_final_state_matches_ssd_chunked(dtype):
    """ops.ssd's final state against the model's `ssd_chunked(...,
    return_state=True)` (different chunking, D = 0: the residual stays
    outside the kernel)."""
    bt, l, h, p, n = 2, 128, 4, 16, 8
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _ssd_inputs(
        bt, h, l, p, n, 1, 3, dtype)
    perm = (0, 2, 1, 3)
    want_y, want_s = rmamba.ssd_chunked(
        jx.transpose(perm), jdt.transpose(0, 2, 1), ja, jB.transpose(perm),
        jC.transpose(perm), jnp.zeros(h), chunk=64, return_state=True)
    got_y, got_s = ops.ssd(tx, tdt, ta, tB, tC, q=32, return_state=True,
                           device="cpu")
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == "f32" else {}
    _close(got_y.permute(perm), want_y, dtype, **tol)
    _close(got_s, want_s, rtol=2e-3, atol=2e-3)
    # and the scan's plain version keeps the scratch it carries
    y2, s2 = pss.ssd_scan(ta.repeat(bt), tx.reshape(bt * h, l, p),
                          tdt.reshape(bt * h, l), tB.reshape(bt, l, n),
                          tC.reshape(bt, l, n), q=32, rep=h, device="cpu")
    _close(s2.reshape(bt, h, n, p), got_s, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_chunked_matches_reference(dtype):
    bt, l, h, p, n = 2, 96, 4, 16, 8
    (jx, jdt, ja, jB, jC), (tx, tdt, ta, tB, tC) = _ssd_inputs(
        bt, h, l, p, n, 2, 4, dtype)
    D = np.linspace(0.5, 1.5, h).astype(np.float32)
    perm = (0, 2, 1, 3)
    want = rmamba.ssd_chunked(
        jx.transpose(perm), jdt.transpose(0, 2, 1), ja, jB.transpose(perm),
        jC.transpose(perm), jnp.asarray(D), chunk=32, return_state=True)
    got = pmamba.ssd_chunked(
        tx.permute(perm), tdt.permute(0, 2, 1), ta, tB.permute(perm),
        tC.permute(perm), torch.from_numpy(D), chunk=32, return_state=True)
    _close(got[0], want[0], dtype)
    _close(got[1], want[1])


def test_ssd_keeps_the_chunk_assert():
    x = torch.zeros((1, 96, 2, 4))
    with pytest.raises(AssertionError):
        pmamba.ssd_chunked(x, torch.zeros((1, 96, 2)), torch.zeros(2),
                           torch.zeros((1, 96, 1, 4)),
                           torch.zeros((1, 96, 1, 4)), torch.zeros(2),
                           chunk=64)
    with pytest.raises(ValueError, match="divide"):
        pss.ssd_scan(torch.zeros(2), torch.zeros((2, 96, 4)),
                     torch.zeros((2, 96)), torch.zeros((2, 96, 4)),
                     torch.zeros((2, 96, 4)), q=64, device="cpu")


def test_plain_calls_are_counted():
    pfa.reset_counts()
    pss.reset_counts()
    pbp.reset_counts()
    q = torch.zeros((1, 8, 16))
    pfa.flash_attention(q, q, q, tq=8, tk=8, device="cpu")
    ops.ssd(torch.zeros((1, 2, 8, 4)), torch.zeros((1, 2, 8)),
            -torch.ones(2), torch.zeros((1, 1, 8, 4)),
            torch.zeros((1, 1, 8, 4)), device="cpu")
    assert (pfa.flash_attention.plain_calls, pfa.flash_attention.launches,
            pss.ssd_scan.plain_calls, pss.ssd_scan.launches,
            pbp.bitplane_matmul.plain_calls) == (1, 0, 1, 0, 0)
