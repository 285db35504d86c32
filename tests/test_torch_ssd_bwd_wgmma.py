"""The bfloat16 SSD scan backward kernel's arithmetic on the CPU:
`ssd_bwd_wgmma_emulation` (tests/_torch_ssd_bwd_wgmma.py), a rounding
model of `ssd_bwd_wgmma` in csrc/ssd_scan.cu, against the plain version
`ssd_scan_bwd_plain` and against `jax.vjp` of the reference's
`models/mamba.py::ssd_chunked` (D = 0, as `tests/test_torch_ssd_bwd.py`
runs it), through y and the final state; and the host's model of the
kernel's launch: its heads a block (`bwd_wgmma_heads`), its shared
memory (`bwd_wgmma_smem`) and its longest chunk (`bwd_wgmma_max_q`).

Tolerances, x max(1, the gradient's largest magnitude), as the card's
tests hold the kernel to the plain version: `LM_TOL` by the gradient's
dtype, 1e-2 for dx, dB and dC (bfloat16: the model rounds W, the summed
dG, w_j x_j, dS, 2^cum_i dy_i and S_c to bfloat16 for their products),
1e-4 for ddt and da (float32: the products that reach them take dS, S_c
and 2^cum_i C_i as two bfloat16 terms). Against the reference 1e-2 for
all five: it rounds y to bfloat16 before the cotangent flows back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from _torch_ssd_bwd_wgmma import ssd_bwd_wgmma_emulation
from repro.models import mamba as rmamba
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as pss

LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NAMES = ("da", "dx", "ddt", "db", "dc")

# (bt, h, g, l, p, n, q): Mamba2's P 64, N 128, chunk 256 at L 512 (8
# heads a group: 4 blocks of 2); Zamba2's P = N = 64; ragged P, N and
# chunk, two groups; one chunk; heads a block that do not divide the
# group's (5 = 2 + 2 + 1); P past 64 (one head a block, both warpgroups on
# it); 18 heads a group (9 blocks' partials summed in order)
SHAPES = [(1, 8, 1, 512, 64, 128, 256),
          (1, 4, 1, 256, 64, 64, 128),
          (2, 4, 2, 100, 20, 12, 25),
          (2, 4, 1, 64, 16, 32, 64),
          (1, 5, 1, 96, 16, 16, 32),
          (1, 2, 1, 128, 72, 24, 64),
          (1, 18, 1, 64, 8, 8, 32)]


def _case(bt, h, g, l, p, n, seed):
    """numpy-seeded bfloat16 inputs in the kernel's layout (a (BH,), x
    (BH, L, P), dt, B, C (Bt G, L, N), dy, d(s_final) float32)."""
    rng = np.random.default_rng(seed)

    def bf(v):
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    x = bf(rng.normal(size=(bt * h, l, p)))
    dt = torch.from_numpy(
        np.log1p(np.exp(rng.normal(size=(bt * h, l)))).astype(np.float32))
    a = torch.from_numpy(np.tile(
        -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32), bt))
    b = bf(rng.normal(size=(bt * g, l, n)) * 0.5)
    c = bf(rng.normal(size=(bt * g, l, n)) * 0.5)
    dy = bf(rng.normal(size=(bt * h, l, p)))
    ds = torch.from_numpy(rng.normal(size=(bt * h, n, p)).astype(np.float32))
    return a, x, dt, b, c, dy, ds


def _close(got, want, what, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} past {tol} x {scale}"


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_bwd_design_within_the_card_tolerance(shape):
    bt, h, g, l, p, n, q = shape
    rep = h // g
    a, x, dt, b, c, dy, ds = _case(bt, h, g, l, p, n, seed=list(shape))
    _, _, states = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep,
                                      return_states=True)
    hb = pss.bwd_wgmma_heads(p, n, q, rep)
    got = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, ds, q, rep, hb)
    for gt, inp, name in zip(got, (a, x, dt, b, c), NAMES):
        assert gt.dtype == inp.dtype and gt.shape == inp.shape, name
        assert torch.isfinite(gt.float()).all(), name
    want = pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, ds, q=q,
                                  rep=rep)
    for gt, w, name in zip(got, want, NAMES):
        _close(gt, w.float().numpy(), f"plain {name}", LM_TOL[gt.dtype])
    # jax.vjp of the reference's chunked scan, in its layout
    perm = (0, 2, 1, 3)

    def fn(xr, dtr, ar, br, cr):
        y, s = rmamba.ssd_chunked(xr.transpose(perm), dtr.transpose(0, 2, 1),
                                  ar, br.transpose(perm), cr.transpose(perm),
                                  jnp.zeros(ar.shape), chunk=q,
                                  return_state=True)
        return y.transpose(perm), s

    def j(t, shape_):
        return jnp.asarray(t.float().numpy().reshape(shape_))
    prim = (j(x, (bt, h, l, p)).astype(jnp.bfloat16), j(dt, (bt, h, l)),
            j(a, (bt, h))[0], j(b, (bt, g, l, n)).astype(jnp.bfloat16),
            j(c, (bt, g, l, n)).astype(jnp.bfloat16))
    (y, _), vjp = jax.vjp(fn, *prim)
    ref = vjp((j(dy, (bt, h, l, p)).astype(y.dtype), j(ds, (bt, h, n, p))))
    ours = dict(zip(NAMES, got))
    for name, w in zip(("dx", "ddt", "da", "db", "dc"), ref):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        gt = ours[name]
        if name == "da":      # the reference's A is one per head
            gt = gt.reshape(bt, h).sum(0)
        _close(gt.reshape(w.shape), w, f"reference {name}",
               LM_TOL[torch.bfloat16])


def test_heads_summed_before_one_rounding():
    """dB and dC depend on the block: the block's heads' dG are summed in
    float32 and rounded once, so one block of two heads and two blocks of
    one differ in the last bits, each within the tolerance."""
    a, x, dt, b, c, dy, ds = _case(1, 2, 1, 128, 16, 16, seed=5)
    _, _, states = pss.ssd_scan_plain(a, x, dt, b, c, q=64, rep=2,
                                      return_states=True)
    one = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, ds, 64, 2, 1)
    two = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, ds, 64, 2, 2)
    assert torch.equal(one[1], two[1])          # dx is a head's own
    assert not torch.equal(one[3], two[3])      # dB's rounding is the block's
    want = pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, ds, q=64,
                                  rep=2)
    for got in (one, two):
        for gt, w, name in zip(got, want, NAMES):
            _close(gt, w.float().numpy(), name, LM_TOL[gt.dtype])


def test_emulation_without_a_state_gradient():
    a, x, dt, b, c, dy, ds = _case(1, 2, 1, 128, 16, 16, seed=6)
    _, _, states = pss.ssd_scan_plain(a, x, dt, b, c, q=64, rep=2,
                                      return_states=True)
    got = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states, None, 64, 2, 2)
    zero = ssd_bwd_wgmma_emulation(a, x, dt, b, c, dy, states,
                                   torch.zeros_like(ds), 64, 2, 2)
    for gt, w in zip(got, zero):
        assert torch.equal(gt, w)


@pytest.mark.parametrize("p,n,q,rep,want", [
    (64, 128, 256, 64, 2),    # Mamba2-1.3B's training shape
    (64, 64, 256, 112, 2),    # Zamba2-7B's
    (128, 128, 64, 4, 1),     # P past 64: both warpgroups on one head
    (16, 16, 64, 1, 1),       # a group of one head
    (64, 128, 832, 64, 1),    # two heads' rows of the chunk no longer fit
    (64, 64, 1024, 112, 2)])
def test_bwd_wgmma_heads(p, n, q, rep, want):
    assert pss.bwd_wgmma_heads(p, n, q, rep) == want


@pytest.mark.parametrize("n,p,q_max", [(128, 64, 4544), (64, 64, 6592),
                                       (128, 128, 1024)])
def test_bwd_wgmma_refuses_past_shared_memory(n, p, q_max):
    """Past the chunk one head's block holds the wrapper raises, naming
    the limit, with no fallback; the limit itself still fits."""
    assert pss.bwd_wgmma_max_q(n, p) == q_max
    assert pss.bwd_wgmma_smem(n, p, q_max, 1) <= pss._SMEM_LIMIT
    assert pss.bwd_wgmma_heads(p, n, q_max, 64) == 1
    with pytest.raises(ValueError, match=f"holds {q_max} steps"):
        pss.bwd_wgmma_heads(p, n, q_max + 1, 64)


@pytest.mark.parametrize("n,p,q,nh,want", [
    (128, 64, 256, 2, 210024), (64, 64, 256, 2, 152680),
    (128, 128, 64, 1, 200768), (8, 11, 11, 1, 101696)])
def test_bwd_wgmma_smem(n, p, q, nh, want):
    """The bytes csrc/ssd_scan.cu's `bwd_wgmma_smem` asks for (the card's
    run of `chip_smoke.py` checks the two agree)."""
    assert pss.bwd_wgmma_smem(n, p, q, nh) == want


def test_shared_memory_model_matches_the_source():
    """The wrapper's model uses the source's block of two warpgroups and
    its 64-row tiles, and the limits it computes are the ones the
    source's header states."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    assert "constexpr int kBwdThreads = 256;" in src
    assert "constexpr int kTile = 64;" in src and pss._TILE == 64
    text = " ".join(line.strip().lstrip("/").strip()
                    for line in src.splitlines())
    for n, p, words in ((128, 64, "4,544 at P 64, N 128"),
                        (64, 64, "6,592 at P = N = 64"),
                        (128, 128, "1,024 at P = N = 128")):
        assert words in text
        assert f"{pss.bwd_wgmma_max_q(n, p):,}" == words.split()[0]
    assert "two heads a block up to 768 at P 64, N 128" in text
    assert pss.bwd_wgmma_heads(64, 128, 768, 64) == 2
    assert pss.bwd_wgmma_heads(64, 128, 769, 64) == 1
