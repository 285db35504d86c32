"""The backward of the port's SSD scan on the CPU: its plain version
`ssd_scan_bwd_plain` (the formula the `ssd_scan_bwd` kernel is held to
on the card), the forward's saved chunk-entry states and the `SSDScan`
autograd Function through `ssd_scan` and `ops.ssd`.

Witnesses: torch.autograd through `ssd_scan_plain` (the forward the
kernel computes), and `jax.vjp` of the reference's `models/mamba.py::
ssd_chunked` (with D = 0: the residual stays outside the scan) and of
its sequential oracle `kernels/ref.py::ssd_ref`, through both outputs, y
and the final state. The reference's Pallas kernel has no VJP rule.

Tolerances, times max(1, the gradient's largest magnitude): against
autograd of the same float32 arithmetic, summed in another order, 1e-5;
a bfloat16 gradient (dx, dB, dC) is rounded once from float32 sums that
differ in their last bits, so it may land one bfloat16 step (2^-8
relative) apart. Against the reference, `LM_TOL`: 1e-4 in float32, 1e-2
in bfloat16 (the reference's chunking and its sequential oracle sum in
another order, and round y once more before the cotangent flows back).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.kernels import ref as rref
from repro.models import mamba as rmamba
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as pss

LM_TOL = {"f32": 1e-4, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (bt, h, g, l, p, n, q): one chunk, and three or four; one group and two
SHAPES = [(2, 4, 1, 32, 16, 8, 32), (2, 4, 2, 96, 16, 16, 32),
          (2, 4, 1, 128, 16, 12, 32), (2, 4, 2, 64, 16, 8, 32)]
NAMES = ("da", "dx", "ddt", "db", "dc")


def _inputs(bt, h, g, l, p, n, dtype, seed=0):
    """numpy-seeded (x, dt, A, B, C, dy, ds) in the reference's scan
    layout ((Bt, H, L, P), (Bt, H, L), (H,), (Bt, G, L, N) twice, then
    the cotangents of y and of the final state), bfloat16 values rounded
    once, as numpy float32."""
    rng = np.random.default_rng(seed)
    jd, _ = DTYPES[dtype]

    def rnd(a):
        return np.asarray(jnp.asarray(a, jnp.float32).astype(jd)
                          .astype(jnp.float32))

    x = rnd(rng.normal(size=(bt, h, l, p)))
    dt = np.log1p(np.exp(rng.normal(size=(bt, h, l)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    b = rnd(rng.normal(size=(bt, g, l, n)) * 0.5)
    c = rnd(rng.normal(size=(bt, g, l, n)) * 0.5)
    dy = rnd(rng.normal(size=(bt, h, l, p)))
    ds = rng.normal(size=(bt, h, n, p)).astype(np.float32)
    return x, dt, a, b, c, dy, ds


def _kernel_layout(x, dt, a, b, c, dy, ds, dtype):
    """The same values as the kernel's tensors: a (BH,), x (BH, L, P), dt
    (BH, L), b, c (Bt G, L, N), dy, ds (BH, ...)."""
    td = DTYPES[dtype][1]
    bt, h, l, p = x.shape
    g, n = b.shape[1], b.shape[-1]

    def t(v):
        return torch.from_numpy(np.array(v))
    return (t(np.tile(a, bt)), t(x.reshape(bt * h, l, p)).to(td),
            t(dt.reshape(bt * h, l)), t(b.reshape(bt * g, l, n)).to(td),
            t(c.reshape(bt * g, l, n)).to(td),
            t(dy.reshape(bt * h, l, p)).to(td), t(ds.reshape(bt * h, n, p)))


def _scale(want):
    return max(1.0, float(np.abs(want).max()))


def _close(got, want, tol, what, rounding=0.0):
    """|got - want| <= tol max(1, |want|max) + rounding |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, what
    err = np.abs(got - want) - rounding * np.abs(want)
    assert float(err.max()) <= tol * _scale(want), \
        f"{what}: {float(np.abs(got - want).max())} past {tol} x " \
        f"{_scale(want)}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_equals_autograd_of_the_forward(shape, dtype):
    bt, h, g, l, p, n, q = shape
    a, x, dt, b, c, dy, ds = _kernel_layout(*_inputs(*shape[:-1], dtype),
                                            dtype)
    rep = h // g
    # autograd over the float32 values, so its own sums stay float32
    ins = [t.float().requires_grad_() for t in (a, x, dt, b, c)]
    y, s = pss.ssd_scan_plain(*ins, q=q, rep=rep)
    want = torch.autograd.grad((y, s), ins, (dy.float(), ds))
    _, _, states = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep,
                                      return_states=True)
    got = pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, ds, q=q,
                                 rep=rep)
    for name, gt, w, inp in zip(NAMES, got, want, (a, x, dt, b, c)):
        assert gt.dtype == inp.dtype, name
        bf = dtype == "bf16" and name in ("dx", "db", "dc")
        _close(gt, w, 1e-5, name, 2.0 ** -8 if bf else 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_plain_without_a_state_gradient(dtype):
    """ds_final None is a zero gradient of the final state."""
    shape = SHAPES[1]
    bt, h, g, l, p, n, q = shape
    a, x, dt, b, c, dy, ds = _kernel_layout(*_inputs(*shape[:-1], dtype),
                                            dtype)
    _, _, states = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=h // g,
                                      return_states=True)
    got = pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, states, None, q=q,
                                 rep=h // g)
    want = pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, states,
                                  torch.zeros_like(ds), q=q, rep=h // g)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)


def _ref_grads(fn, x, dt, a, b, c, dy, ds, dtype):
    """jax.vjp of fn(x, dt, A, B, C) -> (y (Bt, H, L, P), s) at the
    reference's dtypes, cotangents (dy, ds)."""
    jd = DTYPES[dtype][0]
    prim = (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(b).astype(jd), jnp.asarray(c).astype(jd))
    (y, s), vjp = jax.vjp(fn, *prim)
    return vjp((jnp.asarray(dy).astype(y.dtype), jnp.asarray(ds)))


def _chunked(q):
    perm = (0, 2, 1, 3)

    def fn(x, dt, a, b, c):
        y, s = rmamba.ssd_chunked(x.transpose(perm), dt.transpose(0, 2, 1),
                                  a, b.transpose(perm), c.transpose(perm),
                                  jnp.zeros(a.shape), chunk=q,
                                  return_state=True)
        return y.transpose(perm), s
    return fn


def _oracle(x, dt, a, b, c):
    h = x.shape[1]
    rep = h // b.shape[1]
    return rref.ssd_ref(x, dt, a, jnp.repeat(b, rep, axis=1),
                        jnp.repeat(c, rep, axis=1))


def _port_grads(x, dt, a, b, c, dy, ds, q, dtype):
    """autograd through `ops.ssd` on the CPU: `SSDScan`'s plain forward
    and `ssd_scan_bwd_plain`, in the reference's layout."""
    td = DTYPES[dtype][1]

    def t(v):
        return torch.from_numpy(np.array(v))
    ins = [t(x).to(td), t(dt), t(a), t(b).to(td), t(c).to(td)]
    ins = [v.requires_grad_() for v in ins]
    y, s = ops.ssd(*ins, q=q, return_state=True, device="cpu")
    return torch.autograd.grad((y, s), ins, (t(dy).to(td), t(ds)))


# the sequential oracle steps one position at a time: its shapes stop at
# L = 96 (three chunks)
VJP_CASES = [(shape, "ssd_chunked") for shape in SHAPES] + [
    (shape, "ssd_ref") for shape in SHAPES if shape[3] <= 96]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,witness", VJP_CASES)
def test_bwd_plain_equals_the_reference_vjp(shape, witness, dtype):
    q = shape[-1]
    x, dt, a, b, c, dy, ds = _inputs(*shape[:-1], dtype, seed=1)
    fn = _chunked(q) if witness == "ssd_chunked" else _oracle
    want = _ref_grads(fn, x, dt, a, b, c, dy, ds, dtype)
    got = _port_grads(x, dt, a, b, c, dy, ds, q, dtype)
    for name, gt, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(gt, w, LM_TOL[dtype], f"{witness} {name}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_saved_states_equal_the_oracle_at_chunk_boundaries(dtype):
    """The forward's S_c, the state before chunk c >= 1, equals the
    sequential oracle's final state over the first c chunks."""
    bt, h, g, l, p, n, q = SHAPES[2]
    x, dt, a, b, c, dy, ds = _inputs(bt, h, g, l, p, n, dtype, seed=2)
    ka, kx, kdt, kb, kc, _, _ = _kernel_layout(x, dt, a, b, c, dy, ds,
                                               dtype)
    y, s_final, states = pss._forward(ka, kx, kdt, kb, kc, q, h // g,
                                      torch.device("cpu"), True)
    assert states.shape == (bt * h, l // q - 1, n, p)
    jd = DTYPES[dtype][0]
    for ci in range(1, l // q):
        cut = slice(0, ci * q)
        _, want = _oracle(jnp.asarray(x[:, :, cut]).astype(jd),
                          jnp.asarray(dt[:, :, cut]), jnp.asarray(a),
                          jnp.asarray(b[:, :, cut]).astype(jd),
                          jnp.asarray(c[:, :, cut]).astype(jd))
        _close(states[:, ci - 1].reshape(bt, h, n, p), want, 1e-4,
               f"state before chunk {ci}")
    _, want = _oracle(jnp.asarray(x).astype(jd), jnp.asarray(dt),
                      jnp.asarray(a), jnp.asarray(b).astype(jd),
                      jnp.asarray(c).astype(jd))
    _close(s_final.reshape(bt, h, n, p), want, 1e-4, "final state")


def test_one_chunk_saves_no_state():
    a, x, dt, b, c, dy, ds = _kernel_layout(*_inputs(*SHAPES[0][:-1],
                                                     "f32"), "f32")
    _, _, states = pss._forward(a, x, dt, b, c, 32, 4, torch.device("cpu"),
                                True)
    assert states.shape == (8, 0, 8, 16)


def test_ssd_scan_function_counts_one_plain_forward_and_backward():
    shape = SHAPES[1]
    bt, h, g, l, p, n, q = shape
    a, x, dt, b, c, dy, ds = _kernel_layout(*_inputs(*shape[:-1], "f32"),
                                            "f32")
    ins = [t.requires_grad_() for t in (a, x, dt, b, c)]
    pss.reset_counts()
    y, s = pss.ssd_scan(*ins, q=q, rep=h // g, device="cpu")
    assert y.grad_fn is not None and s.grad_fn is not None
    got = torch.autograd.grad((y, s), ins, (dy, ds))
    counts = (pss.ssd_scan.plain_calls, pss.ssd_scan.bwd_plain_calls,
              pss.ssd_scan.launches, pss.ssd_scan.bwd_launches)
    assert counts == (1, 1, 0, 0)
    _, _, states = pss.ssd_scan_plain(*(t.detach() for t in ins), q=q,
                                      rep=h // g, return_states=True)
    want = pss.ssd_scan_bwd_plain(*(t.detach() for t in ins), dy, states,
                                  ds, q=q, rep=h // g)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)
    # a loss through y alone: the final state's gradient is None (zero)
    pss.reset_counts()
    y, _ = pss.ssd_scan(*ins, q=q, rep=h // g, device="cpu")
    torch.autograd.grad(y, ins, dy)
    assert (pss.ssd_scan.plain_calls, pss.ssd_scan.bwd_plain_calls) == (1, 1)
    with torch.no_grad():
        y, _ = pss.ssd_scan(*ins, q=q, rep=h // g, device="cpu")
    assert y.grad_fn is None


def test_bwd_wrapper_refuses_wrong_shapes_and_dtypes():
    shape = SHAPES[1]
    bt, h, g, l, p, n, q = shape
    a, x, dt, b, c, dy, ds = _kernel_layout(*_inputs(*shape[:-1], "f32"),
                                            "f32")
    _, _, st = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=h // g,
                                  return_states=True)
    rep = h // g
    good = dict(a=a, x=x, dt=dt, b=b, c=c, dy=dy, states=st, ds_final=ds)

    def call(**kw):
        args = dict(good, **kw)
        return pss.ssd_scan_bwd(args["a"], args["x"], args["dt"], args["b"],
                                args["c"], args["dy"], args["states"],
                                args["ds_final"], q=q, rep=rep, device="cpu")
    call()
    for kw, match in (({"dy": dy[:, :-1]}, "dy has shape"),
                      ({"states": st[:, :1]}, "states has shape"),
                      ({"ds_final": ds[:, :-1]}, "ds_final has shape"),
                      ({"b": b[:1]}, "b has shape"),
                      ({"dt": dt.double()}, "dt has dtype"),
                      ({"dy": dy.bfloat16()}, "dy has dtype"),
                      ({"x": x.double()}, "float32 or bfloat16"),
                      ({"states": st.bfloat16()}, "states has dtype")):
        with pytest.raises(ValueError, match=match):
            call(**kw)
    with pytest.raises(ValueError, match="divide"):
        pss.ssd_scan_bwd(a, x, dt, b, c, dy, st, ds, q=40, rep=rep,
                         device="cpu")
    with pytest.raises(ValueError, match="divide"):
        pss.ssd_scan_bwd(a, x, dt, b, c, dy, st, ds, q=q, rep=3,
                         device="cpu")


@pytest.mark.parametrize("bh,rep,sms,want", [
    (512, 64, 132, 4),      # Mamba2-1.3B's training shape: 128 blocks
    (896, 112, 132, 7),     # Zamba2-7B's: 128 blocks
    (8, 4, 132, 1),         # a small grid: one head a block
    (16, 16, 4, 4)])
def test_backward_heads_a_block(bh, rep, sms, want):
    """The divisor of rep whose grid fills the SMs in the fewest waves of
    the fewest heads, the most heads on a tie."""
    hb = pss.heads_a_block(bh, rep, sms)
    assert hb == want and rep % hb == 0
