"""Flash attention: the CUDA kernels, their wrappers, their plain versions
and the autograd Function that joins the forward and the backward.

`flash_attention` (csrc/flash_attention.cu) replaces the TPU kernel
`repro/kernels/flash_attention.py::flash_attention`: causal or full
online-softmax attention over heads flattened into the batch, q, k, v
(BH, L, D), float32 arithmetic, the output in q's type. For a causal
mask the TPU kernel reads, for query tile qi of tq rows, the KV tiles of
tk keys below clamp((qi + 1) tq // tk, 1, L // tk), and inside them the
keys kpos <= qpos: the kernels and the plain versions keep that bound.
With a sliding `window` (causal, tq == tk) each query tile reads the KV
tiles from max(qi - window // tk, 0) on, and inside them the keys with
qpos - kpos < window: the reference's windowed `chunked_attention`,
whose tile bound drops keys inside the window when window % tk > 1. The
kernels take it as a lower key limit beside the upper one,
max(qpos - window + 1, max(qpos // tq - window // tk, 0) tk), and skip
the key tiles below a block's rows. Head dims 1 to 256.
The GQA grouping is done by `kernels/ops.py` before flattening. For
bfloat16 the forward kernel multiplies on the tensor cores, with float32
scores, softmax and accumulator, and rounds P to bfloat16 for the P v
product: the one rounding the plain version lacks (within a bfloat16
step). Every bfloat16 head dim runs `flash_fwd_wgmma` (Hopper's `wgmma`
and TMA, 128 query rows a block in two warpgroups that take turns on the
tensor cores, k and v in rings of 64-key tiles; builds of 64, 128, 192
and 256 columns; the source's header has the design). Its input
contract is TMA's: rows of a multiple of 8 values on 16-byte aligned
bases, so the wrapper hands it `wgmma_operand(q)` etc. (zero columns up
to `wgmma_width(D)`, or a fresh copy of a misaligned tensor), launches
at the true D's scale D^-1/2, and slices the output back: exact, since
zero columns add nothing to q k^T and give zero output columns. The
padding is the contract, not a fallback: a failed launch raises.

The TPU kernel has no backward: the reference trains through its jnp
chunked attention and autodiff. The port trains through the kernel, so
`flash_attention_bwd` (the `flash_bwd_*` kernels of the same source) is
the gradient of the function the forward computes, bound included. The
forward saves each row's log-sum-exp `lse = m + log(den)` (float32, BH x
L), and the backward recomputes P = exp(scale q k^T - lse) tile by tile:
D_i = rowsum(dO o), dV = P^T dO, dS = P (dO v^T - D), dQ = scale dS k,
dK = scale dS^T q, with float32 sums, the outputs in q's type. For
bfloat16 the two backward kernels multiply on the tensor cores and round
P to bfloat16 for P^T dO and dS for dS k and dS^T q: the two roundings
the plain version lacks (within a bfloat16 step each). Every bfloat16
head dim runs `flash_bwd_dq_wgmma` then `flash_bwd_dkdv_wgmma` (`wgmma`
and TMA, two warpgroups a block, builds of 64, 128, 192 and 256 columns:
to D 128 each warpgroup owns 64 of a block's 128 query rows, or keys,
and runs the whole chain on them; past it the dQ pass's warpgroups split
a 64-key tile's keys and the dK/dV pass's split by role, one forming P^T
and dV, the other dS^T and dK from the P^T it hands over; the source's
header has the design and what bounds it). They take the forward's
contract: the wrapper hands them `wgmma_operand` of q, k, v, o and dO,
launches at the true D's scale and slices dq, dk and dv back (exact:
zero columns get zero gradients). No gradient falls back to another
kernel or to the plain version: a failed launch raises.
`FlashAttention` is the autograd Function: on the card the forward
kernel then the backward kernel, on the CPU the plain forward then
`flash_attention_bwd_plain`, so the CPU tests run the formula the
backward kernel is held to.

`flash_attention_plain` and `flash_attention_bwd_plain` are the
arithmetic tile by tile in eager torch (any device). The wrappers take
`device=None` (meaning "cuda"): on a CUDA device they launch the kernel
on the current stream or raise; only for CPU tensors do they run the
plain version. `flash_attention` computes the log-sum-exp only when
autograd records and an input needs a gradient, so serving launches the
forward as before. Counts on `flash_attention`: `.launches` and
`.plain_calls` (forward), `.bwd_launches` and `.bwd_plain_calls`;
`.wgmma_launches` counts the forward launches that ran
`flash_fwd_wgmma` (also in `.launches`: every bfloat16 one),
`.bwd_wgmma_launches` the backward launches that ran the wgmma pair
(also in `.bwd_launches`: every bfloat16 one); `reset_counts()` zeroes
them.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build
from repro_torch.kernels._grad import needs_grad
from repro_torch.kernels.iss_stepper import _check, _on_cpu, _raise_on

NEG_INF = -1e30
F32 = torch.float32
_DTYPES = (torch.float32, torch.bfloat16)


def wgmma_width(d: int) -> int:
    """The row width the wgmma kernels read head dim d at: d rounded up
    to a multiple of 8, since TMA takes 16-byte row strides."""
    return -(-d // 8) * 8


def wgmma_operand(t: torch.Tensor) -> torch.Tensor:
    """t (BH, L, d) as the wgmma kernels take it: zero columns up to
    `wgmma_width(d)`, and a fresh copy where its data is not 16-byte
    aligned (TMA's base addresses); else t itself."""
    d8 = wgmma_width(t.shape[-1])
    if d8 != t.shape[-1]:
        return torch.nn.functional.pad(t, (0, d8 - t.shape[-1]))
    return t.clone() if t.data_ptr() % 16 else t


def _kv_tiles(qi: int, tq: int, tk: int, n_kv: int, causal: bool,
              window: int) -> range:
    """The KV tiles query tile qi reads: below the TPU kernel's bound,
    and with a window from the reference's windowed chunk bound on."""
    upper = min(max((qi + 1) * tq // tk, 1), n_kv) if causal else n_kv
    return range(max(qi - window // tk, 0) if window else 0, upper)


def _scores(qt, kt, qi, ki, tq, tk, causal, window):
    """Scaled scores of query tile qi against KV tile ki, masked keys at
    NEG_INF."""
    s = qt @ kt.transpose(1, 2)
    if causal:
        dev = qt.device
        qpos = qi * tq + torch.arange(tq, device=dev)[:, None]
        kpos = ki * tk + torch.arange(tk, device=dev)[None, :]
        ok = kpos <= qpos
        if window:
            ok &= qpos - kpos < window
        s = torch.where(ok, s, torch.full((), NEG_INF, device=dev))
    return s


def _check_window(window: int, causal: bool, tq: int, tk: int) -> None:
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    if window and (not causal or tq != tk):
        raise ValueError(f"a window ({window}) needs causal attention and "
                         f"tq == tk (here causal={causal}, tq={tq}, "
                         f"tk={tk}): the reference defines the windowed "
                         f"function over one chunk size")


def flash_attention_plain(q, k, v, *, causal: bool = True, tq: int = 128,
                          tk: int = 128, window: int = 0,
                          return_lse: bool = False):
    """The TPU kernel's tiles, running max, denominator and accumulator,
    tile by tile, batched over BH. With `return_lse` also each row's
    log-sum-exp of its scaled scores, (BH, L) float32."""
    _check_window(window, causal, tq, tk)
    bh, l, d = q.shape
    scale = d ** -0.5
    qf = q.to(F32) * scale
    kf, vf = k.to(F32), v.to(F32)
    n_kv = l // tk
    dev = q.device
    out = torch.empty((bh, l, d), dtype=q.dtype, device=dev)
    lse = torch.empty((bh, l), dtype=F32, device=dev)
    for qi in range(l // tq):
        qt = qf[:, qi * tq:(qi + 1) * tq]
        m = torch.full((bh, tq, 1), NEG_INF, dtype=F32, device=dev)
        den = torch.zeros((bh, tq, 1), dtype=F32, device=dev)
        acc = torch.zeros((bh, tq, d), dtype=F32, device=dev)
        for ki in _kv_tiles(qi, tq, tk, n_kv, causal, window):
            kt = kf[:, ki * tk:(ki + 1) * tk]
            vt = vf[:, ki * tk:(ki + 1) * tk]
            s = _scores(qt, kt, qi, ki, tq, tk, causal, window)
            m2 = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2)
            den = den * corr + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * corr + p @ vt
            m = m2
        den = torch.clamp_min(den, 1e-30)
        out[:, qi * tq:(qi + 1) * tq] = (acc / den).to(q.dtype)
        lse[:, qi * tq:(qi + 1) * tq] = (m + torch.log(den))[..., 0]
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              tq: int = 128, tk: int = 128, window: int = 0):
    """dQ, dK, dV of `flash_attention_plain` at output o and its gradient
    dO, from the forward's log-sum-exp: P recomputed tile by tile over
    the forward's tiles and bounds, float32 sums, outputs in q's type."""
    _check_window(window, causal, tq, tk)
    bh, l, d = q.shape
    scale = d ** -0.5
    qf = q.to(F32) * scale
    kf, vf, dof = k.to(F32), v.to(F32), do.to(F32)
    dsum = torch.sum(dof * o.to(F32), dim=-1)           # D, (BH, L)
    n_kv = l // tk
    dq = torch.zeros((bh, l, d), dtype=F32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for qi in range(l // tq):
        rows = slice(qi * tq, (qi + 1) * tq)
        qt, dot = qf[:, rows], dof[:, rows]
        for ki in _kv_tiles(qi, tq, tk, n_kv, causal, window):
            keys = slice(ki * tk, (ki + 1) * tk)
            s = _scores(qt, kf[:, keys], qi, ki, tq, tk, causal, window)
            p = torch.exp(s - lse[:, rows, None])
            dv[:, keys] += p.transpose(1, 2) @ dot
            ds = p * (dot @ vf[:, keys].transpose(1, 2)
                      - dsum[:, rows, None])
            dq[:, rows] += ds @ kf[:, keys]
            dk[:, keys] += ds.transpose(1, 2) @ qt
    return (dq * scale).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_shape(l: int, tq: int, tk: int, causal: bool,
                 window: int) -> None:
    if l % tq or l % tk:
        raise ValueError(f"L = {l} must divide by tq = {tq} and tk = {tk}")
    _check_window(window, causal, tq, tk)


def _check_card(q) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}: float32 or bfloat16")
    if not 1 <= q.shape[2] <= 256:
        raise ValueError(f"head dim {q.shape[2]}: the kernel takes 1 to 256")


def _forward(q, k, v, causal, tq, tk, window, dev, with_lse):
    """(o, lse or None): the kernel on the card, the plain version on the
    CPU."""
    bh, l, d = q.shape
    _check_shape(l, tq, tk, causal, window)
    if dev.type == "cpu":
        _on_cpu(q=q, k=k, v=v)
        flash_attention.plain_calls += 1
        out = flash_attention_plain(q, k, v, causal=causal, tq=tq, tk=tk,
                                    window=window, return_lse=with_lse)
        return out if with_lse else (out, None)
    _check_card(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev, q.dtype, (bh, l, d))
    wgmma = q.dtype == torch.bfloat16
    if wgmma:   # the kernel's input contract, at the true D's scale
        q, k, v = (wgmma_operand(t) for t in (q, k, v))
    dr = q.shape[-1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, l), dtype=F32, device=dev) if with_lse else None
    fn = getattr(_build.load("flash_attention"), "flash_attention_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(),
                0 if lse is None else lse.data_ptr(), bh, l, dr,
                int(causal), tq, tk, window, d ** -0.5, stream)
    _raise_on(rc, "flash_attention launch")
    flash_attention.launches += 1
    flash_attention.wgmma_launches += wgmma
    return (o[..., :d].contiguous() if dr != d else o), lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        tq: int = 128, tk: int = 128, window: int = 0,
                        device: DeviceLike = None):
    """(dq, dk, dv) in q's dtype, from the forward's inputs, its output o,
    the output's gradient do (all (BH, L, D)) and its log-sum-exp lse
    ((BH, L) float32)."""
    dev = resolve(device)
    bh, l, d = q.shape
    _check_shape(l, tq, tk, causal, window)
    if dev.type == "cpu":
        _on_cpu(q=q, k=k, v=v, o=o, do=do, lse=lse)
        flash_attention.bwd_plain_calls += 1
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=tq, tk=tk, window=window)
    _check_card(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check(name, t, dev, q.dtype, (bh, l, d))
    _check("lse", lse, dev, F32, (bh, l))
    wgmma = q.dtype == torch.bfloat16
    if wgmma:   # the kernels' input contract, at the true D's scale
        q, k, v, o, do = (wgmma_operand(t) for t in (q, k, v, o, do))
    dr = q.shape[-1]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # scratch: D = rowsum(dO o), (BH, L), for the float32 kernels; for the
    # wgmma pair each head's lse log2 e, D and key limits in 64-row
    # chunks, (BH, 4, L rounded up to 64)
    dsum = torch.empty(4 * bh * -(-l // 64) * 64, dtype=F32, device=dev)
    fn = getattr(_build.load("flash_attention"), "flash_attention_bwd_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
                bh, l, dr, int(causal), tq, tk, window, d ** -0.5, stream)
    _raise_on(rc, "flash_attention_bwd launch")
    flash_attention.bwd_launches += 1
    flash_attention.bwd_wgmma_launches += wgmma
    if dr != d:
        return tuple(x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """`FlashAttention.apply(q, k, v, causal, tq, tk, window, device)`:
    the forward saving its log-sum-exp, and `flash_attention_bwd` as its
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, tq, tk, window, dev):
        o, lse = _forward(q, k, v, causal, tq, tk, window, dev, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, tq, tk, window, dev)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, tq, tk, window, dev = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=causal, tq=tq, tk=tk,
                                         window=window, device=dev)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, tq: int = 128,
                    tk: int = 128, window: int = 0, device: DeviceLike = None
                    ) -> torch.Tensor:
    """q, k, v: (BH, L, D), heads pre-flattened into the batch dim.

    Returns (BH, L, D) in q's dtype, differentiable in q, k and v. L must
    divide by tq and tk; a `window` needs causal attention and tq == tk."""
    dev = resolve(device)
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, tq, tk, window, dev)
    return _forward(q, k, v, causal, tq, tk, window, dev, False)[0]


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-call counts."""
    flash_attention.launches = 0
    flash_attention.wgmma_launches = 0
    flash_attention.plain_calls = 0
    flash_attention.bwd_launches = 0
    flash_attention.bwd_wgmma_launches = 0
    flash_attention.bwd_plain_calls = 0


reset_counts()
