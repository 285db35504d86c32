"""Public wrappers around the LM kernels (shape plumbing, GQA grouping,
plane packing), in the reference's layouts: (B, L, H, D) for attention,
(Bt, H, L, P) for the SSD scan. Each takes `device=None` (the card) and
passes it to its kernel's wrapper, which runs the plain version only on
the CPU.

Under tensor parallelism `gqa_flash_attention` takes DTensors (q split
over heads, k and v replicated) and runs the flash kernels, forward and
backward, on each rank's heads through `local_map`."""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike
from repro_torch.kernels import ref as R
from repro_torch.kernels.bitplane_matmul import bitplane_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan


def quantized_linear(x, w, *, bits: int = 8, tm: int = 128, tn: int = 128,
                     tk: int = 128, device: DeviceLike = None):
    """x: (..., K) @ w: (K, N) through the bit-plane kernel."""
    planes, scales, _ = R.quantize_weights(w, bits)
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    m = xm.shape[0]
    pad = (-m) % tm
    if pad:
        xm = F.pad(xm, (0, 0, 0, pad))
    out = bitplane_matmul(xm.contiguous(), planes, scales, bits=bits, tm=tm,
                          tn=tn, tk=tk, device=device)
    return out[:m].reshape(*lead, w.shape[1])


def _local_gqa(q, k, v, *, g: int, first: int, group, **kw):
    """One rank's attention: its query heads [first, first + H_r) of a
    GQA layer whose groups have `g` heads, against the whole k and v,
    whose gradients the ranks' heads sum over `group` (None: this rank
    has every head)."""
    if group is not None:
        from repro_torch.distributed.meshctx import sum_grads
        k, v = sum_grads(k, group), sum_grads(v, group)
    hr = q.shape[2]
    lo, hi = first // g, (first + hr - 1) // g + 1
    reps = [min((j + 1) * g, first + hr) - max(j * g, first)
            for j in range(lo, hi)]
    if len(set(reps)) == 1:
        k, v = (t[:, :, lo:hi].repeat_interleave(reps[0], dim=2)
                for t in (k, v))
    else:
        r = torch.tensor(reps, device=q.device)
        k, v = (t[:, :, lo:hi].repeat_interleave(r, dim=2) for t in (k, v))
    return gqa_flash_attention(q, k, v, **kw)


def _gqa_on_heads(q, k, v, **kw):
    """`gqa_flash_attention` of DTensors on one mesh: q split over heads
    (or replicated), k and v replicated (`shard_act`), each rank's heads
    through the kernel on its own tensors."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.meshctx import shard_act
    k = shard_act(k, "batch", None, None, None)
    v = shard_act(v, "batch", None, None, None)
    mesh = q.device_mesh
    first, group = 0, None
    for i, p in enumerate(q.placements):
        if p.is_shard(2):
            first = mesh.get_local_rank(i) * (q.shape[2] // mesh.size(i))
            group = mesh.get_group(i)
        elif not p.is_replicate():
            raise ValueError(f"attention of q placed {q.placements}")
    whole = (Replicate(),) * mesh.ndim
    return local_map(
        partial(_local_gqa, g=q.shape[2] // k.shape[2], first=first,
                group=group, **kw),
        out_placements=list(q.placements),
        in_placements=(q.placements, whole, whole),
        in_grad_placements=(q.placements, whole, whole),
        device_mesh=mesh)(q, k, v)


def gqa_flash_attention(q, k, v, *, causal: bool = True, tq: int = 128,
                        tk: int = 128, window: int = 0,
                        device: DeviceLike = None):
    """q: (B, L, H, D); k/v: (B, L, Hkv, D) -> (B, L, H, D); `window`: the
    sliding window of a local layer (0: none). DTensors run on each
    rank's heads (`_gqa_on_heads`)."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(q):
        return _gqa_on_heads(q, k, v, causal=causal, tq=tq, tk=tk,
                             window=window, device=device)
    b, l, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, l, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, l, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, l, d).contiguous()
    o = flash_attention(qf, kf, vf, causal=causal, tq=min(tq, l),
                        tk=min(tk, l), window=window, device=device)
    return o.reshape(b, h, l, d).transpose(1, 2)


def ssd(x, dt, A, B, C, *, q: int = 64, return_state: bool = False,
        device: DeviceLike = None):
    """x: (Bt, H, L, P); dt: (Bt, H, L); A: (H,); B/C: (Bt, G, L, N) with
    G dividing H. Returns y: (Bt, H, L, P), and with `return_state` also
    the state after the last step, (Bt, H, N, P) float32."""
    bt, h, l, p = x.shape
    g, n = B.shape[1], B.shape[-1]
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    y, state = ssd_scan(
        A.to(torch.float32).repeat(bt),
        x.reshape(bt * h, l, p).contiguous(),
        dt.to(torch.float32).reshape(bt * h, l).contiguous(),
        B.reshape(bt * g, l, n).contiguous(),
        C.reshape(bt * g, l, n).contiguous(),
        q=min(q, l), rep=h // g, device=device)
    y = y.reshape(bt, h, l, p)
    if return_state:
        return y, state.reshape(bt, h, n, p)
    return y
