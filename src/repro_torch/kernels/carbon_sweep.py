"""The carbon sweep's CUDA kernel, its wrapper and its plain version.

`sweep_tile` (csrc/carbon_sweep.cu, arithmetic in carbon_sweep.cuh)
replaces the TPU kernel `repro/kernels/carbon_sweep.py::sweep_tile`
(`path="pallas"`): for one tile of Tc scenario cells with N Monte Carlo
lifetime draws and C candidates (core x redundancy) it evaluates the
total-carbon surface, picks the carbon-optimal candidate per draw, and
reduces per cell over the draws (chosen-candidate counts, sum/min/max of
the best totals, chosen embodied and operational sums). Across the
sweep it adds the tile's valid cells into a log10 histogram of best
totals and merges a per-embodied-bin Pareto champion, lexicographic in
(operational kg, cell, draw), into running accumulators (`SweepAcc`).

`sweep_tile_drawn` is the same kernel body built to draw the lifetimes
itself (csrc/sweep_draws.cuh): each cell's key is `fold_in(key,
cell_idx)`, draw d takes its two uniforms from counters 2d and 2d + 1,
and the cell's inverse-CDF mixture turns them into days in registers, so
the sweep's uniforms and lifetimes never reach device memory. It can
write the lifetimes it drew (`life_out`) and skip `best_core`.

`sweep_tile_plain` is the reference's shared arithmetic (`_totals`,
`_cell_reduce`, `_log_bin`, `_hist_contrib`, `_pareto_candidate`,
`_pareto_merge`) op for op in eager torch; it returns new tensors.
`sweep_tile_drawn_plain` draws with `sweep_draws.py` (prng.py's
threefry bits, then `lifetimes`), divides by `day_s` and calls it.

The wrappers take `device=None` (meaning "cuda") and check every tensor
against it. On a CUDA device they launch the kernel on the current
stream or raise, and update the accumulators in place (the counterpart
of the TPU kernel's `input_output_aliases`); only for CPU tensors do
they run the plain version. Each counts `.launches` (wrapper calls that
launched the kernel, whatever number of CUDA launches each makes) and
`.plain_calls`; `reset_counts()` zeroes them all. The kernel keeps a
column of counts and champions per candidate for each thread in shared
memory and narrows its blocks (down to one warp) until the columns fit,
so it takes several hundred candidates; past that the launch raises.

What is held exactly between the kernel, the plain version and the
reference: totals, the argmin (first minimum wins), counts, min, max,
the histogram and all six Pareto fields. The per-cell sums cannot follow
any one reduction order; any two orders of N non-negative terms differ
by a relative 2 (N - 1) u at most (u = 2**-24 in float32, 2**-53 in
float64). `log10` differs by a few ulp between CUDA, torch on the CPU
and XLA, so a value within a hair of a bin edge may land in the
neighbouring bin.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import _build, sweep_draws
from repro_torch.kernels.iss_stepper import _check, _raise_on

I32 = torch.int32
IMAX = torch.iinfo(torch.int32).max


class SweepAcc(NamedTuple):
    """Streamed cross-tile accumulators. `hist` counts best totals into
    fixed log10 bins; `par_*` hold, per embodied log10 bin, the
    lexicographically least (operational, cell, draw) point seen so far
    with its payload. Empty bins hold (inf, inf, inf, IMAX, IMAX, IMAX)."""
    hist: torch.Tensor       # (B,)  int32
    par_op: torch.Tensor     # (Bp,) dtype
    par_emb: torch.Tensor    # (Bp,) dtype
    par_life: torch.Tensor   # (Bp,) dtype, days
    par_cell: torch.Tensor   # (Bp,) int32
    par_draw: torch.Tensor   # (Bp,) int32
    par_core: torch.Tensor   # (Bp,) int32


class TileOut(NamedTuple):
    """Per-cell reductions for one tile of scenario cells."""
    best_total: torch.Tensor  # (Tc, N) chosen-candidate total kg per draw
    best_core: Optional[torch.Tensor]  # (Tc, N) int32 argmin candidate
    counts: torch.Tensor      # (Tc, C) int32
    sum_best: torch.Tensor    # (Tc,)
    min_best: torch.Tensor    # (Tc,)
    max_best: torch.Tensor    # (Tc,)
    sum_emb: torch.Tensor     # (Tc,)
    sum_op: torch.Tensor      # (Tc,)


def init_acc(n_hist: int, n_pareto: int, dtype: torch.dtype,
             device: DeviceLike = None) -> SweepAcc:
    dev = resolve(device)

    def full(v, dt):
        return torch.full((n_pareto,), v, dtype=dt, device=dev)
    inf = float("inf")
    return SweepAcc(hist=torch.zeros((n_hist,), dtype=I32, device=dev),
                    par_op=full(inf, dtype), par_emb=full(inf, dtype),
                    par_life=full(inf, dtype), par_cell=full(IMAX, I32),
                    par_draw=full(IMAX, I32), par_core=full(IMAX, I32))


# ----------------------------------------------------- plain arithmetic
def _totals(emb, kwh, inten, freq, life_days):
    """(Tc, N, C) totals and operational kg in the reference's op order:
    ``emb + |(kwh * inten) * life_days) * freq|``."""
    base = kwh * inten[:, None]
    op = (base[:, None, :] * life_days[:, :, None]) * freq[:, None, None]
    return emb[:, None, :] + torch.abs(op), op


def _cell_reduce(total, op, emb, n_cores):
    best_core = torch.argmin(total, dim=-1).to(I32)     # first-min ties
    sel = best_core[..., None].long()
    best_total = torch.gather(total, -1, sel)[..., 0]
    best_op = torch.gather(op, -1, sel)[..., 0]
    best_emb = torch.gather(emb[:, None, :].expand(total.shape), -1,
                            sel)[..., 0]
    onehot = (best_core[..., None]
              == torch.arange(n_cores, dtype=I32, device=total.device)
              ).to(I32)
    return TileOut(
        best_total=best_total, best_core=best_core,
        counts=torch.sum(onehot, dim=1, dtype=I32),
        sum_best=torch.sum(best_total, dim=1),
        min_best=torch.amin(best_total, dim=1),
        max_best=torch.amax(best_total, dim=1),
        sum_emb=torch.sum(best_emb, dim=1),
        sum_op=torch.sum(best_op, dim=1)), best_op


def _log_bin(x, lo, inv, n_bins):
    """floor((log10(x) - lo) * inv), clipped to [0, n_bins). The
    reference converts to int32 with XLA's saturation (NaN -> 0, +-inf
    -> the int32 limits) before it clips; converting inf or NaN in C++
    is undefined, so the clip happens in floating point, which gives
    the same bins."""
    f = torch.floor((torch.log10(x) - lo) * inv)
    f = torch.nan_to_num(f, nan=0.0, posinf=float(n_bins),
                         neginf=-1.0).clamp(0, n_bins - 1)
    return f.to(I32)


def _hist_contrib(best_total, valid, lo, inv, n_bins):
    bins = _log_bin(best_total, lo, inv, n_bins)
    w = valid[:, None].expand(bins.shape).to(I32)
    return torch.zeros((n_bins,), dtype=I32, device=bins.device).index_add_(
        0, bins.reshape(-1).long(), w.reshape(-1))


def _pareto_candidate(emb, best_op, life_days, cell_idx, best_core, valid,
                      lo, inv, n_bins):
    """Per-bin lexicographic (op, cell, draw) least point of the tile,
    in two levels as the reference does it: each (cell, candidate)
    elects its champion draw, then each bin its champion."""
    n_cells, n_draws = best_op.shape
    n_cores = emb.shape[1]
    dev = best_op.device
    inf = torch.full((), float("inf"), dtype=best_op.dtype, device=dev)
    imax = torch.full((), IMAX, dtype=I32, device=dev)
    chose = best_core[..., None] == torch.arange(n_cores, dtype=I32,
                                                 device=dev)
    opm = torch.where(chose, best_op[..., None], inf)          # (Tc, N, C)
    op_cc = torch.amin(opm, dim=1)                             # (Tc, C)
    tie = chose & (opm == op_cc[:, None, :])
    drawm = torch.where(tie, torch.arange(n_draws, dtype=I32, device=dev
                                          )[None, :, None], imax)
    draw_cc = torch.amin(drawm, dim=1)
    tie = tie & (drawm == draw_cc[:, None, :])
    zero = torch.zeros((), dtype=life_days.dtype, device=dev)
    life_cc = torch.sum(torch.where(tie, life_days[..., None], zero), dim=1)
    alive = valid[:, None] & (op_cc < inf)

    bins = _log_bin(emb, lo, inv, n_bins)                      # (Tc, C)
    cell = cell_idx[:, None].expand(bins.shape)
    mask = (bins[None] == torch.arange(n_bins, dtype=I32, device=dev
                                       )[:, None, None]) & alive[None]
    opb = torch.where(mask, op_cc[None], inf)                  # (Bp, Tc, C)
    op_min = torch.amin(opb, dim=(1, 2))
    finite = op_min < inf
    tie2 = mask & (opb == op_min[:, None, None]) & finite[:, None, None]
    cellm = torch.where(tie2, cell[None], imax)
    cell_min = torch.amin(cellm, dim=(1, 2))
    tie2 = tie2 & (cellm == cell_min[:, None, None])
    drawb = torch.where(tie2, draw_cc[None], imax)
    draw_min = torch.amin(drawb, dim=(1, 2))
    tie2 = tie2 & (drawb == draw_min[:, None, None])

    def pick(vals, empty):
        z = torch.zeros((), dtype=vals.dtype, device=dev)
        e = torch.full((), empty, dtype=vals.dtype, device=dev)
        return torch.sum(torch.where(tie2, vals[None], z), dim=(1, 2),
                         dtype=vals.dtype) + torch.where(finite, z, e)

    core_b = torch.arange(n_cores, dtype=I32, device=dev)[None, :] \
        .expand(bins.shape)
    return (torch.where(finite, op_min, inf), pick(emb, float("inf")),
            pick(life_cc, float("inf")),
            torch.where(finite, cell_min, imax),
            torch.where(finite, draw_min, imax),
            pick(core_b, IMAX).to(I32))


def _pareto_merge(a: Tuple, b: Tuple) -> Tuple:
    """Elementwise lexicographic-min merge of two per-bin frontiers."""
    a_op, a_emb, a_life, a_cell, a_draw, a_core = a
    b_op, b_emb, b_life, b_cell, b_draw, b_core = b
    take_b = (b_op < a_op) \
        | ((b_op == a_op) & (b_cell < a_cell)) \
        | ((b_op == a_op) & (b_cell == a_cell) & (b_draw < a_draw))
    w = torch.where
    return (w(take_b, b_op, a_op), w(take_b, b_emb, a_emb),
            w(take_b, b_life, a_life), w(take_b, b_cell, a_cell),
            w(take_b, b_draw, a_draw), w(take_b, b_core, a_core))


def sweep_tile_plain(emb, kwh, inten, freq, life_days, valid, cell_idx,
                     acc: SweepAcc, *, hist_lo: float, hist_inv: float,
                     par_lo: float, par_inv: float
                     ) -> Tuple[TileOut, SweepAcc]:
    """The reference's whole-tile pipeline in eager torch (any device).
    The bin scalars are rounded to the tile's dtype first, as JAX rounds
    a Python float that meets a float32 array."""
    dt, dev = life_days.dtype, life_days.device
    s = lambda v: torch.full((), v, dtype=dt, device=dev)  # noqa: E731
    n_hist, n_par = acc.hist.shape[0], acc.par_op.shape[0]
    total, op = _totals(emb, kwh, inten, freq, life_days)
    out, best_op = _cell_reduce(total, op, emb, emb.shape[1])
    hist = _hist_contrib(out.best_total, valid, s(hist_lo), s(hist_inv),
                         n_hist)
    cand = _pareto_candidate(emb, best_op, life_days, cell_idx,
                             out.best_core, valid, s(par_lo), s(par_inv),
                             n_par)
    par = _pareto_merge(tuple(acc[1:]), cand)
    return out, SweepAcc(acc.hist + hist, *par)


def sweep_tile_drawn_plain(key, kind, p1, p2, cum_prev, emb, kwh, inten,
                           freq, valid, cell_idx, acc: SweepAcc, *,
                           n_draws: int, day_s: float, hist_lo: float,
                           hist_inv: float, par_lo: float, par_inv: float,
                           life_out: Optional[torch.Tensor] = None
                           ) -> Tuple[TileOut, SweepAcc]:
    """The drawn tile in eager torch (any device): `sweep_draws`'
    uniforms and lifetimes, one true division by `day_s` (a tensor on
    the tile's device, as the sweep divides), then `sweep_tile_plain`.
    `life_out`, if given, receives the lifetimes in days."""
    dt, dev = emb.dtype, emb.device
    u = sweep_draws.uniforms(key, cell_idx, n_draws, dt)
    life = sweep_draws.lifetimes(kind, p1, p2, cum_prev, u) \
        / torch.full((), day_s, dtype=dt, device=dev)
    if life_out is not None:
        life_out.copy_(life)
    return sweep_tile_plain(emb, kwh, inten, freq, life, valid, cell_idx,
                            acc, hist_lo=hist_lo, hist_inv=hist_inv,
                            par_lo=par_lo, par_inv=par_inv)


# ------------------------------------------------------------- wrappers
def _on_cpu(tensors) -> bool:
    for name, t in tensors:
        if t.device.type != "cpu":
            raise ValueError(f"{name} is on {t.device}, expected cpu")
    return True


def _check_tile(dev, emb, kwh, inten, freq, valid, cell_idx, acc,
                n_draws: int, extra=()):
    """Check the tensors both builds take (and `extra`'s (name, tensor,
    dtype, shape) rows); returns (dtype, cells, candidates, bins, Pareto
    bins)."""
    dt = emb.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"emb has dtype {dt}: float32 or float64")
    n_cells, n_cand = tuple(emb.shape) if emb.dim() == 2 else (0, 0)
    n_hist, n_par = acc.hist.shape[0], acc.par_op.shape[0]
    if n_cells < 1 or n_draws < 1 or n_cand < 1 or n_hist < 1 or n_par < 1:
        raise ValueError("sweep_tile needs at least one cell, draw, "
                         "candidate and bin")
    for name, t, dtype, shape in (
            ("emb", emb, dt, (n_cells, n_cand)),
            ("kwh", kwh, dt, (n_cells, n_cand)),
            ("inten", inten, dt, (n_cells,)),
            ("freq", freq, dt, (n_cells,)),
            ("valid", valid, torch.bool, (n_cells,)),
            ("cell_idx", cell_idx, I32, (n_cells,)),
            ("hist", acc.hist, I32, (n_hist,)),
            ("par_op", acc.par_op, dt, (n_par,)),
            ("par_emb", acc.par_emb, dt, (n_par,)),
            ("par_life", acc.par_life, dt, (n_par,)),
            ("par_cell", acc.par_cell, I32, (n_par,)),
            ("par_draw", acc.par_draw, I32, (n_par,)),
            ("par_core", acc.par_core, I32, (n_par,))) + tuple(extra):
        _check(name, t, dev, dtype, shape)
    return dt, n_cells, n_cand, n_hist, n_par


def _outputs(dev, dt, n_cells, n_draws, n_cand, best_core=True):
    """A TileOut to fill and the (cell, candidate) champion scratch
    that the kernel's two passes share."""
    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = TileOut(best_total=e((n_cells, n_draws), dt),
                  best_core=e((n_cells, n_draws), I32) if best_core
                  else None,
                  counts=e((n_cells, n_cand), I32),
                  sum_best=e((n_cells,), dt), min_best=e((n_cells,), dt),
                  max_best=e((n_cells,), dt), sum_emb=e((n_cells,), dt),
                  sum_op=e((n_cells,), dt))
    scratch = (e((n_cells, n_cand), dt), e((n_cells, n_cand), I32),
               e((n_cells, n_cand), dt), e((n_cells, n_cand), I32))
    return out, scratch


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def sweep_tile(emb, kwh, inten, freq, life_days, valid, cell_idx,
               acc: SweepAcc, *, hist_lo: float, hist_inv: float,
               par_lo: float, par_inv: float, device: DeviceLike = None
               ) -> Tuple[TileOut, SweepAcc]:
    """Evaluate and reduce one tile of scenario cells.

    `emb`, `kwh` (Tc, C) are per-cell candidate rows (embodied kg and
    the intensity-1 operational anchor), `inten`, `freq` (Tc,) the
    cell's grid intensity and executions per day, `life_days` (Tc, N)
    the lifetime draws in days, `valid` (Tc,) bool masks padded cells
    out of the accumulators, and `cell_idx` (Tc,) int32 is the global
    cell index, the Pareto tie-break key. All float tensors share one
    dtype, float32 or float64. Returns `(TileOut, SweepAcc)`.
    """
    dev = resolve(device)
    if dev.type == "cpu" and _on_cpu((("emb", emb), ("life_days", life_days),
                                      ("hist", acc.hist))):
        sweep_tile.plain_calls += 1
        return sweep_tile_plain(emb, kwh, inten, freq, life_days, valid,
                                cell_idx, acc, hist_lo=hist_lo,
                                hist_inv=hist_inv, par_lo=par_lo,
                                par_inv=par_inv)
    n_draws = life_days.shape[1] if life_days.dim() == 2 else 0
    dt, n_cells, n_cand, n_hist, n_par = _check_tile(
        dev, emb, kwh, inten, freq, valid, cell_idx, acc, n_draws,
        extra=(("life_days", life_days, emb.dtype,
                (emb.shape[0], n_draws)),))
    out, scratch = _outputs(dev, dt, n_cells, n_draws, n_cand)
    fn = getattr(_build.load("carbon_sweep"), "carbon_sweep_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(dt == torch.float64), emb.data_ptr(), kwh.data_ptr(),
                inten.data_ptr(), freq.data_ptr(), life_days.data_ptr(),
                valid.data_ptr(), cell_idx.data_ptr(),
                *(t.data_ptr() for t in out),
                *(t.data_ptr() for t in scratch),
                *(t.data_ptr() for t in acc),
                n_cells, n_draws, n_cand, n_hist, n_par,
                float(hist_lo), float(hist_inv), float(par_lo),
                float(par_inv), stream)
    _raise_on(rc, "carbon_sweep launch")
    sweep_tile.launches += 1
    return out, acc


def sweep_tile_drawn(key: Tuple[int, int], kind, p1, p2, cum_prev, emb, kwh,
                     inten, freq, valid, cell_idx, acc: SweepAcc, *,
                     n_draws: int, day_s: float, hist_lo: float,
                     hist_inv: float, par_lo: float, par_inv: float,
                     life_out: Optional[torch.Tensor] = None,
                     best_core: bool = True, device: DeviceLike = None
                     ) -> Tuple[TileOut, SweepAcc]:
    """`sweep_tile` with the lifetimes drawn in the kernel.

    `key` is the sweep's `prng.prng_key` (two uint32 words; the x64 key
    for a float64 sweep); `kind` (Tc, K) int32, `p1`, `p2` (Tc, K) and
    `cum_prev` (Tc, K') are the cells' rows of `build_tables`' mixture
    tables; draw d of cell c is `lifetimes` of the uniforms at 2d and
    2d + 1 under `fold_in(key, cell_idx[c])`, divided by `day_s`. The
    other arguments are `sweep_tile`'s. `life_out` (Tc, n_draws), if
    given, receives the lifetimes in days; with `best_core=False` the
    tile's `best_core` is not written and is None.
    """
    dev = resolve(device)
    kw = dict(n_draws=n_draws, day_s=day_s, hist_lo=hist_lo,
              hist_inv=hist_inv, par_lo=par_lo, par_inv=par_inv)
    if dev.type == "cpu" and _on_cpu((("emb", emb), ("kind", kind),
                                      ("hist", acc.hist))):
        sweep_tile_drawn.plain_calls += 1
        out, acc = sweep_tile_drawn_plain(key, kind, p1, p2, cum_prev, emb,
                                          kwh, inten, freq, valid, cell_idx,
                                          acc, life_out=life_out, **kw)
        return (out if best_core else out._replace(best_core=None)), acc
    n_cells = emb.shape[0] if emb.dim() == 2 else 0
    n_comp = kind.shape[1] if kind.dim() == 2 else 0
    n_cum = cum_prev.shape[1] if cum_prev.dim() == 2 else 0
    if n_comp < 1 or n_cum < 1:
        raise ValueError("sweep_tile_drawn needs at least one component "
                         "and one cumulative weight a cell")
    dt = emb.dtype
    extra = [("kind", kind, I32, (n_cells, n_comp)),
             ("p1", p1, dt, (n_cells, n_comp)),
             ("p2", p2, dt, (n_cells, n_comp)),
             ("cum_prev", cum_prev, dt, (n_cells, n_cum))]
    if life_out is not None:
        extra.append(("life_out", life_out, dt, (n_cells, n_draws)))
    dt, n_cells, n_cand, n_hist, n_par = _check_tile(
        dev, emb, kwh, inten, freq, valid, cell_idx, acc, n_draws, extra)
    out, scratch = _outputs(dev, dt, n_cells, n_draws, n_cand, best_core)
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    fn = getattr(_build.load("carbon_sweep"), "carbon_sweep_drawn_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(int(dt == torch.float64), k0, k1, kind.data_ptr(),
                p1.data_ptr(), p2.data_ptr(), cum_prev.data_ptr(), n_comp,
                n_cum, float(day_s), emb.data_ptr(), kwh.data_ptr(),
                inten.data_ptr(), freq.data_ptr(), valid.data_ptr(),
                cell_idx.data_ptr(), _ptr(life_out),
                *(_ptr(t) for t in out), *(t.data_ptr() for t in scratch),
                *(t.data_ptr() for t in acc),
                n_cells, n_draws, n_cand, n_hist, n_par,
                float(hist_lo), float(hist_inv), float(par_lo),
                float(par_inv), stream)
    _raise_on(rc, "carbon_sweep_drawn launch")
    sweep_tile_drawn.launches += 1
    return out, acc


def reset_counts() -> None:
    """Zero the wrappers' launch and plain-call counts."""
    for fn in (sweep_tile, sweep_tile_drawn):
        fn.launches = 0
        fn.plain_calls = 0


reset_counts()
