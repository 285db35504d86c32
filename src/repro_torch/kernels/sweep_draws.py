"""The carbon sweep's Monte Carlo lifetime draws in plain torch.

The plain version of what `csrc/sweep_draws.cuh` computes inside the
sweep kernel's drawn build (`carbon_sweep.sweep_tile_drawn`), and what
`run_sweep` on the CPU runs:

- `uniforms`: a cell's uniforms come from `fold_in(key, global cell
  index)` (`prng.py`, JAX's threefry bits exactly), so a sweep is
  bit-identical at any tile size and equal in its uniforms to the
  reference's;
- `lifetimes`: the inverse-CDF mixture draw in the reference's op order
  (`torch.special.ndtri`, `exp`, `log1p`, `pow`; these differ from XLA's
  by a few ulp).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import prng

# lifetime-distribution component kinds
POINT, LOGNORMAL, WEIBULL = 0, 1, 2


def uniforms(key: Tuple[int, int], cell: torch.Tensor, draws: int,
             dtype: torch.dtype) -> torch.Tensor:
    """(tile, draws, 2) uniforms: `fold_in(key, global cell index)`, then
    a (draws, 2) draw per cell key — JAX's bits, a pure function of the
    GLOBAL cell index, so any tiling replays the same scenarios."""
    u = prng.uniform(prng.fold_in(key, cell), 2 * draws, dtype)
    return u.reshape(cell.shape[0], draws, 2)


def lifetimes(kind, p1, p2, cum_prev, u) -> torch.Tensor:
    """Inverse-CDF mixture draw: u[..., 1] picks the component against
    the cumulative weights, u[..., 0] goes through the component's
    quantile function. `kind`, `p1`, `p2` (tile, K) and `cum_prev`
    (tile, K-1) are the cells' rows of the tables."""
    dtype, dev = u.dtype, u.device
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    lo = torch.full((), eps, dtype=dtype, device=dev)
    hi = torch.full((), 1.0 - eps, dtype=dtype, device=dev)
    uc = torch.minimum(torch.maximum(u[..., 0], lo), hi)
    comp = torch.sum(u[..., 1][..., None] >= cum_prev[:, None, :], dim=-1)
    k = torch.gather(kind, 1, comp)
    a = torch.gather(p1, 1, comp)
    b = torch.gather(p2, 1, comp)
    z = torch.special.ndtri(uc)
    lognorm = torch.exp(a + b * z)
    weibull = a * torch.pow(-torch.log1p(-uc), torch.reciprocal(b))
    return torch.where(k == POINT, a,
                       torch.where(k == LOGNORMAL, lognorm, weibull))
