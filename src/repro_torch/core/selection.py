"""Lifetime-aware carbon-optimal core selection (paper §5.5, Fig. 5).

Vectorized over (lifetime x frequency) grids with numpy (the grids are
tiny); the *fleet-scale* vectorized variant (jnp over items with different
lifetimes) lives in flexibits/fleet.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.carbon import (REDUNDANCY_MODES, DeviceProfile,
                                     operational_kg,
                                     redundancy_energy_factor,
                                     redundant_embodied_kg, sdc_derating,
                                     soc_embodied_kg)
from repro_torch.flexibits.cycles import CORES, Core


def total_grid(core: Union[Core, Sequence[Core]], prof: DeviceProfile,
               lifetimes_s: np.ndarray, execs_per_day: np.ndarray,
               intensity: float = 0.367,
               clock_hz: float = 10_000.0,
               redundancy: str = "none",
               fault_rate: float = 0.0) -> np.ndarray:
    """Total carbon over a (lifetime x frequency) grid.

    One core -> (len(lifetimes), len(freqs)); a sequence of cores -> a
    stacked (len(cores), len(lifetimes), len(freqs)) grid in one
    broadcast (the embodied/operational anchors are per-core scalars;
    operational carbon scales linearly in lifetime x freq).

    `redundancy`/`fault_rate` price an N-modular-redundant variant of
    every core (DESIGN.md §9.14): spare core+SRAM embodied area, the
    expected re-execution energy factor, and — for unprotected cores at
    a nonzero rate — the per-trusted-result SDC derating on both
    embodied and operational carbon. The default (`"none"` at rate 0)
    is bitwise the unpriced grid: the spare area is exactly 0 and every
    factor exactly 1.0.
    """
    cores = [core] if isinstance(core, Core) else list(core)
    n_instr = prof.n_one_stage + prof.n_two_stage
    derate = np.array([
        sdc_derating(redundancy, fault_rate=fault_rate, n_instr=n_instr,
                     width=c.width) for c in cores])
    emb = np.array([redundant_embodied_kg(c, prof, redundancy)
                    for c in cores]) * derate
    rfac = np.array([
        redundancy_energy_factor(
            redundancy, fault_rate=fault_rate, n_instr=n_instr,
            width=c.width)
        for c in cores])
    base = np.array([
        operational_kg(c, prof, lifetime_s=86_400.0, execs_per_day=1.0,
                       intensity=intensity, clock_hz=clock_hz)
        for c in cores]) * rfac * derate
    life_days = np.asarray(lifetimes_s)[:, None] / 86_400.0
    grid = emb[:, None, None] + base[:, None, None] \
        * life_days[None, :, :] * np.asarray(execs_per_day)[None, None, :]
    return grid[0] if isinstance(core, Core) else grid


def redundancy_grid(prof: DeviceProfile, lifetimes_s: np.ndarray,
                    execs_per_day: np.ndarray, *, fault_rate: float,
                    intensity: float = 0.367,
                    cores: Optional[Sequence[Core]] = None,
                    redundancies: Sequence[str] = REDUNDANCY_MODES
                    ) -> np.ndarray:
    """Stacked (redundancy, core, lifetime, freq) total-carbon grid —
    the (R, C) leading axes are the joint design space the planner
    argmins over."""
    cores = list(cores or CORES.values())
    return np.stack([
        total_grid(cores, prof, lifetimes_s, execs_per_day, intensity,
                   redundancy=r, fault_rate=fault_rate)
        for r in redundancies])


def redundancy_selection_map(prof: DeviceProfile, lifetimes_s: np.ndarray,
                             execs_per_day: np.ndarray, *,
                             fault_rate: float, intensity: float = 0.367,
                             cores: Optional[Sequence[Core]] = None,
                             redundancies: Sequence[str] = REDUNDANCY_MODES
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """argmin over the joint (redundancy x core) axis: returns a pair of
    index grids `(redundancy_idx, core_idx)`, each (lifetime, freq).
    At fault_rate 0 the `core_idx` grid reproduces `selection_map`
    exactly — spare copies only cost, never pay (pinned by tests)."""
    cores = list(cores or CORES.values())
    totals = redundancy_grid(prof, lifetimes_s, execs_per_day,
                             fault_rate=fault_rate, intensity=intensity,
                             cores=cores, redundancies=redundancies)
    flat = totals.reshape(-1, *totals.shape[2:])
    best = np.argmin(flat, axis=0)
    return best // len(cores), best % len(cores)


def selection_map(prof: DeviceProfile, lifetimes_s: np.ndarray,
                  execs_per_day: np.ndarray, intensity: float = 0.367,
                  cores: Optional[Sequence[Core]] = None) -> np.ndarray:
    """argmin-core index grid (paper Fig. 5). 0=SERV, 1=QERV, 2=HERV."""
    cores = list(cores or CORES.values())
    totals = total_grid(cores, prof, lifetimes_s, execs_per_day, intensity)
    return np.argmin(totals, axis=0)


def optimal_core(prof: DeviceProfile, *, lifetime_s: float,
                 execs_per_day: float, intensity: float = 0.367,
                 cores: Optional[Sequence[Core]] = None) -> Tuple[Core, Dict]:
    cores = list(cores or CORES.values())
    totals = total_grid(cores, prof, np.array([lifetime_s]),
                        np.array([execs_per_day]), intensity)[:, 0, 0]
    i = int(np.argmin(totals))
    return cores[i], {c.name: float(t) for c, t in zip(cores, totals)}


def crossover_lifetimes(prof: DeviceProfile, execs_per_day: float,
                        intensity: float = 0.367,
                        cores: Optional[Sequence[Core]] = None
                        ) -> np.ndarray:
    """Pairwise crossover-lifetime matrix over all core pairs.

    `out[a, b]` is the lifetime (seconds) where core b overtakes core a
    (solves emb_a + op_a*L = emb_b + op_b*L per pair in one broadcast);
    +inf where b never catches up (op_a <= op_b). The sweep's frontier
    annotation consumes whole rows of this at once.
    """
    cores = list(CORES.values()) if cores is None else list(cores)
    emb = np.array([soc_embodied_kg(c, prof) for c in cores])
    op = np.array([
        operational_kg(c, prof, lifetime_s=86_400.0,
                       execs_per_day=execs_per_day, intensity=intensity)
        for c in cores])
    demb = emb[None, :] - emb[:, None]          # emb_b - emb_a
    dop = op[:, None] - op[None, :]             # op_a - op_b
    out = np.full((len(cores), len(cores)), np.inf)
    np.divide(demb * 86_400.0, dop, out=out, where=dop > 0)
    return out


def crossover_lifetime_s(prof: DeviceProfile, core_a: Core, core_b: Core,
                         execs_per_day: float,
                         intensity: float = 0.367) -> float:
    """Lifetime where core_b (more efficient, larger) overtakes core_a.

    Scalar view of `crossover_lifetimes`. Returns +inf if never.
    """
    return float(crossover_lifetimes(
        prof, execs_per_day, intensity, cores=(core_a, core_b))[0, 1])
