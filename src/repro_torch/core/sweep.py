"""Monte Carlo carbon-planner sweep, on one CUDA card.

The port of `repro/core/sweep.py`: scenario tensors over

    lifetime distribution x task frequency x grid carbon intensity x
    deployment volume x workload x timing model x fault rate
                                     (x core x redundancy, reduced)

with Monte Carlo lifetime draws (point / lognormal / Weibull mixtures),
walked in fixed tiles of cells. Per tile:

- **Counter-based draws.** Scenario (cell, draw) takes its uniforms from
  `fold_in(key, global cell index)` (JAX's threefry bits exactly), so a
  sweep is bit-identical at any tile size, and equal in its uniforms to
  the reference's. Inverse-CDF lifetimes follow in the reference's op
  order (`kernels/sweep_draws.py`; `ndtri`, `exp`, `log1p` and `pow`
  differ from XLA's by a few ulp).
- **One kernel per tile.** On the card,
  `kernels/carbon_sweep.py::sweep_tile_drawn` draws the lifetimes in
  registers and reduces them in one CUDA kernel: the candidate argmin,
  the per-cell draw statistics, the log-binned histogram and the binned
  Pareto frontier. On the CPU the draws run in eager torch
  (`prng.py`, `sweep_draws.lifetimes`) and `sweep_tile` runs its plain
  version. The percentiles come from `torch.sort` of the tile's best
  totals.
- **No host sync per tile.** Per-cell statistics are written into
  device-resident (cells,) buffers and copied to the host once at the
  end (the reference reads every tile back); the int32 histogram and the
  Pareto accumulator are read only at a flush, every `flush_limit`
  scenarios, and at the end.

The spec, its float64 tables (`build_tables`) and `SweepResult` are
copies of the reference's, numpy throughout. On point-mass lifetimes a
float64 sweep equals `selection.total_grid` / `selection_map` bit for
bit, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import planner
from repro_torch.core.carbon import (REDUNDANCY_MODES, DeviceProfile,
                                     operational_kg,
                                     redundancy_energy_factor,
                                     redundant_embodied_kg, sdc_derating)
from repro_torch.device import DeviceLike, resolve
from repro_torch.flexibits.cycles import CLOCK_HZ, CORES, Core
from repro_torch.kernels import carbon_sweep as csk
from repro_torch.kernels import sweep_draws
from repro_torch.kernels.sweep_draws import LOGNORMAL, POINT, WEIBULL

I32 = torch.int32
TIMING_MODES = ("base", "dynamic", "wcet", "measured")

DAY_S = 86_400.0
YEAR_S = 365.0 * DAY_S
_PCTS = (50, 90, 99)


# --------------------------------------------------------- distributions
@dataclasses.dataclass(frozen=True)
class LifetimeDist:
    """Mixture of point / lognormal / Weibull lifetime components.

    `comps` rows are (kind, p1, p2, weight): point -> (p1=seconds),
    lognormal -> (p1=ln median seconds, p2=sigma of ln), Weibull ->
    (p1=scale seconds, p2=shape k). Weights are normalized at
    construction. Draws use inverse-CDF transforms of counter-based
    uniforms, so a distribution is a pure function of (seed, cell,
    draw).
    """
    name: str
    comps: Tuple[Tuple[int, float, float, float], ...]

    @staticmethod
    def point(seconds: float, name: Optional[str] = None) -> "LifetimeDist":
        return LifetimeDist(name or f"point:{seconds:g}s",
                            ((POINT, float(seconds), 0.0, 1.0),))

    @staticmethod
    def lognormal(median_s: float, sigma: float,
                  name: Optional[str] = None) -> "LifetimeDist":
        """ln L ~ Normal(ln median, sigma). sigma ~ 1.8 spans the
        paper's 1000X lifetime spread at +/-2 sigma."""
        return LifetimeDist(
            name or f"lognormal:{median_s:g}s:{sigma:g}",
            ((LOGNORMAL, math.log(median_s), float(sigma), 1.0),))

    @staticmethod
    def weibull(scale_s: float, shape: float,
                name: Optional[str] = None) -> "LifetimeDist":
        """L ~ Weibull(scale, k): k<1 models infant-mortality-heavy
        deployments, k>1 wear-out-dominated ones."""
        return LifetimeDist(name or f"weibull:{scale_s:g}s:{shape:g}",
                            ((WEIBULL, float(scale_s), float(shape), 1.0),))

    @staticmethod
    def mixture(parts: Sequence[Tuple["LifetimeDist", float]],
                name: Optional[str] = None) -> "LifetimeDist":
        comps, names = [], []
        for d, w in parts:
            for kind, p1, p2, cw in d.comps:
                comps.append((kind, p1, p2, cw * float(w)))
            names.append(f"{d.name}@{w:g}")
        return LifetimeDist(name or "mix(" + "+".join(names) + ")",
                            tuple(comps))

    def normalized(self) -> Tuple[Tuple[int, float, float, float], ...]:
        tot = sum(c[3] for c in self.comps)
        if not (tot > 0):
            raise ValueError(f"distribution {self.name!r} has no weight")
        return tuple((k, p1, p2, w / tot) for k, p1, p2, w in self.comps)

    def support_max(self) -> float:
        """Reference upper lifetime for histogram sizing (draws beyond
        it clamp into the top bin)."""
        hi = 0.0
        for kind, p1, p2, _ in self.comps:
            if kind == POINT:
                hi = max(hi, p1)
            elif kind == LOGNORMAL:
                hi = max(hi, math.exp(p1 + 8.0 * p2))
            else:
                hi = max(hi, p1 * 30.0 ** (1.0 / p2))
        return hi


# ----------------------------------------------------------------- spec
@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One scenario-sweep request. Cell axes in linear-index order
    (slowest to fastest): dists, execs_per_day, intensities, volumes,
    workloads, timing, fault_rates. Everything is hashable so compiled
    sweep steps cache across calls (`fleet/engine.py`'s lru-cached
    runner idiom).

    `fault_rates` (§9.14) is a scenario axis like intensity: each cell
    prices its candidates under one per-instruction transient-fault
    rate. `redundancies` expands the *reduced candidate* axis instead —
    the kernel argmins over core x redundancy jointly, so each cell
    reports the carbon-optimal (core, redundancy) pair. The defaults
    (one rate of 0.0, `("none",)`) leave every table and reduction
    bitwise identical to a redundancy-free sweep."""
    workloads: Tuple[str, ...]
    profiles: Tuple[DeviceProfile, ...]          # parallel to workloads
    dists: Tuple[LifetimeDist, ...]
    execs_per_day: Tuple[float, ...]
    intensities: Tuple[float, ...]
    volumes: Tuple[float, ...] = (1.0,)
    cores: Tuple[Core, ...] = tuple(CORES.values())
    timing: Tuple[str, ...] = ("base",)
    fault_rates: Tuple[float, ...] = (0.0,)
    redundancies: Tuple[str, ...] = ("none",)
    draws: int = 64
    seed: int = 0
    clock_hz: float = CLOCK_HZ
    # per-(workload, core) cycle overrides, parallel to workloads/cores:
    # required by the "wcet" (FlexiLint certificates, §9.11) and
    # "measured" (fleet-run mean cycles, §9.10) timing modes
    wcet_cycles: Optional[Tuple[Tuple[float, ...], ...]] = None
    measured_cycles: Optional[Tuple[Tuple[float, ...], ...]] = None

    @property
    def axis_sizes(self) -> Tuple[int, int, int, int, int, int, int]:
        return (len(self.dists), len(self.execs_per_day),
                len(self.intensities), len(self.volumes),
                len(self.workloads), len(self.timing),
                len(self.fault_rates))

    @property
    def n_candidates(self) -> int:
        """Width of the reduced axis: core x redundancy pairs. Joint
        candidate j decodes as (redundancy j // C, core j % C)."""
        return len(self.cores) * len(self.redundancies)

    @property
    def n_cells(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def n_scenarios(self) -> int:
        return self.n_cells * self.draws

    def validate(self) -> None:
        names = ("dists", "execs_per_day", "intensities", "volumes",
                 "workloads", "timing", "fault_rates")
        for name, size in zip(names, self.axis_sizes):
            if size == 0:
                raise ValueError(f"SweepSpec.{name} is empty")
        if not self.cores:
            raise ValueError("SweepSpec.cores is empty")
        if not self.redundancies:
            raise ValueError("SweepSpec.redundancies is empty")
        if len(self.profiles) != len(self.workloads):
            raise ValueError("profiles must parallel workloads")
        if self.draws < 1:
            raise ValueError("draws must be >= 1")
        for t in self.timing:
            if t not in TIMING_MODES:
                raise ValueError(f"unknown timing mode {t!r}; "
                                 f"expected one of {TIMING_MODES}")
        for r in self.redundancies:
            if r not in REDUNDANCY_MODES:
                raise ValueError(f"unknown redundancy mode {r!r}; "
                                 f"expected one of {REDUNDANCY_MODES}")
        for fr in self.fault_rates:
            if not (fr >= 0.0):
                raise ValueError(f"fault rates must be >= 0, got {fr!r}")
        if "wcet" in self.timing and self.wcet_cycles is None:
            raise ValueError("timing mode 'wcet' needs wcet_cycles "
                             "(see workload_spec)")
        if "measured" in self.timing and self.measured_cycles is None:
            raise ValueError("timing mode 'measured' needs "
                             "measured_cycles")

    def decode_cell(self, idx: int
                    ) -> Tuple[int, int, int, int, int, int, int]:
        D, F, I, V, W, T, FR = self.axis_sizes
        fri = idx % FR
        idx //= FR
        ti = idx % T
        idx //= T
        wi = idx % W
        idx //= W
        vi = idx % V
        idx //= V
        ii = idx % I
        idx //= I
        return (idx // F, idx % F, ii, vi, wi, ti, fri)


# --------------------------------------------------------------- tables
@dataclasses.dataclass(frozen=True)
class SweepTables:
    """Host-side float64 anchors the device sweep consumes.

    The reduced candidate axis is core x redundancy (width
    `spec.n_candidates`, joint index j = r * C + c). `emb[fr, w, j]` is
    `carbon.redundant_embodied_kg` times the SDC derating for
    (redundancy, fault rate); `kwh[t, fr, w, j]` is the intensity-1
    daily-exec operational anchor — literally `operational_kg(core,
    prof, lifetime_s=86400, execs_per_day=1, intensity=1.0)` per timing
    mode, times `carbon.redundancy_energy_factor` and the same derating
    — so the device total ``emb + ((kwh * I) * life_days) * freq``
    retraces the numpy oracle `selection.total_grid` op for op. At the
    default `("none",)` / rate-0 axes every factor is exactly 1.0 and
    the tables are bitwise the redundancy-free ones.
    """
    emb: np.ndarray            # (FR, W, C*R)
    kwh: np.ndarray            # (T, FR, W, C*R)
    kind: np.ndarray           # (D, K) int32
    p1: np.ndarray             # (D, K)
    p2: np.ndarray             # (D, K)
    cum_prev: np.ndarray       # (D, K-1) mixture CDF boundaries
    hist_lo: float
    hist_inv: float
    par_lo: float
    par_inv: float

    def hist_edges(self, n_hist: int) -> np.ndarray:
        return 10.0 ** (self.hist_lo
                        + np.arange(n_hist + 1) / self.hist_inv)


def _mode_kwh(mode: str, core: Core, prof: DeviceProfile,
              clock_hz: float, wcet: Optional[float],
              measured: Optional[float]) -> float:
    if mode == "base":
        prof = dataclasses.replace(prof, dynamic=False)
        cycles = None
    elif mode == "dynamic":
        prof = dataclasses.replace(prof, dynamic=True)
        cycles = None
    elif mode == "wcet":
        cycles = wcet
    else:                                                  # measured
        cycles = measured
    return operational_kg(core, prof, lifetime_s=DAY_S, execs_per_day=1.0,
                          intensity=1.0, clock_hz=clock_hz, cycles=cycles)


def build_tables(spec: SweepSpec, n_hist: int = 64,
                 n_pareto: int = 32) -> SweepTables:
    spec.validate()
    W, C = len(spec.workloads), len(spec.cores)
    T, FR, R = len(spec.timing), len(spec.fault_rates), \
        len(spec.redundancies)
    emb = np.empty((FR, W, C * R))
    kwh = np.empty((T, FR, W, C * R))
    for wi, prof in enumerate(spec.profiles):
        n_instr = prof.n_one_stage + prof.n_two_stage
        for ci, core in enumerate(spec.cores):
            base = np.empty(T)
            for ti, mode in enumerate(spec.timing):
                base[ti] = _mode_kwh(
                    mode, core, prof, spec.clock_hz,
                    spec.wcet_cycles[wi][ci] if spec.wcet_cycles else None,
                    spec.measured_cycles[wi][ci]
                    if spec.measured_cycles else None)
            for ri, red in enumerate(spec.redundancies):
                j = ri * C + ci
                remb = redundant_embodied_kg(core, prof, red)
                for fri, rate in enumerate(spec.fault_rates):
                    rfac = redundancy_energy_factor(
                        red, fault_rate=rate, n_instr=n_instr,
                        width=core.width)
                    derate = sdc_derating(red, fault_rate=rate,
                                          n_instr=n_instr,
                                          width=core.width)
                    # host float64 multiplies; 1.0 is exact identity
                    emb[fri, wi, j] = remb * derate
                    kwh[:, fri, wi, j] = base * rfac * derate

    K = max(len(d.comps) for d in spec.dists)
    D = len(spec.dists)
    kind = np.zeros((D, K), np.int32)
    p1 = np.ones((D, K))
    p2 = np.ones((D, K))
    cum = np.ones((D, K))
    for di, d in enumerate(spec.dists):
        comps = d.normalized()
        for k, (kd, a, b, w) in enumerate(comps):
            kind[di, k], p1[di, k], p2[di, k] = kd, a, b
        cum[di, :len(comps)] = np.cumsum([c[3] for c in comps])
        cum[di, len(comps):] = 1.0

    life_max = max(d.support_max() for d in spec.dists)
    tmin = float(emb.min())
    tmax = float(emb.max() + kwh.max() * max(spec.intensities)
                 * (life_max / DAY_S) * max(spec.execs_per_day))
    hist_lo = math.log10(tmin)
    span = max(math.log10(tmax) - hist_lo, 1e-9)
    par_lo = math.log10(float(emb.min()))
    par_span = max(math.log10(float(emb.max())) - par_lo, 1e-9)
    return SweepTables(emb=emb, kwh=kwh, kind=kind, p1=p1, p2=p2,
                       cum_prev=cum[:, :max(K - 1, 1)],
                       hist_lo=hist_lo, hist_inv=n_hist / span,
                       par_lo=par_lo, par_inv=n_pareto / par_span)


# ------------------------------------------------------- scenario draws
_uniforms = sweep_draws.uniforms
_lifetimes = sweep_draws.lifetimes


def _torch_dtype(dtype) -> torch.dtype:
    dt = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if dt is None:
        raise ValueError(f"sweeps run in float32 or float64, not {dtype}")
    return dt


# ----------------------------------------------------------- sweep step
class _Step:
    """The device tables of one (spec, tile, dtype, device) and the
    streaming step over them (cached like the reference's compiled
    steps, so repeated what-ifs on one spec skip the table build)."""

    def __init__(self, spec: SweepSpec, tile: int, dtype: torch.dtype,
                 n_hist: int, n_pareto: int, dev: torch.device):
        self.tables = build_tables(spec, n_hist, n_pareto)
        tb = self.tables
        self.spec, self.tile, self.dtype, self.dev = spec, tile, dtype, dev

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=dev).to(dt)
        self.emb, self.kwh = t(tb.emb), t(tb.kwh)
        self.freq = t(np.asarray(spec.execs_per_day, np.float64))
        self.inten = t(np.asarray(spec.intensities, np.float64))
        self.vol = t(np.asarray(spec.volumes, np.float64))
        self.kind = t(tb.kind, I32)
        self.p1, self.p2, self.cum = t(tb.p1), t(tb.p2), t(tb.cum_prev)
        # scalars live on the device: torch divides a CUDA tensor by a CPU
        # scalar as a multiply by its reciprocal, the reference divides
        self.day_s = t(DAY_S)
        self.n_draws = t(float(spec.draws))
        self.key = prng.prng_key(spec.seed, x64=dtype == torch.float64)
        draws = spec.draws
        self.qidx = tuple(min(draws - 1, max(0, math.ceil(q / 100 * draws)
                                             - 1)) for q in _PCTS)

    def decode(self, cell: torch.Tensor):
        """(valid, di, fi, ii, vi, wi, ti, fri) of a tile's cells; padded
        cells take the last cell's tables."""
        D, F, I, V, W, T, FR = self.spec.axis_sizes
        n_cells = self.spec.n_cells
        valid = cell < n_cells
        c = torch.where(valid, cell, torch.full_like(cell, n_cells - 1))
        fri = c % FR
        c = c // FR
        ti = c % T
        r = c // T
        wi = r % W
        r = r // W
        vi = r % V
        r = r // V
        ii = r % I
        r = r // I
        return valid, r // F, r % F, ii, vi, wi, ti, fri

    def life_days(self, cell: torch.Tensor, di: torch.Tensor
                  ) -> torch.Tensor:
        """(tile, draws) lifetimes in days: the draws of the cells'
        distributions, seconds to days by one true division."""
        u = _uniforms(self.key, cell, self.spec.draws, self.dtype)
        life = _lifetimes(self.kind[di], self.p1[di], self.p2[di],
                          self.cum[di], u)
        return life / self.day_s

    def __call__(self, acc: csk.SweepAcc, start: int,
                 life_out: Optional[torch.Tensor] = None):
        """One tile from global cell `start`. On the card the kernel
        draws the lifetimes itself; on the CPU they come from
        `life_days`. `life_out` (tile, draws), if given, receives the
        lifetimes in days that the tile used (for checks)."""
        tb = self.tables
        cell = start + torch.arange(self.tile, dtype=I32, device=self.dev)
        valid, di, fi, ii, vi, wi, ti, fri = self.decode(cell)
        rows = (self.emb[fri, wi], self.kwh[ti, fri, wi], self.inten[ii],
                self.freq[fi])
        bins = dict(hist_lo=tb.hist_lo, hist_inv=tb.hist_inv,
                    par_lo=tb.par_lo, par_inv=tb.par_inv, device=self.dev)
        if self.dev.type == "cuda":
            out, acc = csk.sweep_tile_drawn(
                self.key, self.kind[di], self.p1[di], self.p2[di],
                self.cum[di], *rows, valid, cell, acc,
                n_draws=self.spec.draws, day_s=DAY_S, life_out=life_out,
                best_core=False, **bins)
        else:
            life = self.life_days(cell, di)
            if life_out is not None:
                life_out.copy_(life)
            out, acc = csk.sweep_tile(*rows, life, valid, cell, acc, **bins)
        by_draw = torch.sort(out.best_total, dim=1).values
        mean = out.sum_best / self.n_draws
        q = self.qidx
        stats = {
            "mean": mean,
            "p50": by_draw[:, q[0]],
            "p90": by_draw[:, q[1]],
            "p99": by_draw[:, q[2]],
            "min": out.min_best,
            "max": out.max_best,
            "mean_emb": out.sum_emb / self.n_draws,
            "mean_op": out.sum_op / self.n_draws,
            "fleet_mean": mean * self.vol[vi],
            "counts": out.counts,
        }
        return acc, stats


@functools.lru_cache(maxsize=8)
def _sweep_step(spec: SweepSpec, tile: int, dtype: torch.dtype,
                n_hist: int, n_pareto: int, dev: torch.device) -> _Step:
    return _Step(spec, tile, dtype, n_hist, n_pareto, dev)


# --------------------------------------------------------------- result
_PAR_FIELDS = ("op", "emb", "life", "cell", "draw", "core")
_STAT_FIELDS = ("mean", "p50", "p90", "p99", "min", "max", "mean_emb",
                "mean_op", "fleet_mean")


def _acc_to_host(acc: csk.SweepAcc) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in zip(_PAR_FIELDS, acc[1:])}


def _merge_pareto_host(a: Optional[Dict[str, np.ndarray]],
                       b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side flush merge — the same lexicographic-min rule as
    `carbon_sweep._pareto_merge`, so flush cadence cannot change the
    frontier."""
    if a is None:
        return b
    take_b = (b["op"] < a["op"]) \
        | ((b["op"] == a["op"]) & (b["cell"] < a["cell"])) \
        | ((b["op"] == a["op"]) & (b["cell"] == a["cell"])
           & (b["draw"] < a["draw"]))
    return {k: np.where(take_b, b[k], a[k]) for k in _PAR_FIELDS}


@dataclasses.dataclass
class SweepResult:
    """Streamed sweep summaries. Per-cell arrays have the spec's
    (D, F, I, V, W, T, FR) axis shape; `counts` appends the joint
    core x redundancy candidate axis. `path` is "cuda" (the kernel ran)
    or "plain" (its plain version, on the CPU)."""
    spec: SweepSpec
    path: str
    mean: np.ndarray
    p50: np.ndarray
    p90: np.ndarray
    p99: np.ndarray
    min: np.ndarray
    max: np.ndarray
    mean_emb: np.ndarray
    mean_op: np.ndarray
    fleet_mean: np.ndarray
    counts: np.ndarray           # (..., C*R) chosen-candidate draws/cell
    hist: np.ndarray             # (B,) int64 best-total histogram
    hist_edges: np.ndarray       # (B+1,) kg CO2e bin edges
    pareto: Dict[str, np.ndarray]
    n_cells: int
    n_scenarios: int
    wall_s: float
    scenarios_per_s: float
    host_syncs: int = 0          # blocking device-to-host reads

    @property
    def core_share(self) -> np.ndarray:
        return self.counts / self.spec.draws

    @property
    def best_core(self) -> np.ndarray:
        """Modal chosen core per cell (first max on draw-count ties);
        with a redundancy axis, the core half of the joint winner."""
        return np.argmax(self.counts, axis=-1) % len(self.spec.cores)

    @property
    def best_redundancy(self) -> np.ndarray:
        """Redundancy half of the modal joint (core, redundancy) winner
        — index into `spec.redundancies` (all 0 for default specs)."""
        return np.argmax(self.counts, axis=-1) // len(self.spec.cores)

    def quantile(self, q: float) -> float:
        """Whole-sweep best-total quantile from the streamed histogram
        (upper bin edge — exact to bin resolution)."""
        cum = np.cumsum(self.hist)
        i = int(np.searchsorted(cum, q * cum[-1]))
        return float(self.hist_edges[min(i + 1, len(self.hist))])

    def frontier(self) -> List[Dict]:
        """Non-dominated embodied-vs-operational points, ascending in
        embodied kg, annotated with their scenario coordinates."""
        finite = np.isfinite(self.pareto["op"])
        order = np.argsort(self.pareto["emb"][finite], kind="stable")
        rows, best_op = [], np.inf
        for j in np.nonzero(finite)[0][order]:
            op = float(self.pareto["op"][j])
            if op >= best_op:
                continue                      # dominated by a smaller-emb bin
            best_op = op
            cell = int(self.pareto["cell"][j])
            di, fi, ii, vi, wi, ti, fri = self.spec.decode_cell(cell)
            cand = int(self.pareto["core"][j])
            n_cores = len(self.spec.cores)
            rows.append({
                "embodied_kg": float(self.pareto["emb"][j]),
                "operational_kg": op,
                "total_kg": float(self.pareto["emb"][j] + op),
                "lifetime_s": float(self.pareto["life"][j] * DAY_S),
                "core": self.spec.cores[cand % n_cores].name,
                "redundancy": self.spec.redundancies[cand // n_cores],
                "workload": self.spec.workloads[wi],
                "dist": self.spec.dists[di].name,
                "execs_per_day": self.spec.execs_per_day[fi],
                "intensity": self.spec.intensities[ii],
                "volume": self.spec.volumes[vi],
                "timing": self.spec.timing[ti],
                "fault_rate": self.spec.fault_rates[fri],
                "cell": cell,
                "draw": int(self.pareto["draw"][j]),
            })
        return rows


# ----------------------------------------------------------- run_sweep
def run_sweep(spec: SweepSpec, *, tile_cells: int = 1024, dtype=np.float32,
              n_hist: int = 64, n_pareto: int = 32,
              flush_limit: int = 1 << 30,
              device: DeviceLike = None) -> SweepResult:
    """Stream the whole scenario space through the evaluate-and-reduce
    step in `tile_cells`-cell tiles, on the card (`device=None`) or, on
    request, the CPU (`device="cpu"`: the kernel's plain version).

    Device memory is bounded by one tile and the (cells,) statistics;
    the int32 histogram flushes into a host int64 tally (and the Pareto
    accumulator merges host-side) every `flush_limit` scenarios, so
    counts can never wrap. A float64 sweep draws its uniforms from the
    key the reference uses under x64, and needs nothing else.
    """
    spec.validate()
    dev = resolve(device)
    dt = _torch_dtype(dtype)
    n_cells = spec.n_cells
    tile = max(1, min(tile_cells, n_cells))
    step = _sweep_step(spec, tile, dt, n_hist, n_pareto, dev)
    C = spec.n_candidates
    n_pad = -(-n_cells // tile) * tile
    stats_d = {f: torch.empty(n_pad, dtype=dt, device=dev)
               for f in _STAT_FIELDS}
    counts_d = torch.empty((n_pad, C), dtype=I32, device=dev)
    hist64 = np.zeros(n_hist, np.int64)
    par_host: Optional[Dict[str, np.ndarray]] = None
    since_flush = syncs = 0

    t0 = time.perf_counter()
    acc = csk.init_acc(n_hist, n_pareto, dt, dev)
    for start in range(0, n_cells, tile):
        acc, stats = step(acc, start)
        for f in _STAT_FIELDS:
            stats_d[f][start:start + tile] = stats[f]
        counts_d[start:start + tile] = stats["counts"]
        since_flush += tile * spec.draws
        if since_flush >= flush_limit:
            hist64 += acc.hist.cpu().numpy().astype(np.int64)
            par_host = _merge_pareto_host(par_host, _acc_to_host(acc))
            syncs += 1
            acc = csk.init_acc(n_hist, n_pareto, dt, dev)
            since_flush = 0
    hist64 += acc.hist.cpu().numpy().astype(np.int64)
    par_host = _merge_pareto_host(par_host, _acc_to_host(acc))
    host = {f: stats_d[f][:n_cells].cpu().numpy() for f in _STAT_FIELDS}
    counts = counts_d[:n_cells].cpu().numpy()
    syncs += 1
    wall = time.perf_counter() - t0

    shape = spec.axis_sizes
    return SweepResult(
        spec=spec, path="cuda" if dev.type == "cuda" else "plain",
        **{f: host[f].reshape(shape)
           for f in _STAT_FIELDS},
        counts=counts.reshape(shape + (C,)),
        hist=hist64, hist_edges=step.tables.hist_edges(n_hist),
        pareto=par_host, n_cells=n_cells,
        n_scenarios=spec.n_scenarios, wall_s=wall,
        scenarios_per_s=spec.n_scenarios / max(wall, 1e-12),
        host_syncs=syncs)


# ------------------------------------------------- workload spec helper
def workload_spec(keys: Optional[Sequence[str]] = None, *,
                  dists: Sequence[LifetimeDist],
                  execs_per_day: Sequence[float],
                  intensities: Sequence[float],
                  volumes: Sequence[float] = (1.0,),
                  cores: Optional[Sequence[Core]] = None,
                  timing: Sequence[str] = ("base",),
                  fault_rates: Sequence[float] = (0.0,),
                  redundancies: Sequence[str] = ("none",),
                  draws: int = 64, seed: int = 0, n_profile: int = 3,
                  measured_cycles: Optional[Mapping[str, Mapping[
                      str, float]]] = None) -> SweepSpec:
    """Build a SweepSpec from FlexiBench workloads: PyISS-profiled
    DeviceProfiles (measured §9.10 event vectors) and, when the timing
    axis asks for it, FlexiLint WCET certificates (§9.11) priced per
    candidate core under the dynamic cost row."""
    from repro_torch.flexibench.base import all_workloads, get
    from repro_torch.flexibench.memory import profile_memory
    from repro_torch.flexibits import analyze
    from repro_torch.flexibits.cycles import TICKS_PER_CYCLE, cost_row
    from repro_torch.flexibits.pyiss import PyISS

    keys = tuple(w.key for w in all_workloads()) if keys is None \
        else tuple(keys)
    cores = tuple(CORES.values()) if cores is None else tuple(cores)
    timing = tuple(timing)
    profiles, wcet_rows = [], []
    for k in keys:
        w = get(k)
        rng = np.random.default_rng(0)
        n1 = n2 = 0.0
        events = np.zeros_like(np.asarray(
            PyISS(w.program.code, w.total_mem_words,
                  w.initial_memory(w.gen_inputs(rng, 1)[0]))
            .run(w.max_steps).events, np.float64))
        rng = np.random.default_rng(0)
        xs = w.gen_inputs(rng, n_profile)
        for x in xs:
            sim = PyISS(w.program.code, w.total_mem_words,
                        w.initial_memory(x)).run(w.max_steps)
            n1 += sim.n_instr - sim.n_two_stage
            n2 += sim.n_two_stage
            events += np.asarray(sim.events, np.float64)
        mem = profile_memory(w)
        profiles.append(DeviceProfile(
            n_one_stage=n1 / n_profile, n_two_stage=n2 / n_profile,
            vm_kb=mem["vm_kb"], nvm_kb=mem["nvm_kb"],
            events=tuple(events / n_profile)))
        if "wcet" in timing:
            a = analyze.analyze_workload(w)
            row = []
            for core in cores:
                ticks = a.wcet_ticks(cost_row(core, dynamic=True))
                if ticks is None:
                    raise ValueError(f"workload {k!r} has no finite "
                                     f"WCET certificate")
                row.append(ticks / TICKS_PER_CYCLE)
            wcet_rows.append(tuple(row))
    meas = None
    if measured_cycles is not None:
        meas = tuple(tuple(float(measured_cycles[k][c.name])
                           for c in cores) for k in keys)
    return SweepSpec(
        workloads=keys, profiles=tuple(profiles), dists=tuple(dists),
        execs_per_day=tuple(float(f) for f in execs_per_day),
        intensities=tuple(float(i) for i in intensities),
        volumes=tuple(float(v) for v in volumes), cores=cores,
        timing=timing,
        fault_rates=tuple(float(f) for f in fault_rates),
        redundancies=tuple(redundancies),
        draws=draws, seed=seed,
        wcet_cycles=tuple(wcet_rows) if wcet_rows else None,
        measured_cycles=meas)


# ------------------------------------------ serving-planner torch mirror
def serving_plan(*, chip: planner.ServeChip, n_params: float,
                 kv_bytes_per_token: float, lifetimes_days, qps_grid,
                 chips_options: Sequence[int] = (8, 16, 32, 64, 128, 256),
                 intensity: float = 0.367,
                 variants: Optional[Sequence[planner.ServeVariant]] = None,
                 device: DeviceLike = None) -> Dict:
    """float64 torch mirror of `planner.plan_grid` on the card
    (`device=None`) or, on request, the CPU: the same option vectors,
    the same op order and the same first-minimum tie-break, so every
    cell (`variant_idx`, `chips`, `total_kg`, its +inf included) equals
    the numpy oracle bit for bit. Returns the three maps as tensors on
    the device.

    Eager torch runs one kernel per op, so no product is contracted into
    an add. A division by a Python scalar on CUDA multiplies by its
    reciprocal (ATen's `div_true_kernel_cuda` takes that path for a CPU
    scalar divisor), which can differ from numpy's quotient by one ulp,
    so every divisor here is a float64 tensor on the device."""
    if variants is None:
        variants = planner.serve_variants(chip)
    opt_vi, opt_chips, opt_tps, opt_prep = planner.plan_options(
        chip, n_params, kv_bytes_per_token, chips_options, variants)
    dev = resolve(device)
    f64 = torch.float64

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)
    opt_chips, opt_tps, opt_prep = t(opt_chips), t(opt_tps), t(opt_prep)
    opt_vi = torch.as_tensor(opt_vi, device=dev)
    days, qps = t(lifetimes_days), t(qps_grid)
    chip_life_days, one, per_kilo = t(3 * 365.0), t(1.0), t(1000.0)

    feasible = opt_tps[None, None, :] >= qps[None, :, None]
    emb = (opt_chips[None, None, :] * chip.embodied_kg
           * torch.minimum(days / chip_life_days, one)[:, None, None])
    util = torch.where(feasible, qps[None, :, None] / opt_tps[None, None, :],
                       torch.zeros((), dtype=f64, device=dev))
    kwh = (opt_chips[None, None, :] * chip.power_w * planner.PUE * util
           * days[:, None, None] * 24.0 / per_kilo)
    total = opt_prep[None, None, :] + emb + kwh * intensity
    total = torch.where(feasible, total,
                        torch.full((), math.inf, dtype=f64, device=dev))
    k = torch.argmin(total, dim=2)                  # first min wins
    best_kg = torch.gather(total, 2, k[..., None])[..., 0]
    met = torch.isfinite(best_kg)
    best = torch.where(met, opt_vi[k], -1).to(I32)
    best_chips = torch.where(met, opt_chips[k], 0.0).to(I32)
    return {"variant_idx": best, "chips": best_chips, "total_kg": best_kg,
            "variants": [v.name for v in variants]}
