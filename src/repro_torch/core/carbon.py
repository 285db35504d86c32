"""FLEXIFLOW carbon model (paper §5.4).

  C_op  = Power x Runtime x Freq x Lifetime x CarbonIntensity
  C_emb = DieArea / (ActiveWaferArea x Yield) x WaferCO2e

Pragmatic's per-wafer LCA is proprietary; WAFER_KG is calibrated so the
fully-flexible food-spoilage system footprint reproduces Table 5's
0.01086 kg CO2e (DESIGN.md §5). Everything else is the paper's own data
(Tables 7/8 areas & powers, [109]/[118] energy intensities, [85] silicon
TinyML footprint, [37]/[58] battery LCAs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.flexibits.cycles import (Core, event_cycles,
                                          sram_area_mm2, sram_power_mw,
                                          system_area_mm2, system_power_mw)
from repro_torch.flexibits.faults import width_scaled_rate


# ---- energy sources, kg CO2e / kWh ([109] EIA 2023, [118] Wind Vision)
ENERGY_SOURCES: Dict[str, float] = {
    "coal": 1.048,
    "petroleum": 1.116,
    "us_grid": 0.367,
    "solar": 0.028,
    "wind": 0.012,
}

# ---- embodied-carbon calibration (DESIGN.md §5)
ACTIVE_WAFER_AREA_MM2 = 27_000.0     # 200 mm FlexIC wafer, active fraction
WAFER_YIELD = 0.9
WAFER_KG = 33.4                      # calibrated: flexible FS system 0.01086
KG_PER_MM2 = WAFER_KG / (ACTIVE_WAFER_AREA_MM2 * WAFER_YIELD)

# ---- non-compute components (§6.4 system models)
BATTERY_FLEX_KG = 0.0025             # Ilika solid-state [58] (est.)
BATTERY_ALKALINE_KG = 0.055          # AA alkaline [37] (est.)
SENSOR_SILICON_KG = 0.069            # silicon gas sensor (est., [85])
SILICON_TINYML_SYSTEM_KG = 2.66      # full silicon TinyML system [85]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-(workload, core) numbers the carbon model consumes.

    `events` optionally carries the (N_COST,) timing-event vector the
    PyISS cycle oracle records (DESIGN.md §9.10). With it, runtime is
    priced per-event through `cycles.event_cycles` instead of the
    two-bucket analytic model; `dynamic=False` (the base case) is
    *exactly* the two-bucket number, `dynamic=True` additionally prices
    taken-branch refetch, serial shift, and subword read-modify-write.
    """
    n_one_stage: float               # one-stage instructions / execution
    n_two_stage: float
    vm_kb: float
    nvm_kb: float
    events: Optional[Tuple[float, ...]] = None   # mean per-exec events
    dynamic: bool = False            # price the dynamic timing terms


def embodied_kg(area_mm2: float) -> float:
    return area_mm2 * KG_PER_MM2


def soc_embodied_kg(core: Core, prof: DeviceProfile) -> float:
    return embodied_kg(system_area_mm2(core, prof.nvm_kb, prof.vm_kb))


def runtime_s(core: Core, prof: DeviceProfile, clock_hz=10_000.0) -> float:
    if prof.events is not None:
        return event_cycles(prof.events, core, prof.dynamic) / clock_hz
    return core.runtime_s(prof.n_one_stage, prof.n_two_stage, clock_hz)


def energy_per_exec_j(core: Core, prof: DeviceProfile,
                      clock_hz=10_000.0,
                      cycles: Optional[float] = None) -> float:
    """Energy of one execution. `cycles` overrides the profile's runtime
    with a *measured* per-execution cycle count (the fleet engine's
    per-lane `n_cycles` tally, §9.10)."""
    p_mw = system_power_mw(core, prof.vm_kb)
    t = cycles / clock_hz if cycles is not None \
        else runtime_s(core, prof, clock_hz)
    return p_mw * 1e-3 * t


def operational_kg(core: Core, prof: DeviceProfile, *, lifetime_s: float,
                   execs_per_day: float, intensity: float = 0.367,
                   clock_hz: float = 10_000.0,
                   cycles: Optional[float] = None) -> float:
    n_exec = execs_per_day * lifetime_s / 86_400.0
    kwh = energy_per_exec_j(core, prof, clock_hz, cycles) * n_exec / 3.6e6
    return kwh * intensity


def certified_energy_j(core: Core, prof: DeviceProfile, clock_hz: float,
                       wcet_cycles: float) -> float:
    """Certified worst-case energy of one execution (DESIGN.md §9.11):
    FlexiLint's statically proved WCET cycle bound priced through the
    same power model as the measured mean. An upper bound on
    `energy_per_exec_j` whenever the measurement used the dynamic cost
    row (pinned by tests/test_flexilint.py)."""
    return energy_per_exec_j(core, prof, clock_hz, cycles=wcet_cycles)


def certified_operational_kg(core: Core, prof: DeviceProfile, *,
                             lifetime_s: float, execs_per_day: float,
                             intensity: float = 0.367,
                             clock_hz: float = 10_000.0,
                             wcet_cycles: float) -> float:
    """Certified worst-case lifetime operational carbon (§9.11): every
    execution priced at the static WCET ceiling instead of the measured
    mean — the number a deployment can promise without profiling."""
    return operational_kg(core, prof, lifetime_s=lifetime_s,
                          execs_per_day=execs_per_day, intensity=intensity,
                          clock_hz=clock_hz, cycles=wcet_cycles)


def total_kg(core: Core, prof: DeviceProfile, *, lifetime_s: float,
             execs_per_day: float, intensity: float = 0.367,
             clock_hz: float = 10_000.0) -> float:
    return soc_embodied_kg(core, prof) + operational_kg(
        core, prof, lifetime_s=lifetime_s, execs_per_day=execs_per_day,
        intensity=intensity, clock_hz=clock_hz)


# ---- redundancy-aware pricing (DESIGN.md §9.14) ------------------------
#
# Spare-area embodied carbon vs re-execution operational carbon: a DMR
# pair doubles the core + VM SRAM (each copy keeps private architectural
# state) but shares the LPROM code store; TMR triples them. Operationally
# DMR runs 2 copies per attempt and re-executes on a digest mismatch
# (the fleet engine's segment-granular rollback), TMR runs 3 copies and
# votes with no retry. The unprotected mode pays differently: its faults
# escape silently (SDC), so delivering the same number of *trusted*
# results takes 1/(1-p) device-executions — a derating multiplier on
# embodied AND operational carbon. At fault rate 0 every factor is
# exactly 1.0 and the unprotected numbers are bitwise unchanged.

REDUNDANCY_MODES: Tuple[str, ...] = ("none", "dmr", "tmr")
_REDUNDANCY_COPIES: Dict[str, int] = {"none": 1, "dmr": 2, "tmr": 3}


def _copies(redundancy: str) -> int:
    try:
        return _REDUNDANCY_COPIES[redundancy]
    except KeyError:
        raise ValueError(
            f"redundancy must be one of {REDUNDANCY_MODES}, "
            f"got {redundancy!r}") from None


def fault_escape_p(fault_rate: float, n_instr: float,
                   width: int = 32) -> float:
    """Probability at least one fault fires during one execution of
    `n_instr` retired instructions at per-instruction rate `fault_rate`
    (width-scaled exactly as the injector: narrower datapaths expose
    proportionally fewer bits per cycle). Clamped below 1 so the DMR
    retry series stays summable."""
    r = width_scaled_rate(fault_rate, width)
    p = 1.0 - (1.0 - r) ** max(float(n_instr), 0.0)
    return min(p, 0.99)


def redundancy_energy_factor(redundancy: str = "none", *,
                             fault_rate: float = 0.0,
                             n_instr: float = 0.0,
                             width: int = 32) -> float:
    """Multiplier on per-execution energy under a redundancy mode.

    none -> exactly 1.0 (callers multiplying by it stay bit-identical).
    dmr  -> 2/(1-p): two copies per attempt; a detected divergence
            (probability ~ p per attempt, first order in the rate)
            re-executes the segment, a geometric series summing to
            1/(1-p) expected attempts.
    tmr  -> 3.0: three copies, majority vote, no retry.
    """
    n = _copies(redundancy)
    if redundancy != "dmr":
        return float(n)
    p = fault_escape_p(fault_rate, n_instr, width)
    return 2.0 / (1.0 - p)


def sdc_derating(redundancy: str = "none", *, fault_rate: float = 0.0,
                 n_instr: float = 0.0, width: int = 32) -> float:
    """Per-trusted-result derating multiplier on BOTH embodied and
    operational carbon. Unprotected executions that fault are silently
    wrong (SDC), so a fleet must provision 1/(1-p) device-executions
    per result it can trust. DMR detects and TMR masks single faults;
    their escape rate is O(p^2) and priced as exactly 1.0 (first
    order), as is everything at fault rate 0."""
    _copies(redundancy)                         # validate mode
    if redundancy != "none" or fault_rate == 0.0:
        return 1.0
    return 1.0 / (1.0 - fault_escape_p(fault_rate, n_instr, width))


def redundant_embodied_kg(core: Core, prof: DeviceProfile,
                          redundancy: str = "none") -> float:
    """SoC embodied carbon with (n-1) spare copies of the core + VM SRAM
    (the LPROM code store is shared — every copy executes one image).
    `none` is exactly `soc_embodied_kg`."""
    n = _copies(redundancy)
    if n == 1:
        return soc_embodied_kg(core, prof)
    spare = (n - 1) * (core.area_mm2 + sram_area_mm2(prof.vm_kb))
    return soc_embodied_kg(core, prof) + embodied_kg(spare)


def redundant_operational_kg(core: Core, prof: DeviceProfile, *,
                             lifetime_s: float, execs_per_day: float,
                             redundancy: str = "none",
                             fault_rate: float = 0.0,
                             intensity: float = 0.367,
                             clock_hz: float = 10_000.0,
                             cycles: Optional[float] = None) -> float:
    factor = redundancy_energy_factor(
        redundancy, fault_rate=fault_rate,
        n_instr=prof.n_one_stage + prof.n_two_stage, width=core.width)
    return operational_kg(core, prof, lifetime_s=lifetime_s,
                          execs_per_day=execs_per_day, intensity=intensity,
                          clock_hz=clock_hz, cycles=cycles) * factor


def redundant_total_kg(core: Core, prof: DeviceProfile, *,
                       lifetime_s: float, execs_per_day: float,
                       redundancy: str = "none", fault_rate: float = 0.0,
                       intensity: float = 0.367,
                       clock_hz: float = 10_000.0) -> float:
    """`total_kg` over the redundancy axis: (spare-area embodied +
    re-execution operational) x the SDC derating. `none` at fault rate
    0 is bitwise `total_kg` (spare area exactly 0, every factor exactly
    1.0)."""
    derate = sdc_derating(redundancy, fault_rate=fault_rate,
                          n_instr=prof.n_one_stage + prof.n_two_stage,
                          width=core.width)
    return (redundant_embodied_kg(core, prof, redundancy)
            + redundant_operational_kg(
                core, prof, lifetime_s=lifetime_s,
                execs_per_day=execs_per_day, redundancy=redundancy,
                fault_rate=fault_rate, intensity=intensity,
                clock_hz=clock_hz)) * derate


def flexible_system_kg(core: Core, prof: DeviceProfile, **kw) -> float:
    """Fully-flexible system: SoC + flexible sensor (~= SoC, §6.4 fn 2) +
    solid-state battery."""
    return (total_kg(core, prof, **kw) + soc_embodied_kg(core, prof)
            + BATTERY_FLEX_KG)


def hybrid_system_kg(core: Core, prof: DeviceProfile, **kw) -> float:
    return (total_kg(core, prof, **kw) + SENSOR_SILICON_KG
            + BATTERY_ALKALINE_KG)
