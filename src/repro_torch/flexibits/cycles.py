"""FLEXIBITS bit-serial cycle + energy model (paper §4.2/§4.4, Table 7).

Timing: one-stage instructions take 32/w + a_w cycles, two-stage 64/w + b_w
(w = datapath width). (a_1,b_1)=(6,6) reproduces the paper's SERV numbers
exactly (38 / 70 cycles, §4.2 "70 cycles from initial fetch to retirement").
(a_4,b_4) and (a_8,b_8) are calibration constants fitted so the suite
geomean speedups land on the paper's 3.15x (QERV) and 4.93x (HERV)
(DESIGN.md §5). Powers/areas are the paper's measured values (Table 7), so
energy ratios 2.65x / 3.50x follow from the timing model.

Memory (Table 8): LPROM ~ area-only (negligible power); SRAM power/area
scale linearly with required KB, anchored to the paper's per-workload
Table 3 <-> Table 8 pairs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

CLOCK_HZ = 10_000.0          # 10 kHz operating point (paper §4.4)

# Fig. 2a instruction-mix categories — the canonical order for every mix
# vector in the codebase: iss.ISSState.mix, PyISS.events, and the
# per-(stage, class) blocks of `cost_row`. Lives here (not iss.py) so the
# pure-python oracle and the cost table need no jax import.
MIX_CLASSES = ("loads", "stores", "branches", "jumps", "shifts", "I-type",
               "R-type", "system")


@dataclasses.dataclass(frozen=True)
class Core:
    name: str
    width: int               # datapath bits
    area_mm2: float          # Table 7
    power_mw: float          # Table 7
    gates: int               # Table 4 (NAND2)
    a: float                 # one-stage fetch/decode overhead cycles
    b: float                 # two-stage overhead cycles

    def cycles_one_stage(self) -> float:
        return 32.0 / self.width + self.a

    def cycles_two_stage(self) -> float:
        return 64.0 / self.width + self.b

    def cycles(self, n_one: float, n_two: float) -> float:
        return (n_one * self.cycles_one_stage()
                + n_two * self.cycles_two_stage())

    def runtime_s(self, n_one: float, n_two: float,
                  clock_hz: float = CLOCK_HZ) -> float:
        return self.cycles(n_one, n_two) / clock_hz

    def energy_j(self, n_one: float, n_two: float,
                 extra_power_mw: float = 0.0,
                 clock_hz: float = CLOCK_HZ) -> float:
        """Energy per program execution (core + memory static power)."""
        t = self.runtime_s(n_one, n_two, clock_hz)
        return (self.power_mw + extra_power_mw) * 1e-3 * t


SERV = Core("SERV", 1, area_mm2=2.93, power_mw=17.75, gates=2546,
            a=6.0, b=6.0)
QERV = Core("QERV", 4, area_mm2=3.68, power_mw=21.07, gates=3198,
            a=4.0, b=6.0)
HERV = Core("HERV", 8, area_mm2=4.50, power_mw=24.99, gates=3903,
            a=3.65, b=6.2)

CORES: Dict[str, Core] = {"SERV": SERV, "QERV": QERV, "HERV": HERV}


# ----------------------------------------------------- cycle-cost table
# Per-lane timing layer (DESIGN.md §9.10). Integer fixed point: costs are
# expressed in TICKS (TICKS_PER_CYCLE ticks = 1 cycle) so every stepper
# accumulates exact int32 tallies — TICKS_PER_CYCLE is chosen so that
# 32/w, 64/w, and the Table-7 overheads a_w/b_w are all whole numbers of
# ticks for every core (20*a and 20*b are integral for SERV/QERV/HERV).
TICKS_PER_CYCLE = 20

# Flattened cost row consumed by iss.timing_ticks / PyISS.events:
#   [0:8]   one-stage base ticks per mix class (MIX_CLASSES order)
#   [8:16]  two-stage base ticks per mix class
#   [16]    taken-branch refetch          (dynamic)
#   [17]    per-shift-amount-bit serial shift cost (dynamic)
#   [18]    subword load/store read-modify-write   (dynamic)
N_COST = 2 * len(MIX_CLASSES) + 3
TAKEN_IDX = 2 * len(MIX_CLASSES)
SHIFT_IDX = TAKEN_IDX + 1
SUBWORD_IDX = TAKEN_IDX + 2


def base_ticks(core: Core) -> "tuple[int, int]":
    """(one-stage, two-stage) base cost in ticks.

    Exactly TICKS_PER_CYCLE * Core.cycles_one_stage()/cycles_two_stage()
    for every Table-7 core: 640/w and 1280/w are integral for w in
    {1, 4, 8} and so are 20*a_w / 20*b_w.
    """
    one = 640 // core.width + round(TICKS_PER_CYCLE * core.a)
    two = 1280 // core.width + round(TICKS_PER_CYCLE * core.b)
    return one, two


def cost_row(core: Core, dynamic: bool = False) -> np.ndarray:
    """(N_COST,) int32 cycle-cost row for `core`, in ticks.

    With dynamic=False (the table's BASE case) only the per-(stage, mix
    class) entries are populated, and accumulated ticks equal
    TICKS_PER_CYCLE * Core.cycles(n_one, n_two) exactly — the SERV 38/70
    pins and the Table-7 geomeans are preserved by construction.

    dynamic=True additionally prices the events the two-bucket model
    cannot see (ROADMAP "cycle-accurate core timing beyond 1 CPI"):
    a taken branch refetches (one extra 32-bit fetch pass, 32/w cycles),
    serial shifters pay one datapath pass per shift-amount bit (1/w
    cycles per bit), and subword loads/stores pay an extra word pass for
    the read-modify-write (32/w cycles).
    """
    one, two = base_ticks(core)
    row = np.zeros(N_COST, np.int32)
    row[:len(MIX_CLASSES)] = one
    row[len(MIX_CLASSES):2 * len(MIX_CLASSES)] = two
    if dynamic:
        row[TAKEN_IDX] = 640 // core.width
        row[SHIFT_IDX] = 20 // core.width
        row[SUBWORD_IDX] = 640 // core.width
    return row


def event_cycles(events, core: Core, dynamic: bool = False) -> float:
    """Cycles for an (N_COST,) timing-event vector priced on `core`.

    Events are core-independent (PyISS tracks them once per program);
    pricing is a dot product against the core's cost row, so one
    profiling run serves every candidate core. With dynamic=False this
    equals `Core.cycles(n_one, n_two)` exactly.
    """
    ev = np.asarray(events, np.float64)
    return float(ev @ cost_row(core, dynamic).astype(np.float64)) \
        / TICKS_PER_CYCLE


# ------------------------------------------------------------------ memory
# Table 8 anchors: SRAM area/power scale with VM KB; LPROM area scales with
# NVM KB at negligible power. Linear coefficients fitted to the paper's
# (Table 3 KB, Table 8 area/power) pairs:
#   WQ: VM 0.01 KB -> SRAM 2.32 (area units), power 2.26 mW total
#   GR: VM 40.0 KB -> SRAM 661.85, power 642.58 mW
#   AP: NVM 63.38 KB -> LPROM 182.03 area units
SRAM_AREA_PER_KB = (661.85 - 2.32) / (40.0 - 0.01)      # ~16.49 /KB
SRAM_AREA_BASE = 2.32 - SRAM_AREA_PER_KB * 0.01
SRAM_MW_PER_KB = (642.58 - 2.26) / (40.0 - 0.01)        # ~16.01 mW/KB
SRAM_MW_BASE = 2.26 - SRAM_MW_PER_KB * 0.01
LPROM_AREA_PER_KB = 182.03 / 63.38                      # ~2.872 /KB
# Table-8 "area units" -> mm^2: Table 7 core areas are mm^2; Pragmatic's
# LPROM/SRAM macros are characterized per-KB. We treat Table 8 units as
# 0.01 mm^2 so a 40 KB SRAM ~ 6.6 mm^2 (consistent with FlexIC die sizes).
AREA_UNIT_MM2 = 0.01


def sram_power_mw(vm_kb: float) -> float:
    return max(SRAM_MW_BASE + SRAM_MW_PER_KB * vm_kb, 0.05)


def sram_area_mm2(vm_kb: float) -> float:
    return max(SRAM_AREA_BASE + SRAM_AREA_PER_KB * vm_kb, 0.1) \
        * AREA_UNIT_MM2


def lprom_area_mm2(nvm_kb: float) -> float:
    return LPROM_AREA_PER_KB * nvm_kb * AREA_UNIT_MM2


def system_area_mm2(core: Core, nvm_kb: float, vm_kb: float) -> float:
    return core.area_mm2 + sram_area_mm2(vm_kb) + lprom_area_mm2(nvm_kb)


def system_power_mw(core: Core, vm_kb: float) -> float:
    return core.power_mw + sram_power_mw(vm_kb)
