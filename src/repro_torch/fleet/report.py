"""Fleet-level carbon report: engine tallies priced through the paper's
models.

Each group's measured tallies become a `DeviceProfile` for
core/carbon.py (operational + embodied kg over the group's deployment
lifetime), and core/selection.py supplies the carbon-optimal core for the
group's (lifetime, frequency) point. The footprint of the simulation
itself is priced from the card it ran on: its power limit (as
`nvidia-smi` reports it, or given by the caller) x PUE x wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from repro_torch.core import carbon
from repro_torch.core.planner import PUE
from repro_torch.core.selection import optimal_core
from repro_torch.flexibench.base import Workload
from repro_torch.flexibits.cycles import TICKS_PER_CYCLE, Core
from repro_torch.fleet.engine import FleetResult, PackedStats


@dataclasses.dataclass(frozen=True)
class GroupReport:
    group: Any                    # the FleetGroup that produced this row
    workload: Workload
    core: Core
    result: FleetResult
    lifetime_s: float
    execs_per_day: float
    profile: carbon.DeviceProfile      # measured mean instruction counts
    energy_j_per_exec: float           # one execution, one item
    fleet_exec_kwh: float              # one execution of every item
    operational_kg: float              # whole group over its lifetime
    embodied_kg: float                 # whole group (SoC only)
    total_kg: float
    recommended_core: str              # carbon-argmin core for this point
    # mean measured cycles/execution from the per-lane n_cycles tallies;
    # None when the group ran cycles-off
    measured_cycles: Optional[float] = None
    # FlexiLint certificate: statically proved worst-case cycles per
    # execution (dynamic cost row), and that ceiling priced as energy
    # and lifetime operational carbon
    wcet_cycles: Optional[float] = None
    certified_energy_j: Optional[float] = None
    certified_operational_kg: Optional[float] = None

    @property
    def cycles_per_item(self) -> float:
        """Measured mean cycles when the run carried the timing layer,
        the two-bucket analytic number otherwise."""
        if self.measured_cycles is not None:
            return self.measured_cycles
        return self.core.cycles(self.profile.n_one_stage,
                                self.profile.n_two_stage)

    @property
    def wcet_ratio(self) -> Optional[float]:
        """Certified worst-case cycles / measured-or-analytic mean."""
        if self.wcet_cycles is None:
            return None
        return self.wcet_cycles / max(self.cycles_per_item, 1e-12)


def build_group_report(*, group: Any, workload: Workload, core: Core,
                       result: FleetResult, lifetime_s: float,
                       execs_per_day: float, intensity: float,
                       clock_hz: float,
                       wcet_cycles: Optional[float] = None,
                       redundancy: str = "none",
                       fault_rate: float = 0.0) -> GroupReport:
    """Price one group's tallies under its `redundancy` mode and
    `fault_rate`: spare-copy embodied carbon, re-execution energy and
    SDC derating (`carbon.redundant_*`, `carbon.sdc_derating`), whose
    factors are exactly 1.0 unprotected at rate 0."""
    n = max(result.n_items, 1)
    mean_one = float((result.n_instr - result.n_two_stage).sum()) / n
    mean_two = float(result.n_two_stage.sum()) / n
    vm_kb = workload.vm_kb()
    prof = carbon.DeviceProfile(n_one_stage=mean_one, n_two_stage=mean_two,
                                vm_kb=vm_kb, nvm_kb=workload.nvm_kb)
    # timing layer on -> price from the accumulated per-lane ticks
    cycles = None
    if result.n_cycles is not None:
        cycles = float(result.n_cycles.sum()) / n / TICKS_PER_CYCLE
    e_exec = carbon.energy_per_exec_j(core, prof, clock_hz, cycles)
    derate = carbon.sdc_derating(
        redundancy, fault_rate=fault_rate,
        n_instr=mean_one + mean_two, width=core.width)
    op_kg = carbon.redundant_operational_kg(
        core, prof, lifetime_s=lifetime_s, execs_per_day=execs_per_day,
        redundancy=redundancy, fault_rate=fault_rate,
        intensity=intensity, clock_hz=clock_hz,
        cycles=cycles) * derate * result.n_items
    emb_kg = carbon.redundant_embodied_kg(core, prof, redundancy) \
        * derate * result.n_items
    best, _ = optimal_core(prof, lifetime_s=lifetime_s,
                           execs_per_day=execs_per_day, intensity=intensity)
    cert_e = cert_op = None
    if wcet_cycles is not None:
        # the certificate dominates under the same provisioning: scale it
        # by the measured figure's redundancy and derating factors
        res_mult = carbon.redundancy_energy_factor(
            redundancy, fault_rate=fault_rate,
            n_instr=mean_one + mean_two, width=core.width) * derate
        cert_e = carbon.certified_energy_j(core, prof, clock_hz,
                                           wcet_cycles) * res_mult
        cert_op = carbon.certified_operational_kg(
            core, prof, lifetime_s=lifetime_s, execs_per_day=execs_per_day,
            intensity=intensity, clock_hz=clock_hz,
            wcet_cycles=wcet_cycles) * res_mult * result.n_items
    return GroupReport(
        group=group, workload=workload, core=core, result=result,
        lifetime_s=lifetime_s, execs_per_day=execs_per_day, profile=prof,
        energy_j_per_exec=e_exec,
        fleet_exec_kwh=e_exec * result.n_items / 3.6e6,
        operational_kg=op_kg, embodied_kg=emb_kg,
        total_kg=op_kg + emb_kg, recommended_core=best.name,
        measured_cycles=cycles, wcet_cycles=wcet_cycles,
        certified_energy_j=cert_e, certified_operational_kg=cert_op)


def simulation_footprint_kg(wall_s: float, power_w: float, n_chips: int = 1,
                            intensity: float = 0.367) -> float:
    """Carbon of running the simulation itself: the card's power limit
    (an upper bound on its draw) x PUE x wall time."""
    kwh = n_chips * power_w * PUE * wall_s / 3600.0 / 1000.0
    return kwh * intensity


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Fleet-wide pricing + engine accounting. The per-group reports are
    the demux of one packed stream, whose whole-run stats are `packed`;
    `power_w` is the power limit of the card that ran it (None when it
    ran on the CPU without one being given)."""
    groups: List[GroupReport]
    intensity: float
    packed: Optional[PackedStats] = None
    power_w: Optional[float] = None

    @property
    def n_items(self) -> int:
        return sum(g.result.n_items for g in self.groups)

    @property
    def lane_steps(self) -> int:
        """Lane-step slots attributed to groups' active lanes (the packed
        stats additionally count idle slots)."""
        return sum(g.result.lane_steps for g in self.groups)

    @property
    def monolithic_lane_steps(self) -> int:
        return sum(g.result.monolithic_lane_steps for g in self.groups)

    @property
    def busy_steps(self) -> int:
        return sum(g.result.busy_steps for g in self.groups)

    @property
    def wall_s(self) -> float:
        if self.packed is not None:
            return self.packed.wall_s      # one stream, measured once
        return sum(g.result.wall_s for g in self.groups)

    @property
    def total_kg(self) -> float:
        return sum(g.total_kg for g in self.groups)

    @property
    def cycles_saved_ratio(self) -> float:
        """Monolithic lane-steps / streaming lane-steps (higher = better)."""
        return self.monolithic_lane_steps / max(self.lane_steps, 1)

    def simulation_kg(self, n_chips: int = 1) -> Optional[float]:
        if self.power_w is None:
            return None
        return simulation_footprint_kg(self.wall_s, self.power_w, n_chips,
                                       self.intensity)

    def format(self) -> str:
        certified = any(g.wcet_cycles is not None for g in self.groups)
        head = (f"{'group':<22} {'core':<5} {'items':>8} {'instr/item':>11} "
                f"{'cyc/item':>10} "
                + (f"{'wcet-cyc':>10} " if certified else "")
                + f"{'mWh/fleet-exec':>14} "
                f"{'kg CO2e (op+emb)':>17} {'best':>5}")
        lines = [head, "-" * len(head)]
        for g in self.groups:
            mean_instr = (g.profile.n_one_stage + g.profile.n_two_stage)
            wcet = ""
            if certified:
                wcet = f"{'-':>10} " if g.wcet_cycles is None \
                    else f"{g.wcet_cycles:>10.0f} "
            lines.append(
                f"{g.workload.key + ' ' + g.workload.algorithm:<22.22} "
                f"{g.core.name:<5} {g.result.n_items:>8} "
                f"{mean_instr:>11.1f} {g.cycles_per_item:>10.1f} "
                + wcet +
                f"{g.fleet_exec_kwh * 1e6:>14.3f} "
                f"{g.operational_kg:>8.3g}+{g.embodied_kg:<8.3g} "
                f"{g.recommended_core:>5}")
        lines.append("-" * len(head))
        eff = 100.0 * self.busy_steps / max(self.lane_steps, 1)
        steppers = sorted({g.result.stepper for g in self.groups})
        n_dev = max((g.result.n_devices for g in self.groups), default=1)
        sim = self.simulation_kg()
        sim_txt = "not measured (no card power limit)" if sim is None \
            else f"{sim * 1e3:.3g} g CO2e"
        lines.append(
            f"fleet: {self.n_items} items, {self.total_kg:.4g} kg CO2e; "
            f"engine: {self.lane_steps:,} lane-steps "
            f"({eff:.1f}% busy) vs {self.monolithic_lane_steps:,} "
            f"monolithic ({self.cycles_saved_ratio:.2f}x saved); "
            f"stepper {'/'.join(steppers)} x{n_dev} dev; "
            f"sim footprint {sim_txt} ({self.wall_s:.2f}s wall)")
        if certified:
            cert = [g for g in self.groups if g.wcet_cycles is not None]
            cert_op = sum(g.certified_operational_kg for g in cert)
            meas_op = sum(g.operational_kg for g in cert)
            lines.append(
                f"certified (FlexiLint §9.11): worst-case operational "
                f"{cert_op:.4g} kg CO2e vs {meas_op:.4g} measured/analytic "
                f"({cert_op / max(meas_op, 1e-30):.2f}x headroom, "
                f"{len(cert)}/{len(self.groups)} groups certified)")
        if self.packed is not None:
            p = self.packed
            lines.append(
                f"packed runtime: {p.n_groups} groups in one stream "
                f"(bank {p.n_progs}x{p.bank_width} words), "
                f"{p.n_segments} segments, {p.lane_steps:,} lane-step "
                f"slots incl. idle, chunk {p.chunk}")
            mode = f"{p.refill}-refill" \
                + (", adaptive supersteps" if p.adaptive else "")
            lines.append(
                f"sync stats ({mode}): {p.host_syncs} blocking host "
                f"syncs ({p.sync_wait_s:.3f}s waited), refill host work "
                f"{p.refill_wall_s:.3f}s, device busy "
                f"{100.0 * p.device_busy_frac:.1f}%")
            if p.redundancy != "none" or p.detected or p.quarantined:
                lines.append(
                    f"resilience (FlexiFault §9.14, {p.redundancy}): "
                    f"{p.detected} divergences detected, {p.corrected} "
                    f"corrected by segment re-execution, "
                    f"{p.quarantined} lane pairs quarantined")
            if p.n_shards > 1 and p.shard_retired:
                lines.append(
                    f"shard-local (DESIGN.md §9.12): {p.n_shards} shards "
                    f"on {p.n_devices} device(s), retired/shard "
                    f"{list(p.shard_retired)}, lane-steps/shard "
                    f"{list(p.shard_lane_steps)}: collective-free segment "
                    f"loop, {p.host_syncs} host syncs total (not x shards)")
        return "\n".join(lines)
