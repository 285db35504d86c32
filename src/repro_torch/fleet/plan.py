"""Heterogeneous fleet plans: (workload, core) sub-fleets in one run.

A `FleetPlan` pins FlexiBench workloads to FLEXIBITS cores and deployment
profiles (`FleetGroup`s); `run_plan` checks it statically (FlexiLint's
shortest path to HALT rejects budgets that cannot reach the ecall with a
`BudgetError`; `max_steps="static"` derives a budget from the WCET;
`subset_source="static"` takes the reachable-only opcode subset), runs
every group through ONE packed, resident stream (`engine.run_packed`),
and prices the per-group tallies in a `FleetReport`, under the plan's
fault schedule and redundancy (FlexiFault, DESIGN.md §9.14) when it has
them. `packed=False` is the reference's sequential A/B baseline: the
groups drain one after another, one stream each
(`engine.run_workload_stream`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from repro_torch.device import DeviceLike, card_power_limit_w, resolve
from repro_torch.flexibench import base as fb
from repro_torch.flexibits import analyze
from repro_torch.flexibits.cycles import (CORES, TICKS_PER_CYCLE, Core,
                                          cost_row)
from repro_torch.flexibits.faults import FaultSpec
from repro_torch.fleet import engine
from repro_torch.fleet.report import FleetReport, build_group_report


class BudgetError(ValueError):
    """A group's `max_steps` budget is statically proved insufficient:
    FlexiLint's shortest path to HALT (`Analysis.min_steps`, a sound
    lower bound on retirements) already exceeds the budget."""

    def __init__(self, name: str, budget: int, min_steps: int):
        self.name = name
        self.budget = budget
        self.min_steps = min_steps
        super().__init__(
            f"workload {name!r}: max_steps budget {budget} cannot reach "
            f"HALT — the statically shortest path to the ecall retires "
            f"{min_steps} instructions (FlexiLint min_steps, §9.11)")


@dataclasses.dataclass(frozen=True)
class FleetGroup:
    """One homogeneous sub-fleet: n_items of one workload on one core.

    `max_steps`: None takes the workload's hand-set budget, an int
    overrides it, "static" derives it from FlexiLint's WCET bound."""
    workload: str                         # FlexiBench key (WQ, MC, ...)
    core: str = "SERV"                    # FLEXIBITS core name
    n_items: int = 1024
    seed: int = 0
    lifetime_s: Optional[float] = None    # default: workload Table-2 value
    execs_per_day: Optional[float] = None
    max_steps: Union[int, str, None] = None   # int | "static" | None

    def resolve(self) -> Tuple[fb.Workload, Core, float, float]:
        w = fb.get(self.workload)
        core = CORES[self.core]
        life = self.lifetime_s if self.lifetime_s is not None \
            else w.lifetime_s
        freq = self.execs_per_day if self.execs_per_day is not None \
            else w.execs_per_day
        return w, core, life, freq

    def resolve_max_steps(self, w: fb.Workload,
                          analysis: analyze.Analysis) -> int:
        """The group's effective per-item step budget (see class doc)."""
        if self.max_steps == "static":
            if analysis.wcet_steps is None:
                raise ValueError(
                    f"workload {w.key!r}: max_steps='static' needs a "
                    f"finite FlexiLint WCET, but the analysis has none "
                    f"(degraded: {analysis.degraded!r})")
            return analysis.wcet_steps
        if self.max_steps is not None:
            return int(self.max_steps)
        return w.max_steps


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A full heterogeneous fleet plus engine knobs.

    `chunk` lanes run every group in one packed stream, in segments of
    up to `seg_steps` steps (`adaptive` sizes them from the observed halt
    cadence); `prefetch` overlaps input generation with the device.
    `timing` turns on the per-lane cycle layer: "base" prices the
    (stage, class) table only, "dynamic" adds taken-branch refetch,
    serial shift amount and subword read-modify-write; the report then
    prices from measured mean cycles. `validate_budgets` runs the
    FlexiLint budget gate; `subset_source` picks the plain stepper's
    opcode subset ("text" or the analyzer's reachable-only "static").
    `faults` (a `faults.FaultSpec`) injects faults into every lane;
    `redundancy="dmr"` runs every item on a lane pair with rollback
    recovery, quarantining a pair after `max_retries` consecutive
    mismatches; the report prices the plan's redundancy and fault rate.
    `packed=False` drains the groups one after another instead of in one
    packed stream; `refill="host"` runs the host-refill A/B loop."""
    groups: Sequence[FleetGroup]
    chunk: int = 256
    seg_steps: int = 4096
    intensity: float = 0.367              # kg CO2e/kWh (US grid)
    clock_hz: float = 10_000.0
    prefetch: bool = True
    packed: bool = True
    refill: str = "device"
    adaptive: bool = False
    timing: Optional[str] = None          # None | "base" | "dynamic"
    validate_budgets: bool = True         # FlexiLint min-steps gate
    subset_source: str = "text"           # "text" | "static"
    faults: Optional[FaultSpec] = None    # FlexiFault schedule
    redundancy: str = "none"              # "none" | "dmr"
    max_retries: int = 2                  # DMR rollbacks before quarantine

    @property
    def n_items(self) -> int:
        return sum(g.n_items for g in self.groups)


def _group_cost(plan: FleetPlan, core: Core):
    """The group's engine cost row under the plan's timing mode."""
    if plan.timing is None:
        return None
    if plan.timing not in ("base", "dynamic"):
        raise ValueError('timing must be None, "base", or "dynamic"')
    return cost_row(core, dynamic=plan.timing == "dynamic")


def _static_pass(plan: FleetPlan, g: FleetGroup, w: fb.Workload,
                 core: Core):
    """FlexiLint pre-flight for one group: resolve the step budget,
    reject provably insufficient budgets, pick the plain stepper's
    subset, and price the certified worst-case cycle bound (always with
    the dynamic cost row: the bound must hold on real hardware)."""
    if plan.subset_source not in ("text", "static"):
        raise ValueError('subset_source must be "text" or "static"')
    analysis = analyze.analyze_workload(w)
    max_steps = g.resolve_max_steps(w, analysis)
    if plan.validate_budgets and analysis.min_steps is not None \
            and max_steps < analysis.min_steps:
        raise BudgetError(w.key, max_steps, analysis.min_steps)
    subset = analysis.subset if plan.subset_source == "static" else None
    wcet_ticks = analysis.bound_ticks(cost_row(core, dynamic=True),
                                      max_steps)
    wcet_cycles = None if wcet_ticks is None \
        else wcet_ticks / TICKS_PER_CYCLE
    return max_steps, subset, wcet_cycles


def _packed_groups(plan: FleetPlan):
    """Lower FleetGroups to engine-level PackedGroups (one bank row per
    group, so prog_id doubles as the group id)."""
    lowered = []
    resolved = []
    for g in plan.groups:
        w, core, lifetime_s, execs_per_day = g.resolve()
        max_steps, subset, wcet_cycles = _static_pass(plan, g, w, core)
        resolved.append((w, core, lifetime_s, execs_per_day, wcet_cycles))
        lowered.append(engine.PackedGroup(
            code=w.program.code, source=engine.workload_source(w, g.seed),
            n_items=g.n_items, max_steps=max_steps,
            mem_words=w.total_mem_words, out_addr=w.out_addr,
            cost=_group_cost(plan, core), subset=subset))
    return lowered, resolved


def run_plan(plan: FleetPlan, mesh=None, keep_state: bool = False,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 0, device: DeviceLike = None,
             power_w: Optional[float] = None) -> FleetReport:
    """Execute the plan and price it through the carbon report.

    With `plan.packed` (the default) every group runs in ONE packed
    stream (`engine.run_packed`), and `checkpoint_dir`/`checkpoint_every`
    make that stream durable (a checkpoint every `checkpoint_every`
    segments, and a bit-exact resume from the newest intact one); with
    `packed=False` the groups drain one after another, one stream each,
    and the report carries no packed stats.

    Runs on the card by default (`device=None` means "cuda", and raises
    without one); `device="cpu"` runs the plain PyTorch path. `power_w`
    is the power limit the simulation's own footprint is priced at:
    None reads the card's from `nvidia-smi` (on the CPU it stays None
    and the footprint is reported as not measured).
    """
    if checkpoint_dir is not None and not (plan.packed and plan.groups):
        raise ValueError("checkpointing requires a packed plan")
    dev = resolve(device)
    if not plan.groups:
        raise ValueError("a plan needs at least one group")
    if power_w is None and dev.type == "cuda":
        power_w = card_power_limit_w(dev.index)

    def report(g, w, core, lifetime_s, execs_per_day, wcet_cycles, res):
        return build_group_report(
            group=g, workload=w, core=core, result=res,
            lifetime_s=lifetime_s, execs_per_day=execs_per_day,
            intensity=plan.intensity, clock_hz=plan.clock_hz,
            wcet_cycles=wcet_cycles, redundancy=plan.redundancy,
            fault_rate=0.0 if plan.faults is None else plan.faults.rate)

    if not plan.packed:
        group_reports = []
        for g in plan.groups:
            w, core, lifetime_s, execs_per_day = g.resolve()
            max_steps, subset, wcet_cycles = _static_pass(plan, g, w, core)
            res = engine.run_workload_stream(
                w, g.n_items, seed=g.seed, chunk=plan.chunk,
                seg_steps=plan.seg_steps, max_steps=max_steps,
                keep_state=keep_state, mesh=mesh, prefetch=plan.prefetch,
                refill=plan.refill, adaptive=plan.adaptive,
                cost=_group_cost(plan, core), subset=subset,
                faults=plan.faults, redundancy=plan.redundancy,
                max_retries=plan.max_retries, device=dev)
            group_reports.append(report(g, w, core, lifetime_s,
                                        execs_per_day, wcet_cycles, res))
        return FleetReport(groups=group_reports, intensity=plan.intensity,
                           power_w=power_w)

    lowered, resolved = _packed_groups(plan)
    results, stats = engine.run_packed(
        lowered, chunk=plan.chunk, seg_steps=plan.seg_steps,
        keep_state=keep_state, mesh=mesh, prefetch=plan.prefetch,
        refill=plan.refill, adaptive=plan.adaptive,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        faults=plan.faults, redundancy=plan.redundancy,
        max_retries=plan.max_retries, device=dev)
    group_reports = [report(g, *r, res)
                     for g, r, res in zip(plan.groups, resolved, results)]
    return FleetReport(groups=group_reports, intensity=plan.intensity,
                       packed=stats, power_w=power_w)
