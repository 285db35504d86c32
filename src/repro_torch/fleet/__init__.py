"""Packed, device-resident fleet simulation (the port of `repro.fleet`).

- `engine.run_packed` — every group of a heterogeneous plan in ONE pool
                        of lanes on the card (program bank, per-lane
                        prog_id and budget, admission scheduler), with
                        on-device retire/refill and one small async
                        stats read per segment (`refill="host"`: the
                        host-refill A/B loop); durable with
                        `checkpoint_dir=`
- `engine.run_stream`, `engine.run_workload_stream` — one program or
                        one FlexiBench workload through the same runtime
- `plan.FleetPlan`    — heterogeneous (workload, core) sub-fleets;
                        `run_plan` lowers, checks and runs them, packed
                        or (`packed=False`) group after group
- `report.FleetReport` — per-group tallies priced through core/carbon.py
                        and core/selection.py
"""
from repro_torch.fleet.engine import (REFILLS, FleetResult, InjectedFault,
                                      PackedGroup, PackedStats,
                                      array_source, run_packed, run_stream,
                                      run_workload_stream, workload_source)
from repro_torch.fleet.plan import (BudgetError, FleetGroup, FleetPlan,
                                    run_plan)
from repro_torch.fleet.report import FleetReport, GroupReport

__all__ = [
    "REFILLS", "FleetResult", "InjectedFault", "PackedGroup", "PackedStats",
    "array_source", "run_packed", "run_stream", "run_workload_stream",
    "workload_source", "BudgetError", "FleetGroup",
    "FleetPlan", "run_plan", "FleetReport", "GroupReport",
]
