"""Packed, device-resident fleet simulation (the port of `repro.fleet`).

- `engine.run_packed` — every group of a heterogeneous plan in ONE pool
                        of lanes on the card (program bank, per-lane
                        prog_id and budget, admission scheduler), with
                        on-device retire/refill and one small async
                        stats read per segment
- `plan.FleetPlan`    — heterogeneous (workload, core) sub-fleets;
                        `run_plan` lowers, checks and runs them
- `report.FleetReport` — per-group tallies priced through core/carbon.py
                        and core/selection.py
"""
from repro_torch.fleet.engine import (REFILLS, FleetResult, PackedGroup,
                                      PackedStats, array_source,
                                      run_packed, workload_source)
from repro_torch.fleet.plan import (BudgetError, FleetGroup, FleetPlan,
                                    run_plan)
from repro_torch.fleet.report import FleetReport, GroupReport

__all__ = [
    "REFILLS", "FleetResult", "PackedGroup", "PackedStats", "array_source",
    "run_packed", "workload_source", "BudgetError", "FleetGroup",
    "FleetPlan", "run_plan", "FleetReport", "GroupReport",
]
