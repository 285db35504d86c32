"""`examples/torch_fleet_simulation.py` on the CPU (`--device cpu`, the
kernels' plain versions) at 16 items a group: every per-item result and
the carbon report equal the reference's `repro.fleet.run_plan` on the
same plan (under the reference's default stepper: per-item results do
not depend on it)."""
import numpy as np

import _torch_parity as tp
from _torch_parity import load_example, one_torch_thread  # noqa: F401
from repro.fleet import plan as rplan


def test_fleet_example_equals_reference(capsys):
    mod = load_example("torch_fleet_simulation")
    args = mod.parse_args(["--items", "16"])
    plan = rplan.FleetPlan(groups=tuple(
        rplan.FleetGroup(workload=g.workload, core=g.core,
                         n_items=g.n_items, seed=g.seed)
        for g in mod.build_plan(args).groups),
        chunk=args.chunk, seg_steps=args.seg_steps, packed=args.packed,
        refill=args.refill, adaptive=args.adaptive)
    reference = rplan.run_plan(plan)
    rep = mod.main(["--device", "cpu", "--items", "16"])
    out = capsys.readouterr().out
    tp.assert_results_equal([g.result for g in reference.groups],
                            [g.result for g in rep.groups],
                            "fleet example")
    for a, b in zip(reference.groups, rep.groups):
        assert (a.total_kg, a.recommended_core) == \
            (b.total_kg, b.recommended_core)
    assert rep.packed.n_shards == 1
    assert "[fleet] 48 items on 1 shard(s) of cpu" in out
    hist = np.bincount(rep.groups[0].result.out, minlength=5)
    assert f"MC malodor score histogram: {hist}" in out
