"""Fleet-scale ILI simulation on the PyTorch / CUDA port: the paper's
trillion-item story.

Runs a *heterogeneous* fleet — different workloads on different FLEXIBITS
cores, one FleetPlan — through the port's streaming engine (DESIGN.md
§9): items flow through a fixed pool of lanes in segments, halted items
are retired and refilled on the card, and per-group cycle/energy tallies
are priced through the FLEXIFLOW carbon model, including the
carbon-optimal core for each group's (lifetime, frequency) deployment
point and the footprint of the simulation itself, priced from the card's
power limit.

The counterpart of `examples/fleet_simulation.py`, with the same three
groups and flags, except:
- `--shards N` takes the place of the host mesh: N logical shards of one
  device (`mesh=[device] * N`; none at N = 1);
- `--device` selects the card (the default) or the CPU;
- `--stepper` defaults to "pallas", the kernel route: on the card the
  segment runs in the `iss_segment_banked` CUDA kernel. The port's
  "branchless" and "switch" steppers are the reference's XLA baselines
  in eager torch, a kernel launch per op and a host read per step, and
  ran 14x slower than the kernel route on the card (PERF.md §6); the
  reference's default, "branchless", suits XLA, which fuses it.

Run:  PYTHONPATH=src python examples/torch_fleet_simulation.py [--items 512]
"""
import argparse

import numpy as np

from repro_torch.device import resolve
from repro_torch.fleet import REFILLS, STEPPERS, FleetGroup, FleetPlan, \
    run_plan


def build_plan(args) -> FleetPlan:
    # three sub-fleets: malodor classification on the 1-bit core (long
    # lifetime, low frequency), water quality on the 4-bit core, smart
    # irrigation on the 8-bit core (frequent executions favor wide cores)
    return FleetPlan(groups=(
        FleetGroup(workload="MC", core="SERV", n_items=args.items, seed=0),
        FleetGroup(workload="WQ", core="QERV", n_items=args.items, seed=1),
        FleetGroup(workload="SI", core="HERV", n_items=args.items, seed=2),
    ), chunk=args.chunk, seg_steps=args.seg_steps, stepper=args.stepper,
        packed=args.packed, refill=args.refill, adaptive=args.adaptive)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=256,
                    help="items per group")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--seg-steps", type=int, default=1024)
    ap.add_argument("--stepper", choices=STEPPERS, default="pallas",
                    help="segment interpreter (DESIGN.md §9.5/§9.7): "
                         "'pallas' = the CUDA segment kernel on the card")
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run all groups in one packed multi-program "
                         "stream (DESIGN.md §9.8); --no-packed drains "
                         "groups sequentially (the A/B baseline)")
    ap.add_argument("--refill", choices=REFILLS, default="device",
                    help="stream loop (DESIGN.md §9.9): 'device' = "
                         "resident runtime (retire/refill on the card, "
                         "async stats read), 'host' = host-refill A/B "
                         "baseline")
    ap.add_argument("--adaptive", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="adaptive supersteps: pick each segment's step "
                         "bound from the observed halt cadence "
                         "(DESIGN.md §9.9)")
    ap.add_argument("--shards", type=int, default=1,
                    help="logical shards of the device (shard-local "
                         "streaming); 1 = no mesh")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the plan and print its report; returns the FleetReport."""
    args = parse_args(argv)
    if args.shards < 1:
        raise SystemExit("--shards must be >= 1")
    dev = resolve(args.device)
    plan = build_plan(args)
    mesh = [dev] * args.shards if args.shards > 1 else None
    report = run_plan(plan, mesh=mesh, device=None if mesh else dev)

    mode = "packed" if args.packed else "sequential"
    where = f"{args.shards} shard(s) of {dev}"
    print(f"[fleet] {report.n_items} items on {where} ({mode} runtime, "
          f"{args.refill} refill, {args.stepper} stepper"
          f"{', adaptive supersteps' if args.adaptive else ''})")
    if report.packed is not None:
        p = report.packed
        print(f"[fleet] sync: {p.host_syncs} blocking host syncs over "
              f"{p.n_segments} segments, refill host work "
              f"{p.refill_wall_s * 1e3:.1f} ms, device busy "
              f"{100.0 * p.device_busy_frac:.1f}% (engine estimate)")
    mc = report.groups[0].result
    print(f"[fleet] MC malodor score histogram: "
          f"{np.bincount(mc.out, minlength=5)}")
    print(report.format())
    return report


if __name__ == "__main__":
    main()
