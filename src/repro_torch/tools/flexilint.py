"""FlexiLint CLI: static analysis of FlexiBench programs (DESIGN.md §9.11).

The reference's `tools/flexilint.py` over the port's copies of the
analyzer, the workloads, the cycle model and PyISS; no JAX.

Runs the `flexibits/analyze.py` binary analyzer over encoded FlexiBench
workloads — CFG recovery, def-use dataflow, memory-bounds proofs, and
WCET cycle certificates — and prints one lint report per program.

    PYTHONPATH=src python -m repro_torch.tools.flexilint        # all 11
    PYTHONPATH=src python -m repro_torch.tools.flexilint WQ HC  # a subset
    PYTHONPATH=src python -m repro_torch.tools.flexilint --measure 3

Exit status is the CI contract: 0 when every analyzed program is free
of ERROR diagnostics, 1 otherwise (`--strict` also fails on warnings
and degraded CFGs). `--measure N` additionally executes each program
through the PyISS oracle on N generated inputs and cross-checks the
certificate: every retired word must lie in the static reachable set,
every retired mnemonic in the static subset, and measured ticks must
not exceed the WCET bound — a violation is a soundness bug and fails
the run regardless of flags.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.flexibench import base as fb
from repro_torch.flexibits import analyze
from repro_torch.flexibits.cycles import CORES, cost_row
from repro_torch.flexibits.pyiss import PyISS


def _measure(w, a: analyze.Analysis, cost, n_inputs: int, seed: int):
    """PyISS cross-validation: returns (max_ticks, violations)."""
    rng = np.random.default_rng(seed)
    xs = w.gen_inputs(rng, n_inputs)
    max_ticks = 0
    violations = []
    for x in xs:
        sim = PyISS(w.program.code, mem_words=w.total_mem_words,
                    init_mem=w.initial_memory(x))
        sim.run(max_steps=w.max_steps)
        if not sim.halted:
            violations.append(f"did not halt within {w.max_steps} steps")
            continue
        stray = sim.visited - a.reachable
        if stray:
            violations.append(f"retired words outside static reachable "
                              f"set: {sorted(stray)[:8]}")
        names = set(sim.mix) - a.reachable_names
        if names:
            violations.append(f"retired mnemonics outside static "
                              f"subset: {sorted(names)}")
        if a.wcet_steps is not None and sim.n_instr > a.wcet_steps:
            violations.append(f"measured steps {sim.n_instr} > "
                              f"wcet-steps {a.wcet_steps}")
        if a.min_steps is not None and sim.n_instr < a.min_steps:
            violations.append(f"measured steps {sim.n_instr} < "
                              f"min-steps {a.min_steps}")
        ticks = sim.ticks(cost)
        w_ticks = a.wcet_ticks(cost)
        if w_ticks is not None and ticks > w_ticks:
            violations.append(f"measured ticks {ticks} > "
                              f"wcet-ticks {w_ticks}")
        max_ticks = max(max_ticks, ticks)
    return max_ticks, violations


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="flexilint",
        description="Static analysis & WCET certificates for FlexiBench "
                    "programs (DESIGN.md §9.11)")
    p.add_argument("workloads", nargs="*",
                   help="FlexiBench keys (default: all)")
    p.add_argument("--core", default="SERV", choices=sorted(CORES),
                   help="core whose cost row prices the WCET")
    p.add_argument("--timing", default="dynamic",
                   choices=("base", "dynamic"),
                   help="cost row flavor for the tick bound")
    p.add_argument("--measure", type=int, default=0, metavar="N",
                   help="cross-check via PyISS on N generated inputs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--strict", action="store_true",
                   help="also fail on warnings and degraded CFGs")
    args = p.parse_args(argv)

    if args.workloads:
        try:
            wls = [fb.get(k) for k in args.workloads]
        except KeyError as e:
            p.error(f"unknown workload {e.args[0]!r}; known: "
                    + " ".join(w.key for w in fb.all_workloads()))
    else:
        wls = fb.all_workloads()

    cost = cost_row(CORES[args.core], dynamic=args.timing == "dynamic")
    failed = False
    for w in wls:
        t0 = time.perf_counter()
        a = analyze.analyze_workload(w)
        wall_ms = (time.perf_counter() - t0) * 1e3
        measured = None
        violations = []
        if args.measure > 0:
            measured, violations = _measure(w, a, cost, args.measure,
                                            args.seed)
        print(a.format_report(cost, measured_ticks=measured))
        for v in violations:
            print(f"  SOUNDNESS VIOLATION: {v}")
        print(f"  analysis wall time {wall_ms:.1f} ms "
              f"({args.core} {args.timing} cost row)")
        print()
        if a.errors or violations:
            failed = True
        if args.strict and (a.warnings or a.degraded is not None):
            failed = True

    n = len(wls)
    print(f"flexilint: {n} program(s) analyzed, "
          + ("FAIL" if failed else "ok"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
