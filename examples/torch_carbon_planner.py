"""What-if carbon planning from one command line, on the PyTorch / CUDA
port (DESIGN.md §9.13).

The paper's Fig. 5 answers ONE planning question — which FlexIC core
minimizes total carbon at a known (lifetime, task frequency)? Real
deployments don't know their lifetime: the paper's own premise is a
1000X spread. This CLI prices the whole uncertain planning space in one
Monte Carlo sweep (`repro_torch.core.sweep.run_sweep`; on the card each
tile of cells is one launch of the `sweep_tile_drawn` CUDA kernel, which
draws the lifetimes and reduces them) and reports:

- the core-selection share per (distribution x frequency) — Fig. 5 with
  lifetime uncertainty marginalized instead of assumed;
- Monte Carlo percentiles of per-item total carbon;
- the embodied-vs-operational Pareto frontier streamed out of the
  sweep, annotated with pairwise crossover lifetimes
  (`selection.crossover_lifetimes`);
- with --serving, the beyond-paper LLM-serving analogue: the float64
  torch planner `sweep.serving_plan` on the device against the numpy
  `planner.plan_grid` oracle, for an H100 SXM serving chip
  (`planner.h100_sxm`: the data sheet's HBM bandwidth, the card's power
  limit or --power-w, and --embodied-kg, which the caller must give: the
  repo has no life-cycle figure for an H100).

The counterpart of `examples/carbon_planner.py`, with the same
distribution grammar, flags and tables, except that the reference's
`--path {jnp,pallas}` is dropped (the port has one sweep path a device:
the kernel on the card, its plain version on the CPU), and `--device`,
`--embodied-kg` and `--power-w` are added.

Distribution grammar (--dist, repeatable; durations take s/h/d/y):
    point:90d            lognormal:100d:1.8        weibull:300d:1.5
    mix:point:10d@0.3+lognormal:1000d:0.8@0.7

Run:  PYTHONPATH=src python examples/torch_carbon_planner.py
      PYTHONPATH=src python examples/torch_carbon_planner.py \
          --workloads CT,WQ --dist lognormal:1y:1.8 --dist point:90d \
          --freqs 1,24,960 --draws 256 --serving --embodied-kg 1500
"""
import argparse

import numpy as np

from repro_torch.core import planner
from repro_torch.core.selection import crossover_lifetimes
from repro_torch.core.sweep import (DAY_S, YEAR_S, LifetimeDist, run_sweep,
                                    serving_plan, workload_spec)
from repro_torch.device import resolve

_UNITS = {"s": 1.0, "h": 3600.0, "d": DAY_S, "y": YEAR_S}


def parse_duration(tok: str) -> float:
    tok = tok.strip()
    if tok[-1].lower() in _UNITS:
        return float(tok[:-1]) * _UNITS[tok[-1].lower()]
    return float(tok)                      # bare number = seconds


def parse_dist(spec: str) -> LifetimeDist:
    """point:90d | lognormal:100d:1.8 | weibull:300d:1.5 |
    mix:<comp>@<w>+<comp>@<w>  (component = one of the three above,
    with ':' separators inside)."""
    kind, _, rest = spec.partition(":")
    kind = kind.lower()
    if kind == "point":
        return LifetimeDist.point(parse_duration(rest), name=spec)
    if kind == "lognormal":
        med, sigma = rest.rsplit(":", 1)
        return LifetimeDist.lognormal(parse_duration(med), float(sigma),
                                      name=spec)
    if kind == "weibull":
        scale, shape = rest.rsplit(":", 1)
        return LifetimeDist.weibull(parse_duration(scale), float(shape),
                                    name=spec)
    if kind == "mix":
        parts = []
        for term in rest.split("+"):
            comp, _, w = term.rpartition("@")
            parts.append((parse_dist(comp), float(w)))
        return LifetimeDist.mixture(parts, name=spec)
    raise SystemExit(f"unknown distribution spec {spec!r} "
                     f"(point/lognormal/weibull/mix)")


def fmt_life(seconds: float) -> str:
    if seconds >= YEAR_S:
        return f"{seconds / YEAR_S:.1f}y"
    if seconds >= DAY_S:
        return f"{seconds / DAY_S:.1f}d"
    return f"{seconds / 3600.0:.1f}h"


def share_map(res) -> None:
    """Fig.-5-with-uncertainty: chosen-candidate share per (dist, freq),
    aggregated over every other axis. Candidates are (core, redundancy)
    pairs when --redundancies asks for more than 'none' (§9.14)."""
    spec = res.spec
    names = [c.name if r == "none" else f"{c.name}+{r}"
             for r in spec.redundancies for c in spec.cores]
    share = res.core_share.mean(axis=(2, 3, 4, 5, 6))   # (D, F, C*R)
    print(f"\n[selection] candidate share per (distribution x "
          f"execs/day), {spec.draws} draws/cell:")
    hdr = " ".join(f"{f:>21g}" for f in spec.execs_per_day)
    print(f"  {'distribution':<32} {hdr}")
    for di, d in enumerate(spec.dists):
        row = []
        for fi in range(len(spec.execs_per_day)):
            s = share[di, fi]
            row.append("+".join(f"{names[c][0]}{s[c]:.0%}"
                                for c in np.argsort(-s) if s[c] >= 0.005))
        print(f"  {d.name:<32} " + " ".join(f"{r:>21}" for r in row))


def percentile_table(res) -> None:
    print(f"\n[risk] per-item total kg CO2e across the whole space "
          f"({res.n_scenarios} scenarios):")
    for q in (0.5, 0.9, 0.99):
        print(f"  p{int(q * 100):<3} <= {res.quantile(q):.3e} kg")
    i, j = res.hist.nonzero()[0][[0, -1]] if res.hist.any() else (0, 0)
    print(f"  support [{res.hist_edges[i]:.2e}, "
          f"{res.hist_edges[j + 1]:.2e}] kg over {len(res.hist)} "
          f"log bins")


def frontier_table(res) -> None:
    rows = res.frontier()
    print(f"\n[frontier] embodied-vs-operational Pareto points "
          f"({len(rows)} non-dominated):")
    if len(rows) <= 1:
        print("  (marginalizing heterogeneous intensities/frequencies "
              "collapses the frontier — the cheapest-embodied bin also "
              "reaches the lowest operational; pin --intensities and "
              "--freqs to single values to see the core/workload "
              "tradeoff curve)")
    print(f"  {'embodied kg':>12} {'operational kg':>15} {'core':>5} "
          f"{'workload':>9} {'life':>7}  scenario")
    spec = res.spec
    for r in rows:
        cross = ""
        wi = spec.workloads.index(r["workload"])
        ci = [c.name for c in spec.cores].index(r["core"])
        mat = crossover_lifetimes(spec.profiles[wi], r["execs_per_day"],
                                  r["intensity"], cores=spec.cores)
        nxt = np.where(np.isfinite(mat[ci]))[0]
        if len(nxt):
            k = nxt[np.argmin(mat[ci][nxt])]
            cross = (f"  ({spec.cores[k].name} overtakes at "
                     f"{fmt_life(mat[ci][k])})")
        red = "" if r["redundancy"] == "none" \
            else f", {r['redundancy']}@{r['fault_rate']:g}/instr"
        print(f"  {r['embodied_kg']:>12.3e} {r['operational_kg']:>15.3e} "
              f"{r['core']:>5} {r['workload']:>9} "
              f"{fmt_life(r['lifetime_s']):>7}  "
              f"{r['dist']}, {r['execs_per_day']:g}/day, "
              f"{r['intensity']:g} kg/kWh{red}{cross}")


def serving_demo(chip: planner.ServeChip, device) -> bool:
    """The serving planner on `device` against the numpy oracle; True
    when every cell is equal bit for bit."""
    kv = 32 * 8 * 128 * 2 * 2
    kw = dict(chip=chip, n_params=8e9, kv_bytes_per_token=kv,
              lifetimes_days=np.array([7.0, 90.0, 3 * 365.0]),
              qps_grid=np.logspace(2, 6, 9))
    plan = serving_plan(device=device, **kw)
    ref = planner.plan_grid(**kw)
    got = {k: plan[k].cpu().numpy() for k in ("variant_idx", "chips",
                                               "total_kg")}
    ok = all(got[k].dtype == ref[k].dtype
             and np.array_equal(got[k].view(np.uint8),
                                ref[k].view(np.uint8)) for k in got)
    print(f"\n[serving] minitron-8b (lifetime x QPS) on an H100 SXM "
          f"({chip.hbm_bw:.3g} B/s, {chip.power_w:g} W, "
          f"{chip.embodied_kg:g} kg CO2e a chip), torch mirror on "
          f"{plan['total_kg'].device.type} {'==' if ok else '!='} numpy "
          f"plan_grid: rows=lifetime {{7d, 90d, 3y}}, cols=qps 1e2..1e6")
    vi, chips = got["variant_idx"], got["chips"]
    for li in range(vi.shape[0]):
        row = ["-" if vi[li, qi] < 0 else
               f"{plan['variants'][vi[li, qi]]}/{chips[li, qi]}"
               for qi in range(vi.shape[1])]
        print("   ", " ".join(f"{r:8s}" for r in row))
    print("(W4 pays QAT carbon up front -> only long/hot deployments "
          "pick it; the paper's embodied-vs-operational crossover.)")
    return ok


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Monte Carlo what-if carbon planner (§9.13)")
    ap.add_argument("--workloads", default="CT,WQ,GR",
                    help="comma-separated FlexiBench keys")
    ap.add_argument("--dist", action="append", default=[],
                    help="lifetime distribution spec (repeatable)")
    ap.add_argument("--freqs", default="1,24,960",
                    help="task executions per day (comma-separated)")
    ap.add_argument("--intensities", default="0.05,0.367,0.7",
                    help="grid kg CO2e/kWh (comma-separated)")
    ap.add_argument("--volumes", default="1e6",
                    help="deployment volumes (comma-separated)")
    ap.add_argument("--timing", default="base",
                    help="timing modes: base,dynamic,wcet,measured")
    ap.add_argument("--fault-rates", default="0",
                    help="per-instruction transient fault rates "
                         "(comma-separated scenario axis, §9.14)")
    ap.add_argument("--redundancies", default="none",
                    help="candidate redundancy modes: none,dmr,tmr")
    ap.add_argument("--draws", type=int, default=128,
                    help="Monte Carlo lifetime draws per cell")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serving", action="store_true",
                    help="also run the LLM-serving planner demo")
    ap.add_argument("--embodied-kg", type=float, default=None,
                    help="kg CO2e embodied in one serving chip (needed by "
                         "--serving; a what-if input)")
    ap.add_argument("--power-w", type=float, default=None,
                    help="one serving chip's power in W for --serving "
                         "(default: the card's power limit, nvidia-smi)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.serving and args.embodied_kg is None:
        ap.error("--serving needs --embodied-kg: the repo has no "
                 "life-cycle figure for an H100")
    return args


def main(argv=None):
    """Run the sweep (and with --serving the serving planner) and print
    the tables; returns the SweepResult and the serving check (None
    without --serving)."""
    args = parse_args(argv)
    dev = resolve(args.device)
    dists = tuple(parse_dist(s) for s in args.dist) or (
        LifetimeDist.point(90 * DAY_S, name="point:90d"),
        LifetimeDist.lognormal(YEAR_S, 1.8, name="lognormal:1y:1.8"),
        LifetimeDist.mixture(
            [(LifetimeDist.point(10 * DAY_S), 0.3),
             (LifetimeDist.weibull(3 * YEAR_S, 1.5), 0.7)],
            name="mix:10d@0.3+weibull:3y@0.7"),
    )
    spec = workload_spec(
        tuple(args.workloads.split(",")), dists=dists,
        execs_per_day=[float(f) for f in args.freqs.split(",")],
        intensities=[float(i) for i in args.intensities.split(",")],
        volumes=[float(v) for v in args.volumes.split(",")],
        timing=tuple(args.timing.split(",")),
        fault_rates=[float(f) for f in args.fault_rates.split(",")],
        redundancies=tuple(args.redundancies.split(",")),
        draws=args.draws, seed=args.seed)
    res = run_sweep(spec, device=dev)
    rate = res.scenarios_per_s
    rate_s = f"{rate / 1e6:.2f}M" if rate >= 1e6 else f"{rate / 1e3:.0f}k"
    print(f"[sweep] {res.n_cells} cells x {spec.draws} draws = "
          f"{res.n_scenarios} scenarios in {res.wall_s * 1e3:.1f} ms "
          f"({rate_s} scenarios/s, {res.path} path on {dev.type})")
    share_map(res)
    percentile_table(res)
    frontier_table(res)
    serving_ok = None
    if args.serving:
        chip = planner.h100_sxm(args.embodied_kg, power_w=args.power_w)
        serving_ok = serving_demo(chip, dev)
        if not serving_ok:
            raise SystemExit("[serving] the torch planner differs from "
                             "plan_grid")
    return res, serving_ok


if __name__ == "__main__":
    main()
