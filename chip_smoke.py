#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: both CUDA kernels from `src/repro_torch/kernels/csrc`, in
   parallel, with the compiler's register and spill report;
3. kernels: `iss_segment_banked` and `iss_refill` against their plain
   PyTorch versions on the card, bit for bit over the full state: first
   on a 256-lane pool of all 11 FlexiBench workloads (timing off and on)
   and random refills, then at the main path's shapes (16,384 lanes,
   2,824 memory words, a bank of 11 programs of up to 2,006 words, one
   4,096-step segment), where each is also timed with CUDA events;
4. small plan: the three-group plan of `examples/fleet_simulation.py` at
   256 items per group through `run_plan` on the card and on the CPU,
   every per-item field and the final state bit for bit;
5. main path: a `FleetPlan` of all 11 workloads, 8,192 items each on
   SERV/QERV/HERV in turn, FlexiLint-static budgets, dynamic timing,
   chunk 16,384, seg_steps 4,096, through `run_plan` on the card, with
   every item halted, every item's output equal to the workload's
   reference function (TT on its first 1,024 items per group: its
   reference is a slow Python loop), and launch counts showing that both
   kernels, and never their plain versions, ran the path;
6. profile: the main path once more under torch.profiler, for the
   device's busy share and its time by kernel.

It ends with a `kernels:` line of launch counts, a JSON line per kernel
(times, bound, launches, error), the card's nvidia-smi line, and as the
last line `{"ok": true, "device": {...}}`. Exact integer state is the
tolerance throughout: every comparison is bit for bit (max_abs_err 0).
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks used for the bounds: HBM bandwidth (NVIDIA's data sheet)
# and the int32 rate outside the tensor cores (132 SMs x 64 int32 lanes
# per SM per clock x 1.98 GHz boost, from the Hopper architecture paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per retired lane-step of rv32e_step.cuh: fetch clamp
# and load address (5), field and immediate decode (40), register reads
# (2), execute and next pc (8), classify (10), commit (5), and the live
# test (2), rounded down
OPS_PER_STEP = 64

SEG = ("iss_segment_banked", "src/repro_torch/kernels/csrc/iss_segment.cu",
       "src/repro/kernels/iss_stepper.py:246")
REF = ("iss_refill", "src/repro_torch/kernels/csrc/iss_refill.cu",
       "src/repro/kernels/iss_stepper.py:418")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every field of two PackedStates (raises if
    any is not zero: the tolerance is bit-exact)."""
    import numpy as np
    err = 0
    for f, x, y in zip(("regs", "pc", "mem", "halted", "n_instr",
                        "n_two_stage", "mix", "n_cycles"), a.lanes, b.lanes):
        d = np.abs(x.cpu().numpy().astype(np.int64)
                   - y.cpu().numpy().astype(np.int64))
        e = int(d.max()) if d.size else 0
        if e:
            raise AssertionError(f"kernel and plain version differ in {f} "
                                 f"(max |diff| {e})")
        err = max(err, e)
    for x, y in ((a.prog_id, b.prog_id), (a.max_steps, b.max_steps)):
        if not bool((x == y).all()):
            raise AssertionError("prog_id/max_steps differ")
    return err


def pool(n_lanes, seed, dev):
    """An n_lanes pool of all 11 workloads (lane i on workload i % 11)
    plus its bank, per-program bounds and dynamic cost rows."""
    import numpy as np
    import torch
    from repro_torch.flexibench.base import all_workloads
    from repro_torch.flexibits.cycles import CORES, cost_row
    from repro_torch.flexibits.iss import PackedState, fresh_lanes, \
        pack_programs
    ws = all_workloads()
    bank, clen = pack_programs([w.program.code for w in ws])
    mlen = np.array([w.total_mem_words for w in ws], np.int32)
    cores = [CORES[c] for c in ("SERV", "QERV", "HERV")]
    cost = np.stack([cost_row(cores[i % 3], dynamic=True)
                     for i in range(len(ws))]).astype(np.int32)
    pids = (np.arange(n_lanes) % len(ws)).astype(np.int32)
    mems = np.zeros((n_lanes, int(mlen.max())), np.int32)
    for i, p in enumerate(pids):
        w = ws[p]
        m = w.initial_memory(w.gen_inputs(np.random.default_rng([seed, i]),
                                          1)[0])
        mems[i, :len(m)] = m
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    ms = np.array([ws[p].max_steps for p in pids], np.int32)

    def state():
        return PackedState(lanes=fresh_lanes(t(mems)), prog_id=t(pids),
                           max_steps=t(ms))
    return t(bank), t(clen), t(mlen), t(cost), state


def clone(ps):
    from repro_torch.flexibits.iss import ISSState, PackedState
    return PackedState(ISSState(*(x.clone() for x in ps.lanes)),
                       ps.prog_id.clone(), ps.max_steps.clone())


def events_ms(fn, reps=1):
    """Mean device time of `reps` calls of fn(), from CUDA events."""
    import torch
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_segment(st, dev, bank, clen, mlen, cost, state, seg_steps,
                  n_segs):
    """Kernel vs plain version, segment after segment (bit for bit)."""
    import torch
    from repro_torch.flexibits import iss
    a, b = state(), state()
    for _ in range(n_segs):
        a = st.iss_segment_banked(bank, clen, a, seg_steps=seg_steps,
                                  mem_len=mlen, cost=cost, device=dev)
        b = iss.run_segment_lanes_banked(bank, clen, b, seg_steps, None,
                                         mlen, cost)
        torch.cuda.synchronize()
        max_abs_err(a, b)
    return int(a.lanes.n_instr.sum())


def phase_kernels(dev, rec):
    import numpy as np
    import torch
    from repro_torch.flexibits import iss
    from repro_torch.kernels import iss_stepper as st

    # ---- small pool: all 11 workloads, timing off and on
    bank, clen, mlen, cost, state = pool(256, 1, dev)
    for timing in (False, True):
        n = check_segment(st, dev, bank, clen, mlen,
                          cost if timing else None, state, 256, 3)
        log(f"[kernels] iss_segment_banked 256 lanes x 3 x 256 steps, "
            f"timing {'on' if timing else 'off'}: bit-exact "
            f"({n} instructions retired)")
    rng = np.random.default_rng(0)

    def refill_case(n_lanes, mem_words, n_staged, seed):
        r = np.random.default_rng(seed)
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        from repro_torch.flexibits.iss import ISSState, PackedState
        ps = PackedState(
            ISSState(regs=t(r.integers(-9, 9, (n_lanes, 16), np.int32)),
                     pc=t(r.integers(0, 64, n_lanes, np.int32)),
                     mem=t(r.integers(-99, 99, (n_lanes, mem_words),
                                      np.int32)),
                     halted=t(r.random(n_lanes) < 0.5),
                     n_instr=t(r.integers(0, 50, n_lanes, np.int32)),
                     n_two_stage=t(r.integers(0, 20, n_lanes, np.int32)),
                     mix=t(r.integers(0, 9, (n_lanes, 8), np.int32)),
                     n_cycles=t(r.integers(0, 999, n_lanes, np.int32))),
            t(r.integers(0, 11, n_lanes, np.int32)),
            t(r.integers(1, 99, n_lanes, np.int32)))
        free = t(r.random(n_lanes) < 0.6)
        take, src = iss.refill_take(
            free, torch.tensor([n_staged], dtype=torch.int32, device=dev))
        staged = (t(r.integers(-99, 99, (n_lanes, mem_words), np.int32)),
                  t(r.integers(0, 11, n_lanes, np.int32)),
                  t(r.integers(1, 99, n_lanes, np.int32)))
        return ps, take, src, staged

    ps, take, src, staged = refill_case(256, 2824, 100, 1)
    want = iss.refill_lanes(ps, take, src, *staged)
    got = st.iss_refill(clone(ps), take, src, *staged, device=dev)
    torch.cuda.synchronize()
    max_abs_err(got, want)
    log("[kernels] iss_refill 256 lanes, random take/src: bit-exact")

    # ---- the main path's shapes: 16,384 lanes x 2,824 words, 11 programs
    L, SEGSTEPS = 16384, 4096
    t0 = time.perf_counter()
    bank, clen, mlen, cost, state = pool(L, 2, dev)
    log(f"[kernels] full-shape pool built in "
        f"{time.perf_counter() - t0:.1f}s: lanes {L}, mem words "
        f"{state().lanes.mem.shape[1]}, bank {tuple(bank.shape)}")
    s0 = state()
    plain = [None]

    def run_plain():
        plain[0] = iss.run_segment_lanes_banked(bank, clen, clone(s0),
                                                SEGSTEPS, None, mlen, cost)
    plain_ms = events_ms(run_plain)
    times = []
    for _ in range(3):
        s = clone(s0)
        torch.cuda.synchronize()
        times.append(events_ms(lambda: st.iss_segment_banked(
            bank, clen, s, seg_steps=SEGSTEPS, mem_len=mlen, cost=cost,
            device=dev)))
        err = max_abs_err(s, plain[0])
    steps = int((plain[0].lanes.n_instr - s0.lanes.n_instr).sum())
    nbytes = 2 * sum(x.numel() * x.element_size() for x in s0.lanes) + sum(
        x.numel() * x.element_size()
        for x in (s0.prog_id, s0.max_steps, bank, clen, mlen, cost))
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = steps * OPS_PER_STEP / INT32_OPS_PER_S * 1e3
    rec["iss_segment_banked"] = dict(
        ms=sorted(times)[1], plain_ms=plain_ms, max_abs_err=err,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        detail=f"{steps} lane-steps, {nbytes} bytes")
    log(f"[kernels] iss_segment_banked {L} lanes x {SEGSTEPS} steps "
        f"(timing on): bit-exact; kernel {sorted(times)[1]:.3f} ms "
        f"(runs {', '.join(f'{x:.3f}' for x in times)}), plain "
        f"{plain_ms:.1f} ms; {steps} retired lane-steps; bound "
        f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f}, "
        f"operations {b_ops:.4f})")

    ps, take, src, staged = refill_case(L, 2824, L // 2, 3)
    want = iss.refill_lanes(ps, take, src, *staged)
    got = clone(ps)
    st.iss_refill(got, take, src, *staged, device=dev)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    # the swap is idempotent for a fixed take/src: time repeated launches
    ms = events_ms(lambda: st.iss_refill(got, take, src, *staged,
                                         device=dev), reps=20)
    plain_ms = events_ms(lambda: iss.refill_lanes(ps, take, src, *staged),
                         reps=5)
    n_take = int(take.sum())
    lane_row = 4 * (2824 + 16 + 8 + 6)          # mem, regs, mix, scalars
    nbytes = L * (1 + 4) + n_take * (4 * 2824 + 8) + n_take * lane_row
    rec["iss_refill"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             bound_by="bytes",
                             detail=f"{n_take} lanes take, {nbytes} bytes")
    log(f"[kernels] iss_refill {L} lanes, {n_take} take: bit-exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rec['iss_refill']['bound_ms']:.4f} ms")


def three_group_plan(n_items):
    from repro_torch.fleet import FleetGroup, FleetPlan
    return FleetPlan(groups=(
        FleetGroup(workload="MC", core="SERV", n_items=n_items, seed=0),
        FleetGroup(workload="WQ", core="QERV", n_items=n_items, seed=1),
        FleetGroup(workload="SI", core="HERV", n_items=n_items, seed=2),
    ), chunk=128, seg_steps=1024)


def phase_small_plan(dev):
    import numpy as np
    import torch
    from repro_torch.fleet import run_plan
    plan = three_group_plan(256)
    t0 = time.perf_counter()
    gpu = run_plan(plan, keep_state=True, device=dev)
    t1 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # small tensors: one thread is fastest
    try:
        cpu = run_plan(plan, keep_state=True, device="cpu", power_w=0.0)
    finally:
        torch.set_num_threads(threads)
    t2 = time.perf_counter()
    fields = ("n_instr", "n_two_stage", "halted", "out", "mix", "mems",
              "regs", "pc", "mix_items")
    for a, b in zip(gpu.groups, cpu.groups):
        for f in fields:
            if not np.array_equal(getattr(a.result, f),
                                  getattr(b.result, f)):
                raise AssertionError(f"small plan: card and CPU differ in "
                                     f"{a.workload.key}.{f}")
        if a.total_kg != b.total_kg:
            raise AssertionError("small plan: carbon differs")
    for f in ("lane_steps", "n_segments", "seg_schedule"):
        if getattr(gpu.packed, f) != getattr(cpu.packed, f):
            raise AssertionError(f"small plan: schedule differs in {f}")
    log(f"[small plan] 3 groups x 256 items: card {t1 - t0:.2f}s, CPU "
        f"{t2 - t1:.2f}s; every per-item field, final state and the "
        f"schedule bit-exact")


def main_plan():
    from repro_torch.flexibench.base import all_workloads
    from repro_torch.fleet import FleetGroup, FleetPlan
    cores = ("SERV", "QERV", "HERV")
    return FleetPlan(groups=tuple(
        FleetGroup(workload=w.key, core=cores[i % 3], n_items=8192, seed=i,
                   max_steps="static")
        for i, w in enumerate(all_workloads())),
        chunk=16384, seg_steps=4096, timing="dynamic")


def phase_main(dev):
    import numpy as np
    from repro_torch.fleet import run_plan
    from repro_torch.fleet.engine import workload_source
    from repro_torch.kernels import iss_stepper as st
    plan = main_plan()
    st.reset_counts()
    rep = run_plan(plan, device=dev)
    counts = {"iss_segment_banked": st.iss_segment_banked.launches,
              "iss_refill": st.iss_refill.launches}
    plain = st.iss_segment_banked.plain_calls + st.iss_refill.plain_calls
    p = rep.packed
    if min(counts.values()) <= 0 or plain:
        raise AssertionError(f"main path launches {counts}, plain calls "
                             f"{plain}")
    n_instr = sum(int(g.result.n_instr.sum()) for g in rep.groups)
    log(f"[main] {rep.n_items} items in {p.wall_s:.2f}s wall: "
        f"{rep.n_items / p.wall_s:.1f} items/s, "
        f"{n_instr / p.wall_s:.4g} retired instructions/s, "
        f"{p.lane_steps} lane-step slots, {p.n_segments} segments, "
        f"{p.host_syncs} blocking host syncs, device busy share "
        f"{p.device_busy_frac:.4f} (engine estimate)")
    for g, grp in zip(rep.groups, plan.groups):
        r = g.result
        if not r.halted.all():
            raise AssertionError(f"{grp.workload}: "
                                 f"{int((~r.halted).sum())} items never "
                                 f"halted")
        w = g.workload
        n_chk = 1024 if w.key == "TT" else r.n_items
        mems = workload_source(w, grp.seed)(0, n_chk)
        want = np.asarray(w.ref(mems[:, :w.n_inputs]), np.int32)
        bad = int((r.out[:n_chk] != want).sum())
        if bad:
            raise AssertionError(f"{w.key}: {bad} of {n_chk} outputs differ "
                                 f"from the workload's reference")
        log(f"[main] {w.key} on {grp.core}: {r.n_items} items halted, "
            f"{n_chk} outputs equal to the reference, mean "
            f"{r.n_instr.mean():.1f} instructions")
    log(rep.format())
    return counts


def phase_profile(dev):
    """The main path once more under torch.profiler: the device's busy
    share (union of its activity intervals over the run's wall clock)
    and device time by kernel. Runs after the launch counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fleet import run_plan
    plan = main_plan()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = run_plan(plan, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:              # union of device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        log("[profile] the profiler saw no device activity: device busy "
            "share not measured")
        return
    log(f"[profile] main path under torch.profiler: {wall:.2f}s wall "
        f"({rep.packed.wall_s:.2f}s inside run_packed), device busy "
        f"{busy / 1e6:.3f}s = share {busy / 1e6 / wall:.4f} of the wall")
    rows = sorted(prof.key_averages(),
                  key=lambda r: r.self_device_time_total, reverse=True)
    for r in rows[:10]:
        if r.self_device_time_total <= 0:
            break
        log(f"[profile] {r.self_device_time_total / 1e3:10.2f} ms device "
            f"{r.count:6d} calls  {r.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    for n in secs:
        for line in _build.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {n}: {line.strip()}")

    rec = {}
    t0 = time.perf_counter()
    phase_kernels(dev, rec)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_plan(dev)
    log(f"[small plan] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts = phase_main(dev)
    log(f"[main] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_profile(dev)
    log(f"[profile] phase {time.perf_counter() - t0:.1f}s")

    log("kernels: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    out = []
    for name_, src, replaces in (SEG, REF):
        r = rec[name_]
        out.append({"name": name_, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name_],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": out}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
