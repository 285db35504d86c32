"""How many lanes a warp the segment kernel should step, measured.

`src/repro_torch/kernels/csrc/iss_segment.cu` steps ISS_LANES_PER_WARP
lanes in each warp of its blocks (a compile-time constant; 32 is the
earlier kernel, one lane a thread). This script builds the library once
for each value of LANES below, all `nvcc` runs started together, into
the git-ignored `build/kernels/lanes/`, and runs each build through the
port's own wrapper, `iss_stepper.iss_segment_banked`:

1. phase 3's pool of `chip_smoke.py` (16,384 lanes, lane i on workload
   i % 11, 4,096 steps, timing on), each build timed in rounds with CUDA
   events and its full state bit for bit equal to the 32-lane build's;
2. one-program pools of 2,048 lanes of each workload, the time per step
   of the pool's longest lane, bit for bit equal across builds;
3. the fleet's main path (`chip_smoke.main_plan()`, 90,112 items) under
   torch.profiler, the segment kernel's device time per launch on the
   path's own pools, in the order 32, 8, 16, 8, 32, 16, every item's
   results equal to the first run's.

Run it on a machine with a CUDA card, from the repository's root:

    python3 scripts/segment_lanes.py

It prints the card's name and power limit first; every time is in ms.
"""
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ and tests/ on the path)

LANES = (32, 16, 8, 4)


def build(out_dir):
    """{lanes a warp: loaded library}, every build started together."""
    from repro_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k in LANES:
        so = os.path.join(out_dir, f"libiss_segment_lanes{k}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               f"-DISS_LANES_PER_WARP={k}", "-I", str(_build.CSRC), "-o",
               so, str(_build.CSRC / "iss_segment.cu")]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    so)
    libs = {}
    for k, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {k} lanes a warp:\n{log}")
        lib = ctypes.CDLL(so)
        for sym, argtypes in _build.SIGNATURES["iss_segment"].items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        libs[k] = lib
    return libs


def use(lib):
    """Make the wrapper launch `lib`'s kernel."""
    from repro_torch.kernels import _build
    _build._loaded["iss_segment"] = lib


def segment(bank, clen, mlen, cost, s0, dev):
    """One 4,096-step segment on a copy of s0: (ms, final state)."""
    import torch
    from repro_torch.kernels import iss_stepper as st
    s = cs.clone(s0)
    torch.cuda.synchronize()
    ms = cs.events_ms(lambda: st.iss_segment_banked(
        bank, clen, s, seg_steps=4096, mem_len=mlen, cost=cost, device=dev))
    return ms, s


def mixed_pool(libs, dev, rounds=3):
    bank, clen, mlen, cost, state = cs.pool(16384, 2, dev)
    s0 = state()
    times, want = {k: [] for k in LANES}, None
    for _ in range(rounds):
        for k in LANES:
            use(libs[k])
            ms, s = segment(bank, clen, mlen, cost, s0, dev)
            if want is None:
                want = s
            else:
                cs.max_abs_err(s, want)
            times[k].append(ms)
    cs.log("[mixed pool] 16,384 lanes x 4,096 steps, timing on, bit-exact "
           "across builds: " + "; ".join(
               f"{k} lanes a warp {statistics.median(v):.3f} (runs "
               f"{', '.join(f'{x:.3f}' for x in v)})"
               for k, v in times.items()))


def one_program_pools(libs, dev):
    from repro_torch.flexibench.base import all_workloads
    for w in all_workloads():
        bank, clen, mlen, cost, state = cs.pool(2048, 2, dev, keys=(w.key,))
        s0 = state()
        row, want = [], None
        for k in LANES:
            use(libs[k])
            ms, s = segment(bank, clen, mlen, cost, s0, dev)
            if want is None:
                want = s
                steps = int((s.lanes.n_instr - s0.lanes.n_instr).max())
            else:
                cs.max_abs_err(s, want)
            row.append(f"{k}: {ms:.3f} ({ms / steps * 1e3:.3f} us a step)")
        cs.log(f"[one program] {w.key}, 2,048 lanes, {steps} steps: "
               + "; ".join(row))


def results(rep):
    """Every item's results and the group totals of a run, as bytes."""
    out = []
    for g in rep.groups:
        r = g.result
        for x in (r.n_instr, r.n_two_stage, r.halted, r.out, r.mix,
                  r.n_cycles):
            out.append(None if x is None else x.tobytes())
    return out


def main_path(libs, dev):
    from repro_torch.fleet import run_plan
    plan = cs.main_plan()
    per_launch, want = {}, None
    for k in (32, 8, 16, 8, 32, 16):
        use(libs[k])
        rep, wall, busy, rows = cs.profiled(
            lambda: run_plan(plan, device=dev), cpu=False)
        got = results(rep)
        if want is None:
            want = got
        elif got != want:
            raise AssertionError(f"main path at {k} lanes a warp: results "
                                 f"differ from the first run's")
        hit = [r for r in rows if "iss_segment_kernel" in r.key]
        n = sum(r.count for r in hit)
        ms = sum(r.self_device_time_total for r in hit) / 1e3
        per_launch.setdefault(k, []).append(ms / n)
        cs.log(f"[main path] {k} lanes a warp: {n} launches, {ms:.2f} ms "
               f"device, {ms / n:.4f} a launch; run_packed "
               f"{rep.packed.wall_s:.2f} s, busy share "
               f"{(busy or 0) / wall:.4f}")
    cs.log("[main path] ms a launch, median of the runs: " + "; ".join(
        f"{k} lanes a warp {statistics.median(v):.4f}"
        for k, v in sorted(per_launch.items(), reverse=True)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("segment_lanes: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.nvidia_smi_line()}")
    libs = build(os.path.join(ROOT, "build", "kernels", "lanes"))
    mixed_pool(libs, dev)
    one_program_pools(libs, dev)
    main_path(libs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
