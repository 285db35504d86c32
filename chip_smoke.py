#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA library from `src/repro_torch/kernels/csrc`, in
   parallel, with ptxas's registers, static shared memory and spills
   for each kernel;
3. kernels: `iss_segment_banked` and `iss_refill` against their plain
   PyTorch versions on the card, bit for bit over the full state: first
   on a 256-lane pool of all 11 FlexiBench workloads (timing off and on)
   and random refills, then at the main path's shapes (16,384 lanes,
   2,824 memory words, a bank of 11 programs of up to 2,006 words, one
   4,096-step segment), where each is also timed with CUDA events, the
   segment kernel beside its earlier time;
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
   device's busy share, its time by kernel, and the segment kernel's
   device time per launch on the path's own pool;
7. sweep kernel, both builds against their plain PyTorch versions on the
   card: (a) `sweep_tile`, lifetimes read from memory, on three streamed
   tiles of 12 cells x 8 draws x 3 candidates (+inf lifetimes, invalid
   cells, exact ties); (b) `sweep_tile_drawn`, lifetimes drawn in the
   kernel, on three streamed tiles of 12 cells x 40 draws, its lifetimes
   within the CPU tests' ulp bound of the plain draws and every output
   equal to the plain tile given them; each in float32 and float64, then
   at the sweep's main tile (1,024 cells x 4,096 draws x 9 candidates,
   float32), timed with CUDA events against its bound;
8. small sweep: the reference test's mixture spec on the card and on the
   CPU (the CPU fed the card kernel's own lifetimes), at four tile sizes
   on the card, and the float64 point-mass spec against
   `total_grid`/`selection_map`;
9. main sweep: all 11 workloads x 4 lifetime distributions x 5
   frequencies x 4 intensities x 3 volumes x 3 timing models x 2 fault
   rates (15,840 cells) x 4,096 draws, argmin over 3 cores x 3
   redundancy modes, through `run_sweep` on the card in float32, with
   launch counts showing that the drawn kernel ran every tile and that
   neither plain version, build (a) nor the eager draws ran, every field
   bit-identical on a rerun and at a second tile size, and once more
   under torch.profiler;
10. fault kernel: the `faults` variant of `iss_segment_banked` against
   its plain version, full state bit for bit, on a 256-lane pool of 3
   programs (two 256-step segments, timing off and on) under transients
   on regs, mem and pc at rate 1e-2 and at rate 1.0, stuck-at at 0.5 and
   dead lanes at 0.5, plus the one-program `iss_segment` wrapper; then at
   the main path's shapes (16,384 lanes, 4,096 steps, timing on) timed
   with CUDA events with faults off and with transients at 1e-5, beside
   the earlier kernel's times;
11. small resilient plans: the three groups of phase 4 (64 items each,
   FlexiLint-static budgets) with transients at 1e-4, unprotected and
   under DMR, on the card and on the CPU: every per-item field, the DMR
   counters and the schedule bit for bit;
12. resilient main path: phase 5's plan three ways, (a) transients on
   regs, mem and pc at 1e-5 unprotected (the items whose output,
   retirement count or halt differ from phase 5's are counted), (b) the
   same under DMR with max_retries 6 and (c) dead lanes at 1e-3 under DMR
   with max_retries 1, where every item's output, retirement count and
   halt must equal phase 5's (the tallies DMR's digest does not cover,
   the two-stage count, ticks and mix, are counted); each run once more
   under torch.profiler for the busy share and the segment kernel's
   device time per launch, and the DMR boundary's digest, snapshot and
   rollback timed at full shape;
13. LM kernels: the count of tensor-core instructions (HMMA, HGMMA) in
   each LM kernel's SASS where the toolkit has `cuobjdump` (the
   bfloat16 flash kernel, the bfloat16 scan kernel and the bit planes'
   GEMM must have some);
   `flash_attention`, `ssd_scan` and `bitplane_matmul` against their
   plain versions in float32 and bfloat16 on small and ragged shapes (L
   11 and 200 causal and full with equal and unequal tiles, D 40
   zero-padded; SSD scans of two and three chunks with odd head counts
   and groups, P = N = 128 and a 512-step chunk; bit planes at 1, 4
   and 8 bits, ragged M through
   `quantized_linear`, M 384 x K 640 x N 384 against the GEMM's block
   tile, and the bfloat16 repack bit for bit at 1-8 bits), then at the
   main serve's shapes in bfloat16, timed with CUDA events beside the
   plain version and a library call (SDPA for attention, `torch.matmul`
   on the dequantised weight for bit planes, none for the scan), the bit
   planes' repack and GEMM also timed alone;
14. small serve: the Zamba2 smoke config in float32 and bfloat16 with
   the same parameters on the card (kernels) and on the CPU (plain
   versions): prefill and first decode logits within the stated
   tolerance, greedy tokens equal wherever the CPU's top-2 margin clears
   twice it, and `generate` equal to the greedy loop on both;
15. main serve: Zamba2-7B at full width and depth (6.957e9 parameters,
   bfloat16, random from a seed) through `generate` on the card, 8
   requests x prompt 512, 32 tokens: 81 `ssd_scan` and 13
   `flash_attention` launches per prefill and no plain call; prefill
   and decode rates and peak memory; the kernels against their plain
   versions on the tensors this prefill feeds the first Mamba layer and
   the first shared block, and the scan timed on the first Mamba layer's
   own tensors; that block's FFN input through `quantized_linear` at 4
   and 8 bits (the bit-plane kernel's path); and the serve once more
   under torch.profiler;
16. host loop: phase 4's plan through `refill="host"` and through
   `packed=False` on the card, every per-item field and the final state
   equal to phase 4's resident run, and its MC and WQ groups the same on
   the card and the CPU, bit for bit (SI's 7,715 steps would cost the
   CPU's plain stepper ~40 s a run); phase 5's plan through
   `refill="host"`: every per-item field equal to phase 5's, more host
   syncs than phase 5's, its wall and items/s; then TT, PT, CT and AD at
   28,000 items each on SERV with FlexiLint-static budgets, past the
   int32 mix bound, which must fall back to the host loop
   (`refill == "host"`) with every item halted and every output equal to
   the workload's reference (TT on its first 1,024 items); each run with
   the launch counts zeroed just before it: segment kernel launched, no
   plain version, and no refill kernel on the host loop;
17. checkpoints: phase 5's plan checkpointed every 8 segments into
   `build/chip_smoke_ckpt/` (removed after), crashed by
   `_crash_after_segments=20` and resumed through `run_plan`: every
   per-item field, `n_segments` and the schedule equal to phase 5's (a
   resume stages the unconsumed items again, so `lane_steps` may
   differ); each save's write time and bytes on disk, the restore's
   time and the resumed wall; then a 64-item stream checkpointed and
   crashed on the card resumes on the CPU, and the other way round, bit
   for bit with the card's uninterrupted run.

It ends with a `kernels:` line of launch counts, one JSON line
`{"kernels": [...]}` with an entry per kernel (times, bound, launches,
error; the segment kernel's faults variant has its own entry, launched
on phase 12's path; the sweep kernel's two builds each have one, the
drawn build launched on phase 9's path and build (a) on none; the
bit-plane kernel's launches are phase 15's quantized path), the card's nvidia-smi line, and as the last line
`{"ok": true, "device": {...}}`. The fleet kernels' integer state is
held bit for bit (max_abs_err 0). The sweep is held bit for bit but for
its per-cell sums, which follow no fixed order (relative 2 (N - 1) u),
and for values at a log10 bin edge (counted; see
`tests/_torch_parity.py`); its max_abs_err is over the exact fields.
The LM kernels sum in another order than their plain versions (the
bfloat16 flash kernel also rounds P to bfloat16 for P v, the bfloat16
scan W, S and B w) and are held to `LM_TOL` times the output's largest
magnitude.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))  # _torch_parity (no JAX)

# H100 SXM peaks used for the bounds: HBM bandwidth (NVIDIA's data sheet)
# and the int32 rate outside the tensor cores (132 SMs x 64 int32 lanes
# per SM per clock x 1.98 GHz boost, from the Hopper architecture paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 rate outside the tensor cores (NVIDIA's data sheet, H100 SXM)
FP32_OPS_PER_S = 67e12
# int32 operations per retired lane-step of rv32e_step.cuh: fetch clamp
# and load address (5), field and immediate decode (40), register reads
# (2), execute and next pc (8), classify (10), commit (5), and the live
# test (2), rounded down
OPS_PER_STEP = 64
# added per live step by flexifault.cuh's transient mode: the halt test
# (1), k ^ n_instr (1), mix32 (2 shifts, 3 xors, 2 multiplies) and the
# threshold compare (1); a step that fires adds two more mix32 and the
# flip (about 25), counted per fire
FAULT_OPS_PER_STEP = 10
FAULT_OPS_PER_FIRE = 25
# int32 operations of one threefry2x32 hash in sweep_draws.cuh: 20 rounds
# of an add, a funnel shift and a xor (60), 5 key injections of three adds
# (15), the first key add (2) and the conversion to a float (xor, shift,
# or, subtract: 4)
OPS_PER_HASH = 81

SEG = ("iss_segment_banked", "src/repro_torch/kernels/csrc/iss_segment.cu",
       "src/repro/kernels/iss_stepper.py:246")
REF = ("iss_refill", "src/repro_torch/kernels/csrc/iss_refill.cu",
       "src/repro/kernels/iss_stepper.py:418")
SWEEP = ("carbon_sweep", "src/repro_torch/kernels/csrc/carbon_sweep.cu",
         "src/repro/kernels/carbon_sweep.py:408")
SWEEP_DRAWN = ("carbon_sweep[drawn]",
               "src/repro_torch/kernels/csrc/carbon_sweep.cu",
               "src/repro/kernels/carbon_sweep.py:408")
SEG_FAULTS = ("iss_segment_banked[faults]",
              "src/repro_torch/kernels/csrc/iss_segment.cu",
              "src/repro/kernels/iss_stepper.py:152")
# the segment kernel's times at phase 3's and phase 10's full shape before
# its redesign (measured on one NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_SEG_MS = {"fault-free": 3.366, "faults": 3.635}


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


def pool(n_lanes, seed, dev, keys=None):
    """An n_lanes pool of all 11 workloads, or of those named by `keys`
    (lane i on workload i % n), plus its bank, per-program bounds and
    dynamic cost rows."""
    import numpy as np
    import torch
    from repro_torch.flexibench.base import all_workloads
    from repro_torch.flexibits.cycles import CORES, cost_row
    from repro_torch.flexibits.iss import PackedState, fresh_lanes, \
        pack_programs
    ws = all_workloads()
    if keys is not None:
        ws = [w for w in ws if w.key in keys]
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
                  n_segs, faults=None, epoch=None):
    """Kernel vs plain version, segment after segment (bit for bit),
    with `faults` the faults variant under per-lane `epoch`s. Returns the
    retired instructions and the kernel's final state."""
    import torch
    from repro_torch.flexibits import faults as pf
    from repro_torch.flexibits import iss
    a, b = state(), state()
    fk = {} if faults is None else dict(
        faults=faults, epoch=epoch,
        lane_key=pf.lane_keys_tensor(faults.seed, a.lanes.pc.shape[0], dev))
    for _ in range(n_segs):
        a = st.iss_segment_banked(bank, clen, a, seg_steps=seg_steps,
                                  mem_len=mlen, cost=cost, device=dev, **fk)
        b = iss.run_segment_lanes_banked(bank, clen, b, seg_steps, None,
                                         mlen, cost, **fk)
        torch.cuda.synchronize()
        max_abs_err(a, b)
    return int(a.lanes.n_instr.sum()), a


def phase_kernels(dev, rec):
    import numpy as np
    import torch
    from repro_torch.flexibits import iss
    from repro_torch.kernels import iss_stepper as st

    # ---- small pool: all 11 workloads, timing off and on
    bank, clen, mlen, cost, state = pool(256, 1, dev)
    for timing in (False, True):
        n, _ = check_segment(st, dev, bank, clen, mlen,
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
        f"(earlier kernel: {EARLIER_SEG_MS['fault-free']} ms) "
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
    return gpu


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
    return counts, rep


def profiled(fn, cpu=True):
    """Run fn() under torch.profiler: (its result, wall seconds, device
    busy seconds (the union of the device's activity intervals), rows of
    key_averages by device time), or busy None when the profiler saw no
    device activity. `cpu=False` records the device's activity only (a
    run of many small launches makes the host's events slow to read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
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
    rows = sorted(prof.key_averages(),
                  key=lambda r: r.self_device_time_total, reverse=True)
    return out, wall, (busy / 1e6 if spans else None), rows


def log_rows(tag, rows, n=10):
    for r in rows[:n]:
        if r.self_device_time_total <= 0:
            break
        log(f"[{tag}] {r.self_device_time_total / 1e3:10.2f} ms device "
            f"{r.count:6d} calls  {r.key[:90]}")


def log_per_launch(tag, rows):
    """The segment kernel's device time per launch from torch.profiler's
    rows (the run's own pool and segments)."""
    hit = [r for r in rows if "iss_segment_kernel" in r.key
           and not r.key.startswith("aten::")]
    n = sum(r.count for r in hit)
    ms = sum(r.self_device_time_total for r in hit) / 1e3
    if n:
        log(f"[{tag}] iss_segment_banked: {ms:.2f} ms device in {n} "
            f"launches = {ms / n:.4f} ms a launch (torch.profiler)")


def phase_profile(dev):
    """The main path once more under torch.profiler: the device's busy
    share (union of its activity intervals over the run's wall clock)
    and device time by kernel. Runs after the launch counts were read."""
    from repro_torch.fleet import run_plan
    plan = main_plan()
    rep, wall, busy, rows = profiled(lambda: run_plan(plan, device=dev))
    if busy is None:
        log("[profile] the profiler saw no device activity: device busy "
            "share not measured")
        return
    log(f"[profile] main path under torch.profiler: {wall:.2f}s wall "
        f"({rep.packed.wall_s:.2f}s inside run_packed), device busy "
        f"{busy:.3f}s = share {busy / wall:.4f} of the wall")
    log_rows("profile", rows)
    log_per_launch("profile", rows)


def queued_ms(fn, reps):
    """Device time of `reps` back-to-back calls, from CUDA events; a sleep
    queued first lets the host enqueue them all before the device reaches
    the first, so host overhead stays out."""
    import torch
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def exact_err(want, got):
    """Largest |a - b| over the sweep fields held exactly (numpy TileOut
    and accumulators of one tile; equal infinities count as 0, and a
    value at a bin edge would show here)."""
    import numpy as np
    (w_out, w_acc), (g_out, g_acc) = want, got
    err = 0.0
    pairs = [(getattr(w_out, f), getattr(g_out, f))
             for f in ("best_total", "best_core", "counts", "min_best",
                       "max_best")] + list(zip(w_acc, g_acc))
    for a, b in pairs:
        a, b = a.astype(np.float64), b.astype(np.float64)
        with np.errstate(invalid="ignore"):         # inf - inf, masked
            d = np.where(a == b, 0.0, np.abs(a - b))
        err = max(err, float(d.max()) if d.size else 0.0)
    return err


def sweep_bound(nbytes, n_ops, ops_per_s):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms)."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = n_ops / ops_per_s * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", b_bytes, b_ops)


def phase_sweep_kernel(dev, rec):
    """Both builds of the sweep kernel against their plain versions: small
    streamed tiles in float32 and float64, then the main path's tile,
    timed against its bound."""
    import numpy as np
    import torch
    import _torch_parity as tp
    from repro_torch import convert
    from repro_torch.kernels import carbon_sweep as cs

    worst = 0.0
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        cases = tp.stream_cases(np.random.default_rng(7), dtype)
        got = tp.port_stream(cases, dtype, dev)
        torch.cuda.synchronize()
        want = tp.port_stream(cases, dtype, dev, fn=cs.sweep_tile_plain)
        w = tp.assert_streams_equal(cases, want, got, dtype, name)
        worst = max(worst, w)
        log(f"[sweep kernel] (a) 3 streamed tiles of 12 cells x 8 draws x "
            f"3-4 candidates, {name}: equal to the plain version (largest "
            f"relative sum difference {w:.3g})")
        cases = tp.drawn_stream_cases(np.random.default_rng(9), dtype,
                                      n_draws=40)
        outs, accs, lifes = tp.port_stream_drawn(cases, dtype, dev)
        torch.cuda.synchronize()
        _, _, plain = tp.port_stream_drawn(cases, dtype, dev,
                                           fn=cs.sweep_tile_drawn_plain)
        ulps = max(int(tp.ulps(a, b).max()) for a, b in zip(plain, lifes))
        if ulps > tp.LIFE_ULPS[dtype]:
            raise AssertionError(f"drawn {name}: lifetimes {ulps} ulps from "
                                 f"the plain draws")
        fed = tp.with_lifetimes(cases, lifes)
        want = tp.port_stream(fed, dtype, dev, fn=cs.sweep_tile_plain)
        w = tp.assert_streams_equal(fed, want, (outs, accs), dtype, name)
        worst = max(worst, w)
        log(f"[sweep kernel] (b) 3 streamed drawn tiles of 12 cells x 40 "
            f"draws x 3-4 candidates, {name}: lifetimes within {ulps} ulps "
            f"of the plain draws; given them, equal to the plain tile "
            f"(largest relative sum difference {w:.3g})")

    # the main path's tile: 1,024 cells x 4,096 draws x 9 candidates
    TC, N, C = 1024, 4096, 9
    np_out = lambda o: cs.TileOut(*(x.cpu().numpy() for x in o))  # noqa
    fresh = lambda: cs.init_acc(64, 32, torch.float32, dev)  # noqa: E731
    sum_tol = 2 * (N - 1) * 2.0 ** -24

    # build (a): lifetimes read from device memory
    case = tp.tile_inputs(np.random.default_rng(8), TC, N, C, np.float32,
                          inf_cells=2, invalid_frac=0.05)
    args = [torch.from_numpy(case[k]).to(dev) for k in tp.TILE_ORDER]
    out, acc = cs.sweep_tile(*args, fresh(), device=dev, **tp.TILE_KW)
    torch.cuda.synchronize()
    pout, pacc = cs.sweep_tile_plain(*args, fresh(), **tp.TILE_KW)
    want = ([np_out(pout)], [convert.sweep_acc_to_numpy(pacc)])
    got = ([np_out(out)], [convert.sweep_acc_to_numpy(acc)])
    w = tp.assert_streams_equal([case], want, got, np.float32, "main tile")
    worst = max(worst, w)
    err = exact_err((want[0][0], want[1][0]), (got[0][0], got[1][0]))
    acc_t = fresh()
    times = [queued_ms(lambda: cs.sweep_tile(*args, acc_t, device=dev,
                                             **tp.TILE_KW), 10)
             for _ in range(3)]
    plain = [queued_ms(lambda: cs.sweep_tile_plain(*args, fresh(),
                                                   **tp.TILE_KW), 1)
             for _ in range(3)]
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 2 * sum(t.numel() * t.element_size() for t in acc) \
        + sum(t.numel() * t.element_size() for t in out)
    n_ops = 4 * TC * N * C          # 2 mul, 1 add, 1 compare per candidate
    bound, by, b_bytes, b_ops = sweep_bound(nbytes, n_ops, FP32_OPS_PER_S)
    ms, plain_ms = sorted(times)[1], sorted(plain)[1]
    rec[SWEEP[0]] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         bound_ms=bound, bound_by=by)
    log(f"[sweep kernel] (a) main tile {TC} cells x {N} draws x {C} "
        f"candidates float32: equal to the plain version (largest relative "
        f"sum difference {w:.3g}, bound {sum_tol:.3g}); kernel {ms:.4f} ms "
        f"(runs {', '.join(f'{x:.4f}' for x in times)}), plain "
        f"{plain_ms:.2f} ms; bound {bound:.4f} ms (bytes {nbytes} -> "
        f"{b_bytes:.4f}, operations {n_ops} -> {b_ops:.4f})")

    # build (b): lifetimes drawn in the kernel, as the sweep runs it
    case = tp.drawn_tile_inputs(np.random.default_rng(10), TC, N, C,
                                np.float32, invalid_frac=0.05)
    args = [torch.from_numpy(case[k]).to(dev) for k in tp.DRAWN_ORDER]
    kw = dict(tp.TILE_KW, n_draws=N, day_s=tp.DAY_S)
    key = case["key"]
    life = torch.empty((TC, N), dtype=torch.float32, device=dev)
    out, acc = cs.sweep_tile_drawn(key, *args, fresh(), life_out=life,
                                   device=dev, **kw)
    torch.cuda.synchronize()
    plife = torch.empty_like(life)
    cs.sweep_tile_drawn_plain(key, *args, fresh(), life_out=plife, **kw)
    ulps = tp.ulps(plife.cpu().numpy(), life.cpu().numpy())
    if ulps.max() > tp.LIFE_ULPS[np.float32]:
        raise AssertionError(f"drawn main tile: lifetimes {ulps.max()} ulps "
                             f"from the plain draws")
    fed = tp.with_lifetimes([case], [life.cpu().numpy()])
    fargs = [torch.from_numpy(fed[0][k]).to(dev) for k in tp.TILE_ORDER]
    pout, pacc = cs.sweep_tile_plain(*fargs, fresh(), **tp.TILE_KW)
    want = ([np_out(pout)], [convert.sweep_acc_to_numpy(pacc)])
    got = ([np_out(out)], [convert.sweep_acc_to_numpy(acc)])
    w = tp.assert_streams_equal(fed, want, got, np.float32, "drawn tile")
    worst = max(worst, w)
    err = exact_err((want[0][0], want[1][0]), (got[0][0], got[1][0]))
    acc_t = fresh()
    times = [queued_ms(lambda: cs.sweep_tile_drawn(
        key, *args, acc_t, best_core=False, device=dev, **kw), 10)
        for _ in range(3)]
    plain = [queued_ms(lambda: cs.sweep_tile_drawn_plain(
        key, *args, fresh(), **kw), 1) for _ in range(3)]
    out_t, _ = cs.sweep_tile_drawn(key, *args, acc_t, best_core=False,
                                   device=dev, **kw)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 2 * sum(t.numel() * t.element_size() for t in acc) \
        + sum(t.numel() * t.element_size() for t in out_t if t is not None)
    n_ops = OPS_PER_HASH * (2 * TC * N + TC)   # two uniforms a draw, fold_in
    bound, by, b_bytes, b_ops = sweep_bound(nbytes, n_ops, INT32_OPS_PER_S)
    ms, plain_ms = sorted(times)[1], sorted(plain)[1]
    rec[SWEEP_DRAWN[0]] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                               bound_ms=bound, bound_by=by)
    log(f"[sweep kernel] (b) main drawn tile {TC} cells x {N} draws x {C} "
        f"candidates float32: lifetimes within {ulps.max()} ulps of the "
        f"plain draws ({int((ulps > 0).sum())} of {ulps.size} differ); "
        f"given them, equal to the plain tile (largest relative sum "
        f"difference {w:.3g}); kernel without best_core {ms:.4f} ms (runs "
        f"{', '.join(f'{x:.4f}' for x in times)}), plain {plain_ms:.2f} ms; "
        f"bound {bound:.4f} ms (bytes {nbytes} -> {b_bytes:.4f}, int32 "
        f"operations {n_ops} -> {b_ops:.4f})")
    log(f"[sweep kernel] largest relative sum difference seen: {worst:.3g}")


def phase_small_sweep(dev):
    """The reference test's mixture spec on card and CPU; tile sizes on the
    card; the float64 point-mass spec against the numpy oracles."""
    import numpy as np
    import _torch_parity as tp
    from repro_torch.core import selection as sel
    from repro_torch.core import sweep as sw

    spec = tp.sweep_mixture_spec()
    card, best, emb = tp.run_sweep_recorded(spec, tile_cells=48,
                                            device=dev)
    life_card = tp.sweep_life_days(spec, np.float32, dev, spec.n_cells)
    life_cpu = tp.sweep_life_days(spec, np.float32, "cpu", spec.n_cells)
    ulps = tp.ulps(life_card, life_cpu)
    if ulps.max() > tp.LIFE_ULPS[np.float32]:
        raise AssertionError(f"card and CPU lifetimes differ by "
                             f"{ulps.max()} ulps")
    cpu, _, _ = tp.run_sweep_recorded(spec, life_days=life_card,
                                      tile_cells=48, device="cpu")
    w = tp.assert_sweeps_equal(cpu, card, sw.build_tables(spec), best, emb,
                               "mixture card vs CPU")
    if card.frontier() != cpu.frontier():
        raise AssertionError("mixture: frontier rows differ")
    log(f"[small sweep] mixture spec ({spec.n_cells} cells x {spec.draws} "
        f"draws): the card kernel's lifetimes vs the CPU's within "
        f"{ulps.max()} ulps "
        f"({int((ulps > 0).sum())} of {ulps.size} differ); CPU fed the "
        f"card's lifetimes equals the card's sweep (means within relative "
        f"{w:.3g}), frontier rows equal")
    runs = [sw.run_sweep(spec, tile_cells=t, device=dev)
            for t in (3, 7, 48, spec.n_cells)]
    for r in runs[1:]:
        tp.assert_sweeps_identical(runs[0], r, "tile sizes")
    log("[small sweep] tile sizes 3, 7, 48, all on the card: bit-identical")
    spec, lifes = tp.sweep_point_spec()
    res = sw.run_sweep(spec, tile_cells=5, dtype=np.float64, device=dev)
    tg = sel.total_grid(list(spec.cores), spec.profiles[0],
                        np.asarray(lifes), np.asarray(spec.execs_per_day))
    smap = sel.selection_map(spec.profiles[0], np.asarray(lifes),
                             np.asarray(spec.execs_per_day))
    sq = np.s_[:, :, 0, 0, 0, 0, 0]
    for f in ("p50", "min", "max"):
        if not np.array_equal(getattr(res, f)[sq], tg.min(axis=0)):
            raise AssertionError(f"point mass f64: {f} != total_grid min")
    if not np.array_equal(res.best_core[sq], smap):
        raise AssertionError("point mass f64: best_core != selection_map")
    log("[small sweep] float64 point-mass spec on the card: min, p50, max "
        "equal total_grid(...).min(0) and best_core equals selection_map, "
        "bit for bit")


def main_sweep_spec():
    """The sweep's main path: the axes of benchmarks/fleet.py's planner
    study plus the redundancy and fault-rate axes that
    examples/carbon_planner.py exposes, at 4,096 draws."""
    from repro_torch.core.sweep import LifetimeDist, workload_spec
    day = 86_400.0
    dists = (
        LifetimeDist.point(30 * day),
        LifetimeDist.lognormal(100 * day, 1.8),
        LifetimeDist.weibull(300 * day, 1.5),
        LifetimeDist.mixture(
            [(LifetimeDist.point(10 * day), 0.5),
             (LifetimeDist.lognormal(1000 * day, 0.8), 0.5)]),
    )
    return workload_spec(
        dists=dists, execs_per_day=(1.0, 24.0, 96.0, 960.0, 8640.0),
        intensities=(0.05, 0.233, 0.367, 0.7), volumes=(1e3, 1e6, 1e9),
        timing=("base", "dynamic", "wcet"),
        redundancies=("none", "dmr", "tmr"), fault_rates=(0.0, 1e-6),
        draws=4096, seed=0)


def phase_main_sweep(dev):
    """The main sweep through `run_sweep` on the card: 16 drawn-kernel
    launches and no eager draw, bit-identical on a rerun and at tile
    1,536, then under torch.profiler. Returns the launches of both
    builds on the main sweep's run."""
    import numpy as np
    import _torch_parity as tp
    from repro_torch import prng
    from repro_torch.core import sweep as sw
    from repro_torch.kernels import carbon_sweep as cs

    t0 = time.perf_counter()
    spec = main_sweep_spec()
    log(f"[main sweep] spec built on the host in "
        f"{time.perf_counter() - t0:.1f}s: {spec.n_cells} cells x "
        f"{spec.draws} draws = {spec.n_scenarios} scenarios, "
        f"{spec.n_candidates} candidates")
    n_tiles = -(-spec.n_cells // 1024)
    # count the eager draws too: the card's sweep must not call them
    eager = {"_Step.life_days": 0, "prng.uniform": 0}

    def counted(fn, name):
        def call(*a, **k):
            eager[name] += 1
            return fn(*a, **k)
        return call
    life_days, uniform = sw._Step.life_days, prng.uniform
    sw._Step.life_days = counted(life_days, "_Step.life_days")
    prng.uniform = counted(uniform, "prng.uniform")
    cs.reset_counts()
    try:
        res = sw.run_sweep(spec, tile_cells=1024, device=dev)
    finally:
        sw._Step.life_days, prng.uniform = life_days, uniform
    launches = cs.sweep_tile_drawn.launches
    counts = {SWEEP[0]: cs.sweep_tile.launches, SWEEP_DRAWN[0]: launches}
    other = (cs.sweep_tile_drawn.plain_calls, cs.sweep_tile.launches,
             cs.sweep_tile.plain_calls)
    if launches != n_tiles or any(other) or any(eager.values()):
        raise AssertionError(
            f"main sweep: {launches} drawn launches for {n_tiles} tiles; "
            f"drawn plain calls, sweep_tile launches and plain calls "
            f"{other}; eager draws {eager}")
    if int(res.hist.sum()) != spec.n_scenarios:
        raise AssertionError(f"main sweep: histogram holds "
                             f"{int(res.hist.sum())} scenarios")
    log(f"[main sweep] run_sweep tile 1024: {res.n_scenarios} scenarios in "
        f"{res.wall_s:.3f}s wall = {res.scenarios_per_s:.4g} scenarios/s, "
        f"{res.host_syncs} blocking host syncs, {launches} sweep_tile_drawn "
        f"launches ({n_tiles} tiles), 0 plain calls, 0 sweep_tile launches, "
        f"eager draws {eager}, histogram total {int(res.hist.sum())}")
    again = sw.run_sweep(spec, tile_cells=1024, device=dev)
    wide = sw.run_sweep(spec, tile_cells=1536, device=dev)
    tp.assert_sweeps_identical(res, again, "main sweep rerun")
    tp.assert_sweeps_identical(res, wide, "main sweep tile 1536")
    log(f"[main sweep] rerun at tile 1024: {again.wall_s:.3f}s = "
        f"{again.scenarios_per_s:.4g} scenarios/s; tile 1536: "
        f"{wide.wall_s:.3f}s = {wide.scenarios_per_s:.4g} scenarios/s; "
        f"every field bit-identical across the three runs")
    rows = res.frontier()
    cores, n = np.unique(res.best_core, return_counts=True)
    log(f"[main sweep] frontier: {len(rows)} points, embodied "
        f"{rows[0]['embodied_kg']:.4g}..{rows[-1]['embodied_kg']:.4g} kg; "
        f"least p50 total {res.p50.min():.4g} kg; cells by modal core "
        + ", ".join(f"{spec.cores[c].name} {k}" for c, k in zip(cores, n)))
    prof, wall, busy, krows = profiled(
        lambda: sw.run_sweep(spec, tile_cells=1024, device=dev))
    if busy is None:
        log("[main sweep] the profiler saw no device activity: device busy "
            "share not measured")
        return counts
    log(f"[main sweep] under torch.profiler: {wall:.3f}s wall "
        f"({prof.wall_s:.3f}s inside run_sweep), device busy "
        f"{busy:.4f}s = share {busy / wall:.4f} of the wall")
    # device time by layer, over the device rows themselves (the aten::
    # rows repeat their kernels' time); rows that are no kernel (launch
    # queue full, event queries) get their own bucket
    layers = {"carbon_sweep kernel (draws fused)": 0.0, "sort": 0.0,
              "copies": 0.0,
              "decode, gathers, statistics (eager elementwise)": 0.0,
              "no kernel (launch queue full, event queries)": 0.0}
    kernels = [r for r in krows if r.self_device_time_total > 0
               and not r.key.startswith("aten::")]
    for r in kernels:
        k = r.key
        if "sweep_cells_kernel" in k or "sweep_pareto_kernel" in k:
            g = "carbon_sweep kernel (draws fused)"
        elif "ort" in k or "adix" in k:
            g = "sort"
        elif "emcpy" in k or "emset" in k:
            g = "copies"
        elif k.startswith("cuda") or k == "Command Buffer Full":
            g = "no kernel (launch queue full, event queries)"
        else:
            g = "decode, gathers, statistics (eager elementwise)"
        layers[g] += r.self_device_time_total / 1e3
    total = sum(layers.values())
    log("[main sweep] device time by layer: " + "; ".join(
        f"{g} {ms:.2f} ms ({ms / total:.3f})" for g, ms in layers.items()))
    log_rows("main sweep", kernels, 12)
    return counts

FAULT_CASES = (
    ("transient regs+mem+pc 1e-2",
     dict(rate=1e-2, seed=3, targets=("regs", "mem", "pc"))),
    ("transient regs+mem+pc 1.0",
     dict(rate=1.0, seed=4, targets=("regs", "mem", "pc"))),
    ("stuck 0.5", dict(rate=0.5, seed=5, mode="stuck")),
    ("dead 0.5", dict(rate=0.5, seed=6, mode="dead")),
)


def phase_fault_kernel(dev, rec):
    """The faults variant against its plain version on a small pool in
    every mode; the one-program wrapper; then at full shape, timed with
    faults off and with transients at 1e-5, and its bound."""
    import numpy as np
    import torch
    from repro_torch.flexibits import faults as pf
    from repro_torch.flexibits import iss
    from repro_torch.kernels import iss_stepper as st

    bank, clen, mlen, cost, state = pool(256, 7, dev,
                                         keys=("MC", "WQ", "SI"))
    epoch = torch.arange(256, dtype=torch.int32, device=dev) % 5
    clean = state()
    for _ in range(2):
        st.iss_segment_banked(bank, clen, clean, seg_steps=256,
                              mem_len=mlen, device=dev)
    for label, kw in FAULT_CASES:
        spec = pf.FaultSpec(**kw)
        for timing in (False, True):
            n, out = check_segment(st, dev, bank, clen, mlen,
                                   cost if timing else None, state, 256, 2,
                                   faults=spec, epoch=epoch)
            if torch.equal(out.lanes.regs, clean.lanes.regs):
                raise AssertionError(f"{label}: no fault fired")
            log(f"[fault kernel] {label}, 256 lanes x 3 programs x 2 x 256 "
                f"steps, timing {'on' if timing else 'off'}: bit-exact "
                f"({n} instructions retired)")

    # the one-program wrapper: a skewed counting loop, transients
    import _torch_parity as tp
    prog = tp.skew_program()
    mems = torch.from_numpy(tp.skew_mems(prog, 512, 8, 300, 0.3, 5)).to(dev)
    code = torch.from_numpy(
        np.asarray(prog.code, np.uint32).view(np.int32)).to(dev)
    spec = pf.FaultSpec(**FAULT_CASES[0][1])
    key = pf.lane_keys_tensor(spec.seed, 512, dev)
    ep = torch.zeros(512, dtype=torch.int32, device=dev)
    # fresh_lanes keeps an int32 image as the lanes' memory, and the
    # kernel updates it in place: each run gets its own copy
    a = st.iss_segment(code, iss.fresh_lanes(mems.clone()), seg_steps=700,
                       max_steps=650, faults=spec, lane_key=key, epoch=ep,
                       device=dev)
    z = torch.zeros(512, dtype=torch.int32, device=dev)
    b = iss.run_segment_lanes_banked(
        code[None, :].contiguous(),
        torch.full((1,), code.shape[0], dtype=torch.int32, device=dev),
        iss.PackedState(iss.fresh_lanes(mems.clone()), z, z + 650), 700,
        None, None, None, faults=spec, lane_key=key, epoch=ep).lanes
    torch.cuda.synchronize()
    max_abs_err(iss.PackedState(a, z, z), iss.PackedState(b, z, z))
    log("[fault kernel] iss_segment (one program, 512 lanes, transients "
        "1e-2): bit-exact with the plain version")

    # ---- full shape: 16,384 lanes x 4,096 steps, timing on
    L, SEGSTEPS = 16384, 4096
    bank, clen, mlen, cost, state = pool(L, 2, dev)
    s0 = state()
    spec = pf.FaultSpec(rate=1e-5, seed=5, targets=("regs", "mem", "pc"))
    key = pf.lane_keys_tensor(spec.seed, L, dev)
    ep = torch.zeros(L, dtype=torch.int32, device=dev)
    kw = dict(mem_len=mlen, cost=cost, device=dev)
    plain = [None]

    def run_plain():
        plain[0] = iss.run_segment_lanes_banked(
            bank, clen, clone(s0), SEGSTEPS, None, mlen, cost, faults=spec,
            lane_key=key, epoch=ep)
    plain_ms = events_ms(run_plain)
    t_off, t_on = [], []
    out = [None]
    for _ in range(3):
        for faults, times in ((None, t_off), (spec, t_on)):
            s = clone(s0)
            torch.cuda.synchronize()
            times.append(events_ms(lambda: out.__setitem__(
                0, st.iss_segment_banked(bank, clen, s, seg_steps=SEGSTEPS,
                                         faults=faults, lane_key=key,
                                         epoch=ep, **kw))))
            if faults is not None:
                err = max_abs_err(out[0], plain[0])
    steps = int((plain[0].lanes.n_instr - s0.lanes.n_instr).sum())
    fires = count_fires(spec, key, ep, s0, plain[0])
    nbytes = 2 * sum(x.numel() * x.element_size() for x in s0.lanes) + sum(
        x.numel() * x.element_size()
        for x in (s0.prog_id, s0.max_steps, bank, clen, mlen, cost, key, ep))
    n_ops = steps * (OPS_PER_STEP + FAULT_OPS_PER_STEP) \
        + fires * FAULT_OPS_PER_FIRE
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = n_ops / INT32_OPS_PER_S * 1e3
    ms_off, ms_on = sorted(t_off)[1], sorted(t_on)[1]
    rec[SEG_FAULTS[0]] = dict(
        ms=ms_on, plain_ms=plain_ms, max_abs_err=err,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations")
    log(f"[fault kernel] full shape {L} lanes x {SEGSTEPS} steps (timing "
        f"on; earlier kernel: faults off {EARLIER_SEG_MS['fault-free']} ms, "
        f"transients {EARLIER_SEG_MS['faults']} ms): faults off "
        f"{ms_off:.3f} ms (runs "
        f"{', '.join(f'{x:.3f}' for x in t_off)}); transients 1e-5 "
        f"{ms_on:.3f} ms (runs {', '.join(f'{x:.3f}' for x in t_on)}), "
        f"{ms_on / ms_off:.3f}x; bit-exact with the plain version "
        f"({plain_ms:.1f} ms); {steps} retired lane-steps, {fires} fires; "
        f"bound {max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f}, "
        f"operations {n_ops} -> {b_ops:.4f})")


def count_fires(spec, key, epoch, before, after) -> int:
    """Transient fires of a segment: for each lane, the post-commit
    counts n in (before, after] whose draw mix32(k ^ n) is under the
    threshold (the halting step's draw is counted too: an upper bound)."""
    import torch
    from repro_torch import _u32
    from repro_torch.flexibits import faults as pf
    k = pf.mix32(key ^ pf.mix32(epoch))
    lo, hi = before.lanes.n_instr, after.lanes.n_instr
    fires = torch.zeros((), dtype=torch.int64, device=k.device)
    for n in range(int(lo.min()) + 1, int(hi.max()) + 1):
        hit = (_u32.as_u32(pf.mix32(k ^ n)) < spec.threshold) \
            & (n > lo) & (n <= hi)
        fires += hit.sum()
    return int(fires)


def small_resilient_plan(**kw):
    from repro_torch.fleet import FleetGroup, FleetPlan
    return FleetPlan(groups=(
        FleetGroup(workload="MC", core="SERV", n_items=64, seed=0,
                   max_steps="static"),
        FleetGroup(workload="WQ", core="QERV", n_items=64, seed=1,
                   max_steps="static"),
        FleetGroup(workload="SI", core="HERV", n_items=64, seed=2,
                   max_steps="static"),
    ), chunk=128, seg_steps=1024, **kw)


def phase_small_resilient(dev):
    """Phase 4's groups with transients, unprotected and under DMR, on
    card and CPU: every per-item field, counters and schedule equal."""
    import numpy as np
    import torch
    from repro_torch.fleet import run_plan
    from repro_torch.flexibits.faults import FaultSpec
    spec = FaultSpec(rate=1e-4, seed=5, targets=("regs", "mem", "pc"))
    for label, kw in (("unprotected", dict(faults=spec)),
                      ("dmr", dict(faults=spec, redundancy="dmr",
                                   max_retries=6))):
        plan = small_resilient_plan(**kw)
        t0 = time.perf_counter()
        gpu = run_plan(plan, keep_state=True, device=dev)
        t1 = time.perf_counter()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cpu = run_plan(plan, keep_state=True, device="cpu", power_w=0.0)
        finally:
            torch.set_num_threads(threads)
        t2 = time.perf_counter()
        for a, b in zip(gpu.groups, cpu.groups):
            for f in ("n_instr", "n_two_stage", "halted", "out", "mix",
                      "mems", "regs", "pc", "mix_items"):
                if not np.array_equal(getattr(a.result, f),
                                      getattr(b.result, f)):
                    raise AssertionError(f"small {label} plan: card and CPU "
                                         f"differ in {a.workload.key}.{f}")
        p, q = gpu.packed, cpu.packed
        for f in ("lane_steps", "n_segments", "seg_schedule", "detected",
                  "corrected", "quarantined"):
            if getattr(p, f) != getattr(q, f):
                raise AssertionError(f"small {label} plan: {f} differs "
                                     f"({getattr(p, f)} vs {getattr(q, f)})")
        if label == "dmr" and p.detected == 0:
            raise AssertionError("small dmr plan: nothing detected")
        log(f"[small resilient] {label}: 3 groups x 64 items, chunk "
            f"{p.chunk}: card {t1 - t0:.2f}s, CPU {t2 - t1:.2f}s; every "
            f"per-item field, the final state, {p.n_segments} segments, "
            f"{p.lane_steps} lane-steps and detected/corrected/quarantined "
            f"{p.detected}/{p.corrected}/{p.quarantined} bit-exact")


def dmr_boundary_ms(dev):
    """Device time of one DMR boundary's digest, snapshot copy and
    rollback at the main path's pool shape (16,384 lanes x 2,824 words;
    random contents, which these costs do not depend on), from CUDA
    events (mean of 5; the rollback selects every field)."""
    import torch
    from repro_torch.flexibits import faults as pf
    from repro_torch.flexibits import iss
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             dtype=torch.int32, device=dev)
    L = 16384
    lanes = iss.ISSState(r(L, 16), r(L), r(L, 2824), r(L) > 0, r(L), r(L),
                         r(L, 8), r(L))
    snap = iss.ISSState(*(x.clone() for x in lanes))
    rb = r(L) > 2**30                      # a quarter of the lanes
    digest = events_ms(lambda: pf.arch_digest(
        lanes.regs, lanes.pc, lanes.mem, lanes.halted, lanes.n_instr), 5)

    def copy():
        for x, y in zip(snap, lanes):
            x.copy_(y)

    def rollback():
        for x, y in zip(lanes, snap):
            torch.where(rb.view((-1,) + (1,) * (x.dim() - 1)), y, x, out=x)
    return digest, events_ms(copy, 5), events_ms(rollback, 5)


def phase_main_resilient(dev, main_rep):
    """Phase 5's plan (a) with unprotected transients, (b) the same under
    DMR, (c) dead lanes under DMR; launch counts per run, items against
    phase 5's, and each run once more under torch.profiler."""
    import numpy as np
    from repro_torch.fleet import run_plan
    from repro_torch.flexibits.faults import FaultSpec
    from repro_torch.kernels import iss_stepper as st
    base = main_plan()
    transient = FaultSpec(rate=1e-5, seed=5, targets=("regs", "mem", "pc"))
    runs = (
        ("a", "transients 1e-5, unprotected", dict(faults=transient)),
        ("b", "transients 1e-5, DMR, max_retries 6",
         dict(faults=transient, redundancy="dmr", max_retries=6)),
        ("c", "dead lanes 1e-3, DMR, max_retries 1",
         dict(faults=FaultSpec(rate=1e-3, seed=5, mode="dead"),
              redundancy="dmr", max_retries=1)),
    )
    total_launches = 0
    for tag, label, kw in runs:
        plan = dataclasses.replace(base, **kw)
        st.reset_counts()
        rep = run_plan(plan, device=dev)
        launches = st.iss_segment_banked.fault_launches
        if launches <= 0 or st.iss_segment_banked.launches \
                or st.iss_refill.launches <= 0 \
                or st.iss_segment_banked.plain_calls \
                or st.iss_refill.plain_calls:
            raise AssertionError(
                f"({tag}) launches: faults {launches}, fault-free "
                f"{st.iss_segment_banked.launches}, refill "
                f"{st.iss_refill.launches}, plain calls "
                f"{st.iss_segment_banked.plain_calls}")
        total_launches += launches
        p = rep.packed
        # architectural results (output, retirements, halt) of every item
        # against phase 5's; DMR's digest covers the architectural state
        # only, so its recovery is held to those, and the tallies it does
        # not cover (two-stage count, ticks, mix) are counted
        differ = tallies = 0
        mix_diff = {}
        for g, g0 in zip(rep.groups, main_rep.groups):
            a, b = g.result, g0.result
            bad = (a.out != b.out) | (a.n_instr != b.n_instr) \
                | (a.halted != b.halted)
            differ += int(bad.sum())
            tallies += int(((a.n_two_stage != b.n_two_stage)
                            | (a.n_cycles != b.n_cycles)).sum())
            if not np.array_equal(a.mix, b.mix):
                mix_diff[g.workload.key] = (a.mix - b.mix).tolist()
        if tag != "a" and differ:
            raise AssertionError(f"({tag}) {differ} items' output, "
                                 f"retirement count or halt differ from "
                                 f"the fault-free run")
        if tag == "b" and not (p.detected > 0
                               and p.corrected <= p.detected):
            raise AssertionError(f"(b) detected {p.detected}, corrected "
                                 f"{p.corrected}")
        if tag == "c" and p.quarantined <= 0:
            raise AssertionError("(c) nothing quarantined")
        log(f"[resilient main] ({tag}) {label}: {rep.n_items} items in "
            f"{p.wall_s:.2f}s wall = {rep.n_items / p.wall_s:.1f} items/s "
            f"(fault-free {main_rep.packed.wall_s:.2f}s, "
            f"{p.wall_s / main_rep.packed.wall_s:.2f}x), chunk {p.chunk}, "
            f"{p.n_segments} segments, {p.host_syncs} blocking host syncs, "
            f"{launches} faults-variant launches, "
            f"{st.iss_refill.launches} refill launches; detected "
            f"{p.detected}, corrected {p.corrected}, quarantined "
            f"{p.quarantined}; items whose output, retirement count or "
            f"halt differ from the fault-free run: {differ}; items whose "
            f"two-stage count or ticks differ: {tallies}; groups whose "
            f"instruction mix differs (this run minus the fault-free one, "
            f"by class): {mix_diff or 'none'}")
        if tag == "a":
            log(f"[resilient main] (a) unprotected SDC count (output, "
                f"retirement count or halt differ): {differ} of "
                f"{rep.n_items} items")
        prep, wall, busy, rows = profiled(lambda: run_plan(plan, device=dev))
        if busy is None:
            log(f"[resilient main] ({tag}) the profiler saw no device "
                f"activity: busy share not measured")
        else:
            log(f"[resilient main] ({tag}) under torch.profiler: "
                f"{wall:.2f}s wall ({prep.packed.wall_s:.2f}s inside "
                f"run_packed), device busy {busy:.3f}s = share "
                f"{busy / wall:.4f}")
            log_rows(f"resilient main ({tag})", rows, 8)
            log_per_launch(f"resilient main ({tag})", rows)
        if tag == "b":
            d, c, r = dmr_boundary_ms(dev)
            n = p.n_segments
            log(f"[resilient main] (b) one DMR boundary at full shape: "
                f"digest {d:.3f} ms, snapshot copy {c:.3f} ms, rollback "
                f"{r:.3f} ms (CUDA events); x {n} boundaries = digest "
                f"{d * n:.1f} ms, snapshot {c * n:.1f} ms, rollback "
                f"{r * n:.1f} ms of device time")
    return total_launches


# ------------------------------------------------------------------ LM
# bfloat16 dense rate of the tensor cores (NVIDIA's data sheet, H100
# SXM): the least time for a product of bfloat16 inputs
BF16_OPS_PER_S = 989e12
# kernel against plain version on the same inputs: largest |difference|
# over the output's largest magnitude (at least 1). The float32
# instantiations multiply in float32 like their plain versions, in
# another order: 1e-4 for float32 outputs. The bfloat16 ones multiply
# bfloat16 operands on the tensor cores into float32 sums (the bit
# planes' W_q and the flash kernel's q, k, v are exact in bfloat16), and
# the flash kernel rounds P to bfloat16 for P v, the scan kernel W, S
# and B w for their products: one bfloat16 step (2^-7) for bfloat16
# outputs
LM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
FLASH = ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:61")
SSD = ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
       "src/repro/kernels/ssd_scan.py:67")
BITPLANE = ("bitplane_matmul",
            "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
            "src/repro/kernels/bitplane_matmul.py:56")
# the scan kernel's time at the main shape before its bfloat16 path moved
# to the tensor cores (measured on one NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_SSD_MS = 2.880
# the main serve: Zamba2-7B, 8 requests, prompt 512, 32 generated tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
SERVE_PARAMS = 6.957e9          # count_params_abstract of the reference
PROFILE_GEN = 8


def lm_err(got, want, what, tol=None):
    """Largest |got - want|; raises past the stated tolerance."""
    dt = str(got.dtype).replace("torch.", "")
    tol = LM_TOL[dt] if tol is None else tol
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: kernel and plain version differ by "
                             f"{err:.3g} (tolerance {tol} x {scale:.3g})")
    return err


def timed(fn, reps):
    fn()                                            # warm-up
    return events_ms(fn, reps)


def kernel_name(mangled: str) -> str:
    """A kernel's own name and template argument from its mangled name
    (_Z[N] <len><namespace>... <len><name> I<arg>E ...)."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    arg = re.match(r"I(?:Li(\d+)|(\w))E", mangled[i:])
    return name + (f"<{arg.group(1) or arg.group(2)}>" if arg else "")


def ptxas_report(log: str):
    """[(kernel, registers, static shared bytes, spill stores, spill
    loads)] from nvcc's -Xptxas=-v output."""
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            rows.append((kernel_name(fn), int(m.group(1)),
                         int(m.group(2) or 0), *spill))
            fn = None
    return rows


def sass_mma_counts(lib: str):
    """{kernel: (HMMA, HGMMA)}: the tensor-core instructions in the SASS
    of a built library, or None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += bool(re.search(r"\bHMMA\.", line))
            counts[fn][1] += bool(re.search(r"\bHGMMA\.", line))
    return {k: tuple(v) for k, v in counts.items()}


def check_tensor_cores():
    """Counts each LM kernel's tensor-core instructions; fails if the
    bfloat16 flash kernel, the bfloat16 scan kernel or the bit planes'
    GEMM has none."""
    libs = ("flash_attention", "ssd_scan", "bitplane_matmul")
    counts = {lib: sass_mma_counts(lib) for lib in libs}
    if counts[libs[0]] is None:
        log("[lm kernels] no cuobjdump in the toolkit: tensor-core "
            "instructions not counted")
        return
    for lib, c in counts.items():
        log(f"[lm kernels] {lib} SASS: " + "; ".join(
            f"{k} {h} HMMA, {g} HGMMA" for k, (h, g) in c.items()))
    for lib, kernel in (("flash_attention", "flash_fwd_mma"),
                        ("ssd_scan", "ssd_fwd_mma"),
                        ("bitplane_matmul", "bitplane_gemm")):
        hits = [sum(v) for k, v in counts[lib].items()
                if k.startswith(kernel)]
        if not hits or min(hits) == 0:
            raise AssertionError(f"{kernel} ({lib}) has no HMMA or HGMMA "
                                 f"instruction in its SASS: {counts[lib]}")


def flash_bound(q, tq, tk, causal):
    """Bytes (q, k, v read once, o written once) and operations (two
    products over the (query, key) pairs the function uses) over the
    card's peaks, ms."""
    bh, l, d = q.shape
    pairs = 0
    for qp in range(l):
        if causal:
            up = min(max((qp // tq + 1) * tq // tk, 1), l // tk)
            pairs += min(qp + 1, up * tk)
        else:
            pairs += l
    nbytes = 4 * q.numel() * q.element_size()
    ops = 4 * bh * d * pairs
    rate = BF16_OPS_PER_S if q.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3


def ssd_bound(a, x, dt, b, c, q):
    """Bytes (inputs read once, y and the final state written once) and
    operations (per chunk: C.B over the causal pairs, their weighted sum
    of x, C.S and the state update) over the card's peaks, ms."""
    bh, l, p = x.shape
    n = b.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (a, x, dt, b, c)) \
        + x.numel() * x.element_size() + bh * n * p * 4
    pairs = q * (q + 1) // 2
    ops = bh * (l // q) * (pairs * 2 * (n + p) + 4 * q * n * p)
    rate = BF16_OPS_PER_S if x.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3


def bitplane_bound(x, planes, scales, n):
    m, k = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in (x, planes, scales)) \
        + m * n * x.element_size()
    rate = BF16_OPS_PER_S if x.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / rate * 1e3


def record(rec, name, ms, plain_ms, err, bounds, library_ms, detail):
    b_bytes, b_ops = bounds
    rec[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                     bound_ms=max(b_bytes, b_ops),
                     bound_by="bytes" if b_bytes >= b_ops else "operations",
                     library_ms=library_ms, detail=detail)
    log(f"[lm kernels] {name} {detail}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
        f"bound {max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f}, "
        f"operations {b_ops:.4f}); max |kernel - plain| {err:.3g}")


def phase_lm_kernels(dev, rec):
    """The three LM kernels against their plain versions: small and
    ragged shapes in float32 and bfloat16, then the main path's shapes in
    bfloat16, timed with CUDA events beside the plain version and, where
    one PyTorch call computes the same function, that call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as pss

    # float32 products in full float32 on the card, stated and set (the
    # plain versions and the library calls use cuBLAS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(14)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    check_tensor_cores()
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for bh, l, d, tq, tk in ((3, 11, 16, 11, 11), (2, 200, 112, 200, 200),
                                 (2, 200, 64, 50, 100),
                                 (2, 200, 64, 100, 50),
                                 (2, 200, 40, 200, 200),
                                 (2, 200, 40, 50, 100)):
            for causal in (True, False):
                q, k, v = (rnd((bh, l, d), dtype) for _ in range(3))
                got = pfa.flash_attention(q, k, v, causal=causal, tq=tq,
                                          tk=tk, device=dev)
                torch.cuda.synchronize()
                lm_err(got, pfa.flash_attention_plain(
                    q, k, v, causal=causal, tq=tq, tk=tk),
                    f"flash {dtype} {(bh, l, d, tq, tk, causal)}")
                n_cases += 1
        # two chunks and an odd head count; three chunks, three groups;
        # P = N = 128 (the bfloat16 kernel's wide build); a chunk past one
        # C B^T strip of the bfloat16 kernel (one head a block)
        for bt, h, l, p, n, q_, groups in ((1, 3, 22, 16, 8, 11, 1),
                                           (2, 5, 96, 64, 64, 48, 5),
                                           (2, 6, 300, 20, 40, 100, 3),
                                           (1, 4, 512, 128, 128, 256, 1),
                                           (1, 2, 1024, 64, 64, 512, 1)):
            x = rnd((bt * h, l, p), dtype)
            dt = F.softplus(rnd((bt * h, l)))
            a = -torch.exp(rnd((bt * h,), scale=0.3))
            b = rnd((bt * groups, l, n), dtype, 0.5)
            c = rnd((bt * groups, l, n), dtype, 0.5)
            y, s = pss.ssd_scan(a, x, dt, b, c, q=q_, rep=h // groups,
                                device=dev)
            torch.cuda.synchronize()
            yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=q_,
                                        rep=h // groups)
            lm_err(y, yp, f"ssd y {dtype} {(bt, h, l, p, n, q_, groups)}")
            lm_err(s, sp, "ssd state", LM_TOL[str(dtype)[6:]])
            n_cases += 1
        for bits in (1, 4, 8):
            x = rnd((256, 128), dtype)
            w = rnd((128, 384), scale=0.1)
            planes, scales, _ = ref.quantize_weights(w, bits)
            got = pbp.bitplane_matmul(x, planes, scales, bits=bits,
                                      device=dev)
            torch.cuda.synchronize()
            lm_err(got, pbp.bitplane_matmul_plain(x, planes, scales,
                                                  bits=bits),
                   f"bitplane {dtype} bits {bits}")
            xm = rnd((3, 50, 128), dtype)           # ragged M, padded
            lm_err(ops.quantized_linear(xm, w, bits=bits, device=dev),
                   ref.bitplane_matmul_ref(xm.reshape(-1, 128), planes,
                                           scales, bits=bits
                                           ).reshape(3, 50, 384),
                   f"quantized_linear {dtype} bits {bits}")
            # ragged against the bfloat16 GEMM's 128 x 256 x 64 block tile
            x = rnd((384, 640), dtype)
            w = rnd((640, 384), scale=0.1)
            planes, scales, _ = ref.quantize_weights(w, bits)
            got = pbp.bitplane_matmul(x, planes, scales, bits=bits,
                                      device=dev)
            torch.cuda.synchronize()
            lm_err(got, pbp.bitplane_matmul_plain(x, planes, scales,
                                                  bits=bits),
                   f"bitplane {dtype} bits {bits} M 384 K 640 N 384")
            n_cases += 3
    for bits in range(1, 9):
        planes, _, w_q = ref.quantize_weights(rnd((640, 384), scale=0.1),
                                              bits)
        got = pbp.bitplane_repack(planes, bits=bits, device=dev)
        if not (torch.equal(got, pbp.bitplane_repack_plain(planes, bits=bits))
                and torch.equal(got.to(torch.int32), w_q)):
            raise AssertionError(f"bitplane repack bits {bits}: not W_q")
        n_cases += 1
    log(f"[lm kernels] {n_cases} small and ragged cases in float32 and "
        f"bfloat16 equal their plain versions within {LM_TOL} x max(1, "
        f"largest |output|)")

    # ---- the main path's shapes (the main serve's prefill), bfloat16
    from repro_torch.configs.registry import get_config
    from repro_torch.models.mamba import mamba_dims
    cfg = get_config("zamba2-7b")
    bf = torch.bfloat16
    heads, d = cfg.n_heads, cfg.resolved_head_dim
    bh, l, t = SERVE_BATCH * heads, SERVE_PROMPT, min(cfg.attn_chunk,
                                                     SERVE_PROMPT)
    q, k, v = (rnd((bh, l, d), bf) for _ in range(3))
    got = pfa.flash_attention(q, k, v, causal=True, tq=t, tk=t, device=dev)
    err = lm_err(got, pfa.flash_attention_plain(q, k, v, causal=True, tq=t,
                                                tk=t), "flash main shape")
    qs, ks, vs = q[None], k[None], v[None]
    record(rec, FLASH[0],
           timed(lambda: pfa.flash_attention(q, k, v, causal=True, tq=t,
                                             tk=t, device=dev), 50),
           timed(lambda: pfa.flash_attention_plain(q, k, v, causal=True,
                                                   tq=t, tk=t), 5),
           err, flash_bound(q, t, t, True),
           timed(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                        is_causal=True), 20),
           f"BH {bh} x L {l} x D {d} bfloat16, causal, tile {t}")
    del q, k, v, qs, ks, vs, got

    s_ = cfg.ssm
    _, n_heads = mamba_dims(cfg.d_model, s_)
    bh, p, n = SERVE_BATCH * n_heads, s_.head_dim, s_.d_state
    q_, rep = min(s_.chunk, l), n_heads // s_.n_groups
    x = rnd((bh, l, p), bf)
    dt = F.softplus(rnd((bh, l)))
    a = -torch.linspace(1.0, 16.0, n_heads, device=dev).repeat(SERVE_BATCH)
    b = rnd((SERVE_BATCH * s_.n_groups, l, n), bf)
    c = rnd((SERVE_BATCH * s_.n_groups, l, n), bf)
    y, st = pss.ssd_scan(a, x, dt, b, c, q=q_, rep=rep, device=dev)
    yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=q_, rep=rep)
    err = lm_err(y, yp, "ssd main shape")
    lm_err(st, sp, "ssd main shape state", LM_TOL["bfloat16"])
    runs = [timed(lambda: pss.ssd_scan(a, x, dt, b, c, q=q_, rep=rep,
                                       device=dev), 20) for _ in range(5)]
    record(rec, SSD[0], sorted(runs)[2],
           timed(lambda: pss.ssd_scan_plain(a, x, dt, b, c, q=q_, rep=rep),
                 5),
           err, ssd_bound(a, x, dt, b, c, q_), None,
           f"BH {bh} x L {l}, P {p}, N {n}, chunk {q_}, B/C per group "
           f"({rep} heads), bfloat16; median of runs "
           f"{', '.join(f'{r:.4f}' for r in runs)} (earlier kernel: "
           f"{EARLIER_SSD_MS} ms)")
    del x, y, yp, st, sp

    m, kk, nn = SERVE_BATCH * SERVE_PROMPT, cfg.d_model, cfg.d_ff
    x = rnd((m, kk), bf)
    w = rnd((kk, nn), scale=kk ** -0.5)
    for bits in (4, 8):
        planes, scales, w_q = ref.quantize_weights(w, bits)
        wd = (w_q.float() * scales).to(bf)          # dequantised
        got = pbp.bitplane_matmul(x, planes, scales, bits=bits, device=dev)
        err = lm_err(got, pbp.bitplane_matmul_plain(x, planes, scales,
                                                    bits=bits),
                     f"bitplane main shape bits {bits}")
        # the two phases alone: the repack, and the GEMM on its W_q
        wq_b = pbp.bitplane_repack(planes, bits=bits, device=dev)
        if not torch.equal(wq_b.to(torch.int32), w_q):
            raise AssertionError(f"bitplane repack main shape bits {bits}")
        repack_ms = timed(lambda: pbp.bitplane_repack(planes, bits=bits,
                                                      device=dev), 20)
        gemm_ms = timed(lambda: pbp.bitplane_gemm(x, wq_b, scales,
                                                  device=dev), 20)
        name = BITPLANE[0] if bits == 8 else f"{BITPLANE[0]}[bits 4]"
        record(rec, name,
               timed(lambda: pbp.bitplane_matmul(x, planes, scales,
                                                 bits=bits, device=dev), 20),
               timed(lambda: pbp.bitplane_matmul_plain(x, planes, scales,
                                                       bits=bits), 3),
               err, bitplane_bound(x, planes, scales, nn),
               timed(lambda: torch.matmul(x, wd), 20),
               f"x {m} x {kk} bfloat16 @ {kk} x {nn}, {bits} bits; repack "
               f"{repack_ms:.4f} ms, GEMM {gemm_ms:.4f} ms")
        del planes, w_q, wd, got, wq_b
    torch.cuda.empty_cache()


def greedy(model, params, tokens, cap, steps):
    """Prefill and `steps` greedy decode steps: the tokens and every
    step's logits (float32, on the host)."""
    import torch
    v = model.cfg.vocab
    with torch.inference_mode():
        logits, cache = model.prefill_fn(params, {"tokens": tokens}, cap)
        out, steps_logits = [], [logits[:, 0, :v].float().cpu()]
        tok = torch.argmax(logits[..., :v], -1)
        for i in range(steps):
            out.append(tok.cpu())
            logits, cache = model.decode_fn(params, cache, tok,
                                            tokens.shape[1] + i)
            steps_logits.append(logits[:, 0, :v].float().cpu())
            tok = torch.argmax(logits[..., :v], -1)
        out.append(tok.cpu())
    return torch.cat(out, 1), steps_logits


def phase_small_serve(dev):
    """The Zamba2 smoke config with the same parameters on the card (the
    kernels) and on the CPU (the plain versions), in float32 and
    bfloat16: prefill and first decode logits within the stated
    tolerance, and greedy tokens equal wherever the CPU's top-2 margin
    exceeds twice it."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    tols = {"float32": (1e-3, 1e-3), "bfloat16": (6e-2, 8e-2)}
    for dtype, (rtol, atol) in tols.items():
        cfg = get_smoke_config("zamba2-7b").replace(dtype=dtype)
        model = build_model(cfg)
        cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
        card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                 dev)
        card.load_state_dict(cpu.state_dict())
        b, l, gen = 4, 64, 8
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, (b, l)))
        pfa.reset_counts()
        pss.reset_counts()
        tc, lc = greedy(model, card, toks.to(dev), l + gen, gen - 1)
        counts = (pss.ssd_scan.launches, pfa.flash_attention.launches)
        tp_, lp = greedy(model, cpu, toks, l + gen, gen - 1)
        if counts != (cfg.n_layers, cfg.n_layers // cfg.shared_attn_period):
            raise AssertionError(f"small serve {dtype}: launches {counts}")
        for i, what in ((0, "prefill"), (1, "first decode")):
            torch.testing.assert_close(lc[i], lp[i], rtol=rtol, atol=atol,
                                       msg=f"small serve {dtype} {what}")
        errs = [float((x - y).abs().max()) for x, y in zip(lc, lp)]
        compared = 0
        for i in range(gen):
            top2 = torch.topk(lp[i], 2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            thresh = 2 * (atol + rtol * top2[:, 0].abs())
            sure = margin > thresh
            if not bool((tc[:, i] == tp_[:, i])[sure].all()):
                raise AssertionError(f"small serve {dtype}: step {i} greedy "
                                     f"tokens differ where the CPU's margin "
                                     f"exceeds {thresh.tolist()}")
            compared += int(sure.sum())
            if not bool((tc[:, i] == tp_[:, i]).all()):
                break                   # contexts differ from here on
        for d_, params in ((dev, card), ("cpu", cpu)):
            got, _ = serve.generate(cfg, batch=b, prompt_len=l, gen=gen,
                                    seed=1, params=params, device=d_,
                                    log=lambda *a: None)
            want = (tc if d_ == dev else tp_).numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"small serve {dtype}: generate on "
                                     f"{d_} differs from the greedy loop")
        log(f"[small serve] {dtype} smoke config, {b} x {l} prompt, {gen} "
            f"tokens: card (kernels: {counts[0]} ssd_scan, {counts[1]} "
            f"flash_attention launches) vs CPU (plain): logits max |diff| "
            f"by step {', '.join(f'{e:.3g}' for e in errs)} (prefill and "
            f"first decode within rtol {rtol}, atol {atol}); greedy tokens "
            f"equal at {compared} of {b * gen} positions whose CPU margin "
            f"clears twice the tolerance, {int((tc == tp_).sum())} of "
            f"{b * gen} equal in all; generate() gives the loop's tokens on "
            f"both")


def phase_main_serve(dev, rec):
    """Zamba2-7B at full width and depth in bfloat16 through `generate`
    on the card: launch counts, rates and memory; the kernels against
    their plain versions on the tensors this prefill feeds them; the
    quantized path on its FFN input; and a profiled run."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import serve
    from repro_torch.models import hybrid as HY
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model, count_params

    cfg = get_config("zamba2-7b")
    period, n_groups, n_tail = HY.split_counts(cfg)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"[main serve] Zamba2-7B ({cfg.n_layers} Mamba2 layers, "
        f"{n_groups} invocations of {cfg.n_shared_blocks} shared blocks, "
        f"d_model {cfg.d_model}, {cfg.dtype}): {n_params} parameters "
        f"({n_params / 1e9:.3f}e9) initialised on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    if abs(n_params - SERVE_PARAMS) > 0.0005e9:
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{SERVE_PARAMS:.4g}")

    # warm-up (the allocator's pool, cuBLAS's choices), not counted
    serve.generate(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=2,
                   params=params, device=dev, log=lambda *a: None)
    for mod in (pfa, pss, pbp):
        mod.reset_counts()
    toks, stats = serve.generate(cfg, batch=SERVE_BATCH,
                                 prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                                 params=params, device=dev, log=log)
    counts = {FLASH[0]: pfa.flash_attention.launches,
              SSD[0]: pss.ssd_scan.launches}
    plain = (pfa.flash_attention.plain_calls + pss.ssd_scan.plain_calls
             + pbp.bitplane_matmul.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)
    if counts != {FLASH[0]: n_groups, SSD[0]: cfg.n_layers} or plain:
        raise AssertionError(f"main serve launches {counts}, plain calls "
                             f"{plain}: expected {n_groups} flash_attention "
                             f"and {cfg.n_layers} ssd_scan per prefill")
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"main serve tokens {toks.shape}")
    n_dec = (SERVE_GEN - 1) * SERVE_BATCH
    log(f"[main serve] {SERVE_BATCH} requests x prompt {SERVE_PROMPT}, "
        f"{SERVE_GEN} tokens each: prefill {stats['prefill_s'] * 1e3:.1f} ms "
        f"= {SERVE_BATCH * SERVE_PROMPT / stats['prefill_s']:.1f} prefill "
        f"tokens/s; {SERVE_GEN - 1} decode steps {stats['decode_s']:.3f}s = "
        f"{n_dec / stats['decode_s']:.1f} decode tokens/s "
        f"({stats['decode_s'] / (SERVE_GEN - 1) * 1e3:.2f} ms a step); "
        f"launches per prefill: {counts[SSD[0]]} ssd_scan, "
        f"{counts[FLASH[0]]} flash_attention, 0 plain calls; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes)")

    # the tensors this prefill feeds the kernels: the first Mamba layer's
    # scan and the first shared block's attention and FFN input, recorded
    # by wrapping the ops module's kernel entries for one more prefill
    seen = {}

    def keep(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if name not in seen:
                seen[name] = ([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw), out)
            return out
        return wrapped

    ffn = HY.ffn_block

    def ffn_keep(p, cfg_, h):
        if "ffn" not in seen:
            seen["ffn"] = (L.rms_norm(h, p.ln2, cfg_.rms_eps),
                           p.mlp["wi"])
        return ffn(p, cfg_, h)

    saved = (ops.ssd_scan, ops.flash_attention)
    ops.ssd_scan = keep("ssd", ops.ssd_scan)
    ops.flash_attention = keep("flash", ops.flash_attention)
    HY.ffn_block = ffn_keep
    try:
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
        with torch.inference_mode():
            model.prefill_fn(params, {"tokens": prompt},
                             SERVE_PROMPT + SERVE_GEN)
    finally:
        ops.ssd_scan, ops.flash_attention = saved
        HY.ffn_block = ffn
    (a, x, dt, b, c), kw, (y, s) = seen["ssd"]
    yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=kw["q"], rep=kw["rep"])
    e_ssd = lm_err(y, yp, "main serve first Mamba layer")
    lm_err(s, sp, "main serve first Mamba layer state", LM_TOL["bfloat16"])
    ssd_ms = timed(lambda: pss.ssd_scan(a, x, dt, b, c, q=kw["q"],
                                        rep=kw["rep"], device=dev), 20)
    ssd_plain_ms = timed(lambda: pss.ssd_scan_plain(
        a, x, dt, b, c, q=kw["q"], rep=kw["rep"]), 3)
    log(f"[main serve] ssd_scan on the first Mamba layer's own tensors "
        f"({tuple(x.shape)}, chunk {kw['q']}, {kw['rep']} heads a group): "
        f"kernel {ssd_ms:.4f} ms (earlier kernel at the main shape: "
        f"{EARLIER_SSD_MS} ms), plain {ssd_plain_ms:.3f} ms, bound "
        f"{max(ssd_bound(a, x, dt, b, c, kw['q'])):.4f} ms")
    (q, k, v), kw, o = seen["flash"]
    op = pfa.flash_attention_plain(q, k, v, causal=kw["causal"],
                                   tq=kw["tq"], tk=kw["tk"])
    e_fa = lm_err(o, op, "main serve first shared block")
    log(f"[main serve] the first Mamba layer's scan ({tuple(x.shape)}) "
        f"and the first shared block's attention ({tuple(q.shape)}, tile "
        f"{kw['tk']}) equal their "
        f"plain versions on this prefill's tensors: max |diff| "
        f"{e_ssd:.3g} and {e_fa:.3g}")
    del seen["ssd"], seen["flash"], yp, sp, op

    # the quantized path (ops.quantized_linear, the bit-plane kernel's
    # entry point) on the first shared block's FFN input and its wi
    xf, wi = seen.pop("ffn")
    xm = xf.reshape(-1, cfg.d_model)
    dense = (xm.float() @ wi.float())
    pbp.reset_counts()
    outs = {bits: ops.quantized_linear(xf, wi.float(), bits=bits,
                                       device=dev) for bits in (4, 8)}
    counts[BITPLANE[0]] = pbp.bitplane_matmul.launches
    if counts[BITPLANE[0]] != 2 or pbp.bitplane_matmul.plain_calls:
        raise AssertionError(f"quantized path: {counts[BITPLANE[0]]} "
                             f"launches")
    rel = {}
    for bits, out in outs.items():
        planes, scales, _ = ref.quantize_weights(wi.float(), bits)
        lm_err(out.reshape(-1, wi.shape[1]), pbp.bitplane_matmul_plain(
            xm, planes, scales, bits=bits), f"quantized FFN bits {bits}")
        rel[bits] = float((out.reshape(dense.shape).float() - dense).norm()
                          / dense.norm())
        del planes
    if not rel[8] < rel[4] < 0.5:
        raise AssertionError(f"quantization error by bits {rel}")
    log(f"[main serve] quantized path: the first shared block's FFN input "
        f"{tuple(xf.shape)} through ops.quantized_linear with its wi "
        f"{tuple(wi.shape)}: {counts[BITPLANE[0]]} bitplane_matmul launches "
        f"(bits 4 and 8), each equal to its plain version; relative error "
        f"against the bfloat16 weights' product {rel[4]:.4f} (4 bits), "
        f"{rel[8]:.5f} (8 bits)")
    del outs, dense, xf, xm
    torch.cuda.empty_cache()

    # profiled: the same requests with 8 generated tokens (prefill and 7
    # decode steps; reading the events of all 31 steps takes minutes),
    # device activity only
    t0 = time.perf_counter()
    run, wall, busy, rows = profiled(lambda: serve.generate(
        cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=PROFILE_GEN,
        params=params, device=dev, log=lambda *a: None), cpu=False)
    if busy is None:
        log("[main serve] the profiler saw no device activity: device busy "
            "share not measured")
    else:
        log(f"[main serve] under torch.profiler ({PROFILE_GEN} tokens): "
            f"{wall:.2f}s wall (prefill {run[1]['prefill_s']:.3f}s, "
            f"{PROFILE_GEN - 1} decode steps {run[1]['decode_s']:.3f}s "
            f"inside generate), device busy {busy:.3f}s = share "
            f"{busy / wall:.4f} of the wall; reading the trace took "
            f"{time.perf_counter() - t0 - wall:.1f}s")
        kernels = [r for r in rows if r.self_device_time_total > 0
                   and not r.key.startswith("aten::")]
        groups = {"ssd_scan kernel": 0.0, "flash_attention kernel": 0.0,
                  "matrix products (cuBLAS)": 0.0, "copies and casts": 0.0,
                  "other elementwise and reductions": 0.0}
        for r in kernels:
            k = r.key
            if "ssd_fwd" in k:
                g = "ssd_scan kernel"
            elif "flash_fwd" in k:
                g = "flash_attention kernel"
            elif "nvjet" in k or "gemm" in k.lower() or "cutlass" in k:
                g = "matrix products (cuBLAS)"
            elif "copy" in k or "emcpy" in k or "emset" in k:
                g = "copies and casts"
            else:
                g = "other elementwise and reductions"
            groups[g] += r.self_device_time_total / 1e3
        total = sum(groups.values())
        log("[main serve] device time by layer: " + "; ".join(
            f"{g} {ms:.2f} ms ({ms / total:.3f})" for g, ms in groups.items()))
        log_rows("main serve", kernels, 12)
    return counts


RESULT_FIELDS = ("n_instr", "n_two_stage", "halted", "out", "mix", "mems",
                 "regs", "pc", "mix_items", "n_cycles")


def same_results(what, want, got, fields=RESULT_FIELDS):
    """Every per-item field of two lists of FleetResults equal (a field
    absent from one must be absent from the other)."""
    import numpy as np
    for g, (a, b) in enumerate(zip(want, got)):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                raise AssertionError(f"{what}: group {g} differs in {f}")


def counted_run(what, fn, refill_launches: bool):
    """fn() with the fleet kernels' counts zeroed just before it and read
    just after: the segment kernel must have launched, no plain version
    run, and the refill kernel launched exactly when the resident loop
    ran."""
    from repro_torch.kernels import iss_stepper as st
    st.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    seg, ref = st.iss_segment_banked.launches, st.iss_refill.launches
    plain = st.iss_segment_banked.plain_calls + st.iss_refill.plain_calls
    if seg <= 0 or plain or (ref > 0) != refill_launches:
        raise AssertionError(f"{what}: iss_segment_banked {seg}, "
                             f"iss_refill {ref} launches, {plain} plain "
                             f"calls")
    return out, wall, seg, ref


def on_cpu(fn):
    """fn() with torch on one thread (the plain path's small tensors)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def past_bound_plan():
    """TT, PT, CT and AD at 28,000 items each on SERV with FlexiLint-static
    budgets: n_items x max_steps passes 2^31 - 1 in every group, so the
    engine falls back to its host loop."""
    from repro_torch.fleet import FleetGroup, FleetPlan
    return FleetPlan(groups=tuple(
        FleetGroup(workload=k, core="SERV", n_items=28_000, seed=20 + i,
                   max_steps="static")
        for i, k in enumerate(("TT", "PT", "CT", "AD"))),
        chunk=16384, seg_steps=4096)


def phase_host_loop(dev, small_rep, main_rep):
    """Phase 16: the host-refill loop and the sequential plan on the card.
    (a) phase 4's plan through refill="host" and packed=False on the card,
    per item equal to phase 4's resident run; its MC and WQ groups the
    same on the card and the CPU. (b) phase 5's plan through
    refill="host": per item equal to phase 5, more host syncs. (c) a plan
    past the int32 mix bound, which falls back to the host loop: every
    item halted with the workload's reference output."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.fleet import run_plan
    from repro_torch.fleet.engine import workload_source
    small = three_group_plan(256)
    want = [g.result for g in small_rep.groups]
    for label, kw in (("refill=host", dict(refill="host")),
                      ("packed=False", dict(packed=False))):
        plan = dc.replace(small, **kw)
        # packed=False drains each group through the resident loop
        rep, wall, seg, _ = counted_run(
            f"small plan {label}",
            lambda: run_plan(plan, keep_state=True, device=dev),
            label == "packed=False")
        same_results(f"small plan {label} vs phase 4", want,
                     [g.result for g in rep.groups])
        two = dc.replace(plan, groups=plan.groups[:2])
        gpu = run_plan(two, keep_state=True, device=dev)
        t0 = time.perf_counter()
        cpu = on_cpu(lambda: run_plan(two, keep_state=True, device="cpu",
                                      power_w=0.0))
        t_cpu = time.perf_counter() - t0
        same_results(f"small plan {label} card vs CPU",
                     [g.result for g in gpu.groups],
                     [g.result for g in cpu.groups])
        if (gpu.packed is None) != (label == "packed=False"):
            raise AssertionError(f"small plan {label}: packed stats")
        log(f"[host loop] small plan {label}: 3 groups x 256 items on the "
            f"card in {wall:.2f}s ({seg} segment launches, no plain call), "
            f"every per-item field and the final state equal to phase 4's "
            f"resident run; MC and WQ on card and CPU ({t_cpu:.2f}s) bit "
            f"for bit")

    plan = dc.replace(main_plan(), refill="host")
    rep, wall, seg, _ = counted_run(
        "main plan refill=host", lambda: run_plan(plan, device=dev), False)
    p, q = rep.packed, main_rep.packed
    same_results("main plan refill=host vs phase 5",
                 [g.result for g in main_rep.groups],
                 [g.result for g in rep.groups])
    if p.refill != "host" or p.host_syncs <= q.host_syncs:
        raise AssertionError(f"main plan host loop: refill {p.refill}, "
                             f"{p.host_syncs} host syncs vs phase 5's "
                             f"{q.host_syncs}")
    log(f"[host loop] main plan refill=host: {rep.n_items} items in "
        f"{p.wall_s:.2f}s wall = {rep.n_items / p.wall_s:.1f} items/s "
        f"(phase 5's resident loop {q.wall_s:.2f}s, "
        f"{rep.n_items / q.wall_s:.1f}), {p.n_segments} segments, "
        f"{p.host_syncs} blocking host syncs (phase 5: {q.host_syncs}), "
        f"{p.sync_wait_s:.3f}s waited, harvest and rebuild "
        f"{p.refill_wall_s:.3f}s, engine busy estimate "
        f"{p.device_busy_frac:.4f}; {seg} segment launches, no plain "
        f"call; every per-item field equal to phase 5")

    plan = past_bound_plan()
    rep, wall, seg, _ = counted_run(
        "past the mix bound", lambda: run_plan(plan, device=dev), False)
    p = rep.packed
    if p.refill != "host":
        raise AssertionError(f"past the mix bound: refill {p.refill}")
    for g, grp in zip(rep.groups, plan.groups):
        r, w = g.result, g.workload
        if not r.halted.all():
            raise AssertionError(f"past the bound: {w.key}: "
                                 f"{int((~r.halted).sum())} items never "
                                 f"halted")
        n_chk = 1024 if w.key == "TT" else r.n_items
        mems = workload_source(w, grp.seed)(0, n_chk)
        ref = np.asarray(w.ref(mems[:, :w.n_inputs]), np.int32)
        bad = int((r.out[:n_chk] != ref).sum())
        if bad:
            raise AssertionError(f"past the bound: {w.key}: {bad} of "
                                 f"{n_chk} outputs differ")
    log(f"[host loop] past the mix bound (TT, PT, CT, AD x 28,000 on SERV, "
        f"static budgets): refill={p.refill}, {rep.n_items} items halted "
        f"in {p.wall_s:.2f}s wall = {rep.n_items / p.wall_s:.1f} items/s, "
        f"{p.n_segments} segments, {p.host_syncs} host syncs, {seg} "
        f"segment launches, no plain call; every output equal to the "
        f"workload's reference (TT on its first 1,024)")


def phase_checkpoint(dev, main_rep):
    """Phase 17: durable resident streams. Phase 5's plan checkpointed
    every 8 segments, crashed after 20 and resumed: per-item results and
    the schedule equal to phase 5's, each save's write time and bytes,
    the resumed wall. Then a small stream crashed on the card resumes on
    the CPU, and the other way round."""
    import _torch_parity as tp
    from repro_torch.distributed import checkpoint as dckpt
    from repro_torch.fleet import InjectedFault, engine, run_plan
    from repro_torch.fleet.plan import _packed_groups
    cdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(cdir, ignore_errors=True)
    writes, reads = [], []
    save, restore = dckpt.save, dckpt.restore

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, tree, **kw)
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        writes.append((step, time.perf_counter() - t0, nbytes))
        return path

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        reads.append((out[1], time.perf_counter() - t0))
        return out

    dckpt.save, dckpt.restore = timed_save, timed_restore
    try:
        plan = main_plan()
        lowered, _ = _packed_groups(plan)

        def crash():
            try:
                engine.run_packed(
                    lowered, chunk=plan.chunk, seg_steps=plan.seg_steps,
                    prefetch=plan.prefetch, adaptive=plan.adaptive,
                    checkpoint_dir=cdir, checkpoint_every=8,
                    _crash_after_segments=20, device=dev)
            except InjectedFault:
                return
            raise AssertionError("the checkpointed main plan did not crash")
        _, crash_wall, _, _ = counted_run("checkpointed crash", crash, True)
        if sorted(dckpt.all_steps(cdir)) != [8, 16]:
            raise AssertionError(f"checkpoints {dckpt.all_steps(cdir)}")
        rep, wall, seg, ref = counted_run(
            "resume", lambda: run_plan(plan, checkpoint_dir=cdir,
                                       checkpoint_every=8, device=dev),
            True)
    finally:
        dckpt.save, dckpt.restore = save, restore
    p, q = rep.packed, main_rep.packed
    same_results("resumed main plan vs phase 5",
                 [g.result for g in main_rep.groups],
                 [g.result for g in rep.groups])
    # lane_steps may differ: a resume stages the unconsumed items again,
    # so lanes can take other items than in the uninterrupted run
    for f in ("n_segments", "seg_schedule"):
        if getattr(p, f) != getattr(q, f):
            raise AssertionError(f"resumed main plan: {f} differs")
    for step, secs, nbytes in writes:
        log(f"[checkpoint] main plan save at segment {step}: write "
            f"{secs * 1e3:.1f} ms (serialise, CRC32, rename), {nbytes} "
            f"bytes on disk")
    for step, secs in reads:
        log(f"[checkpoint] restore of segment {step}: {secs * 1e3:.1f} ms "
            f"(read and CRC32-verify)")
    log(f"[checkpoint] main plan crashed after 20 segments in "
        f"{crash_wall:.2f}s (checkpoints at 8 and 16), resumed in "
        f"{wall:.2f}s ({p.wall_s:.2f}s in run_packed; phase 5's whole run "
        f"{q.wall_s:.2f}s): {p.n_segments} segments, {seg} segment and "
        f"{ref} refill launches in the resumed run, no plain call; every "
        f"per-item field, n_segments and the schedule equal to phase 5's "
        f"({p.lane_steps} lane-step slots, phase 5 {q.lane_steps})")

    kw = dict(chunk=16, seg_steps=64, keep_state=True)

    def groups():
        return tp.skew_groups(engine, max_steps_b=100_000)
    gold, gs = engine.run_packed(groups(), device=dev, **kw)
    for crash_dev, resume_dev in ((dev, "cpu"), ("cpu", dev)):
        d = os.path.join(cdir, f"small_{crash_dev}")
        try:
            on_cpu(lambda: engine.run_packed(
                groups(), checkpoint_dir=d, checkpoint_every=4,
                _crash_after_segments=10, device=crash_dev, **kw))
            raise AssertionError("the small stream did not crash")
        except InjectedFault:
            pass
        res, rs = on_cpu(lambda: engine.run_packed(
            groups(), checkpoint_dir=d, checkpoint_every=4,
            device=resume_dev, **kw))
        same_results(f"small stream crashed on {crash_dev}, resumed on "
                     f"{resume_dev}", gold, res)
        if (rs.n_segments, rs.seg_schedule) != (gs.n_segments,
                                                gs.seg_schedule):
            raise AssertionError("small stream: schedule differs")
        log(f"[checkpoint] small stream (64 items) crashed on {crash_dev} "
            f"at segment 10, resumed on {resume_dev} from its segment-8 "
            f"checkpoint: every per-item field, the final state and "
            f"{rs.n_segments} segments equal to the card's uninterrupted "
            f"run")
    shutil.rmtree(cdir, ignore_errors=True)


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
        for kern, regs, smem, st, ld in ptxas_report(_build.build_log(n)):
            log(f"[build] {n}: {kern}: {regs} registers, {smem} bytes "
                f"static shared memory, spill stores {st} / loads {ld} "
                f"bytes")

    rec = {}
    t0 = time.perf_counter()
    phase_kernels(dev, rec)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    small_rep = phase_small_plan(dev)
    log(f"[small plan] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts, main_rep = phase_main(dev)
    log(f"[main] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_profile(dev)
    log(f"[profile] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_sweep_kernel(dev, rec)
    log(f"[sweep kernel] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_sweep(dev)
    log(f"[small sweep] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts.update(phase_main_sweep(dev))
    log(f"[main sweep] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_fault_kernel(dev, rec)
    log(f"[fault kernel] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_resilient(dev)
    log(f"[small resilient] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts[SEG_FAULTS[0]] = phase_main_resilient(dev, main_rep)
    log(f"[resilient main] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_lm_kernels(dev, rec)
    log(f"[lm kernels] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_serve(dev)
    log(f"[small serve] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts.update(phase_main_serve(dev, rec))
    log(f"[main serve] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_host_loop(dev, small_rep, main_rep)
    log(f"[host loop] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_checkpoint(dev, main_rep)
    log(f"[checkpoint] phase {time.perf_counter() - t0:.1f}s")

    log("kernels: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    out = []
    for name_, src, replaces in (SEG, REF, SWEEP, SWEEP_DRAWN, SEG_FAULTS,
                                 FLASH, SSD, BITPLANE):
        r = rec[name_]
        out.append({"name": name_, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name_],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r.get("library_ms")})
    log(json.dumps({"kernels": out}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
