"""Where the bfloat16 scan forward (`ssd_fwd_wgmma`) spends its time:
copies of `csrc/ssd_scan.cu` with one part of the kernel changed or
switched off by a text edit (an edit whose text is not found as often as
listed stops the script), built side by side with nvcc into
`build/kernels/ablate_ssd_fwd/` and launched through `ssd_scan_launch`.
Shapes: Zamba2-7B's serve (BH 8 x 112 = 896, L 512, P = N = 64, chunk
256, 112 heads a group) and Mamba2-1.3B's first layer (BH 8 x 64 = 512,
P 64, N 128, 64 heads a group). Variants marked "wrong" compute wrong
outputs: only their times mean anything. Each time is the least of four
rounds (every variant in turn, then in reverse, twice) of the mean of 20
launches by CUDA events, in one process on one card. Needs a CUDA card:

    python3 scripts/ssd_fwd_ablate.py
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

sys.path.insert(1, str(ROOT))
import chip_smoke as cs  # noqa: E402

W_LO = "const float w_lo = gw[4 * n + e] * ex2(cum_lo - cj) * dj;"
W_HI = "const float w_hi = gw[4 * n + 2 + e] * ex2(cum_hi - cj) * dj;"
# name -> [(text, replacement, times found)]; a guard reads a launch
# argument, so the compiler keeps the code it skips
VARIANTS = {
    "all": [],
    "three (B, x) slots (two blocks an SM)": [
        ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;", 1)],
    "three (B, x) slots, one C slot": [
        ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;", 1),
        ("constexpr int kCSlots = 2;", "constexpr int kCSlots = 1;", 1)],
    "wrong: W's exponentials replaced by a difference": [
        (W_LO, W_LO.replace("ex2(cum_lo - cj)", "(cum_lo - cj)"), 1),
        (W_HI, W_HI.replace("ex2(cum_hi - cj)", "(cum_hi - cj)"), 1)],
    "wrong: no G products": [
        ("static_for<KN>([&](auto step) {  // G's k-steps",
         "static_for<0>([&](auto step) {", 1)],
    "wrong: no W x products": [
        ("static_for<4>([&](auto step) {  // W x's k-steps",
         "static_for<0>([&](auto step) {", 1)],
    "wrong: no state update products": [
        ("static_for<4>([&](auto step) {  // the state's products",
         "static_for<0>([&](auto step) {", 1)],
    "wrong: no C S products": [
        ("static_for<KN>([&](auto step) {  // C S's k-steps",
         "static_for<0>([&](auto step) {", 1)],
    "wrong: (B, x) slots loaded once (no refills)": [
        ("    const int s = bx_next % S, r = bx_next % per_chunk;\n",
         "    const int s = bx_next % S, r = bx_next % per_chunk;\n"
         "    if (bx_next >= S && L > 0) {\n"
         "      lm::mbar_arrive(x_full + 8 * s);\n      ++bx_next;\n"
         "      return;\n    }\n", 1)],
    "wrong: no block barrier a tile pair": [
        ("        __syncthreads();  // every warp is done with the slot (and "
         "C's)\n", "", 1)],
    "wrong: y not stored": [
        ("        if (it * kTile + r < Q && ps * kTile + 8 * cc < P)",
         "        if (it * kTile + r < Q && ps * kTile + 8 * cc < P && L < 0)",
         1)],
}
# (name, batch, heads, L, P, N, chunk, groups)
SHAPES = [("zamba2-7b serve", 8, 112, 512, 64, 64, 256, 1),
          ("mamba2-1.3b layer 0", 8, 64, 512, 64, 128, 256, 1)]


def sources() -> dict:
    """{variant: its copy of the source}; raises where an edit's text is
    not found as often as listed."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new, times in edits:
            if text.count(old) != times:
                raise SystemExit(f"{name}: edit found {text.count(old)} "
                                 f"times, not {times}: {old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(out: pathlib.Path):
    procs = {}
    for i, (name, text) in enumerate(sources().items()):
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:     # left out of the timing, with its reason
            print(f"{name}: nvcc failed: " + " | ".join(
                ln for ln in log.splitlines() if "error" in ln)[:600],
                flush=True)
            continue
        print(f"{name}: ptxas " + "; ".join(
            f"{k} {regs} registers, spills {st}/{ld} bytes"
            for k, regs, _, st, ld in cs.ptxas_report(log)
            if k.startswith("ssd_fwd_wgmma")), flush=True)
        for ln in log.splitlines():     # wgmma serialised by ptxas
            if "Performance Loss" in ln:
                print(f"{name}: {ln.strip()[:400]}", flush=True)
        fn = ctypes.CDLL(str(so)).ssd_scan_launch
        fn.argtypes = _build.SIGNATURES["ssd_scan"]["ssd_scan_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_fwd_ablate: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = _build.BUILD_DIR / "ablate_ssd_fwd"
    out.mkdir(parents=True, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda", 0)
    order = list(fns) + list(fns)[::-1]
    for shape, bt, h, l, p, n, q, groups in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        bh = bt * h
        x = torch.randn((bh, l, p), generator=g, device=dev).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((bh, l), generator=g, device=dev))
        a = -torch.exp(0.3 * torch.randn((bh,), generator=g, device=dev))
        b, c = (0.5 * torch.randn((bt * groups, l, n), generator=g,
                                  device=dev) for _ in range(2))
        b, c = b.bfloat16(), c.bfloat16()
        y = torch.empty_like(x)
        s_final = torch.empty((bh, n, p), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: [] for name in fns}
        for name in order * 2:
            def go():
                rc = fns[name](1, a.data_ptr(), x.data_ptr(), dt.data_ptr(),
                               b.data_ptr(), c.data_ptr(), y.data_ptr(),
                               s_final.data_ptr(), None, bh, l, p, n, q,
                               h // groups, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            go()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(20):
                go()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / 20)
        base = min(times["all"])
        print(f"{shape} (BH {bh} x L {l}, P {p}, N {n}, chunk {q}): "
              + "; ".join(f"{name} {min(t):.4f} ms ({min(t) - base:+.4f})"
                          for name, t in times.items()), flush=True)
        del x, dt, a, b, c, y, s_final
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
