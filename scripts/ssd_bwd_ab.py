"""A/B timing of the bfloat16 scan backward at the SSM training shapes.

Run on a machine with a CUDA card, once for each checkout to compare, in
turns (parent, change, change, parent) within one call:

    PYTHONPATH=<checkout>/src python3 scripts/ssd_bwd_ab.py <tag>

The package on PYTHONPATH builds its own `ssd_scan` library into its
checkout's git-ignored `build/kernels/`. The script prints the card's
name and power limit, ptxas's registers and spills for the bfloat16
backward kernels (`ssd_bwd_wgmma`, or `ssd_bwd_mma` where the package
has it) and any wgmma it serialised (when this process built the
library), and for each shape the backward's ms a call (`ssd_scan_bwd`
on the forward kernel's saved states: CUDA events over 20 calls after a
warm-up, the median of 5 rounds) and its device time a call over 20
calls under torch.profiler, in all and by kernel (the scan kernel, and
what sums dB and dC after it: `ssd_bwd_sum_parts`, or torch's reduction
of the earlier kernel's partials). Shapes: Mamba2-1.3B's training (BH 8
x 64 = 512, L 512, P 64, N 128, chunk 256, 64 heads a group) and
Zamba2-7B's (BH 8 x 112 = 896, P = N = 64, 112 heads a group).
"""
import os
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as pss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, ROOT)
# after repro_torch: chip_smoke puts its own checkout's src/ on the path,
# and the package already imported from PYTHONPATH stays the one timed
import chip_smoke as cs  # noqa: E402

# (name, batch, heads, L, P, N, chunk, groups)
SHAPES = [("mamba2-1.3b train", 8, 64, 512, 64, 128, 256, 1),
          ("zamba2-7b train", 8, 112, 512, 64, 64, 256, 1)]


def ms_a_call(fn, calls=20, rounds=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def main() -> int:
    tag = sys.argv[1] if len(sys.argv) > 1 else "this checkout"
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{tag}] {smi}; package {os.path.dirname(pss.__file__)}")
    _build.build_all(["ssd_scan"])
    log = _build.build_log("ssd_scan")
    for kern, regs, _, st, ld in cs.ptxas_report(log):
        if kern.startswith(("ssd_bwd_mma", "ssd_bwd_wgmma")):
            print(f"[{tag}] {kern}: {regs} registers, spills {st}/{ld} "
                  f"bytes")
    for line in log.splitlines():   # wgmma serialised by ptxas
        if "Performance Loss" in line:
            print(f"[{tag}] {line.strip()[:300]}")
    dev = torch.device("cuda", 0)
    for name, bt, h, l, p, n, q, groups in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        bh, rep = bt * h, h // groups
        x = torch.randn((bh, l, p), generator=g, device=dev).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((bh, l), generator=g, device=dev))
        a = -torch.exp(0.3 * torch.randn((bh,), generator=g, device=dev))
        b, c = (torch.randn((bt * groups, l, n), generator=g, device=dev)
                .mul(0.5).bfloat16() for _ in range(2))
        dy = torch.randn((bh, l, p), generator=g, device=dev).bfloat16()
        ds = torch.randn((bh, n, p), generator=g, device=dev)
        _, _, states = pss._forward(a, x, dt, b, c, q, rep, dev, True)

        def call():
            return pss.ssd_scan_bwd(a, x, dt, b, c, dy, states, ds, q=q,
                                    rep=rep, device=dev)
        ms = ms_a_call(call)
        kernels = cs.kernel_device_ms(call, 20)
        if kernels is None:
            device = "lost"
        else:
            device = "{:.4f} ({})".format(
                sum(m for m, _ in kernels.values()),
                "; ".join(f"{k} {m:.4f}" for k, (m, _) in kernels.items()))
        print(f"[{tag}] {name} (BH {bh} x L {l}, P {p}, N {n}, chunk {q}, "
              f"{rep} heads a group): {ms:.4f} ms a call, device {device} "
              f"ms")
        del x, dt, a, b, c, dy, ds, states
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
