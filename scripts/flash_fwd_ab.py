"""A/B timing of the bfloat16 flash forward at the serves' shapes.

Run on a machine with a CUDA card, once for each checkout to compare, in
turns (parent, change, change, parent) within one call:

    PYTHONPATH=<checkout>/src python3 scripts/flash_fwd_ab.py <tag>

The package on PYTHONPATH builds its own `flash_attention` library into
its checkout's git-ignored `build/kernels/`. The script prints the
card's name and power limit, ptxas's registers and spills for the
bfloat16 forward kernels (`flash_fwd_mma`, and `flash_fwd_wgmma` where
the package has it; when this process built the library), and for each
shape the forward's ms a call: CUDA events over 50 calls after a
warm-up, the median of 5 rounds. Shapes: Zamba2-7B's serve (BH 8 x 32 =
256, L 512, D 112, tile 512, causal), Qwen2.5-14B's and Qwen2-1.5B's
first layers (BH 320 and 96, L 512, D 128), Gemma3-12B's serve (BH 8 x
16 = 128, L 4,096, D 256, tile 1,024, window 1,024 and causal) where
the package takes D 256 and a window, and DeepSeek-V3's first MLA layer
(BH 8 x 128 = 1,024, L 4,096, D 192, tile 1,024, causal).
"""
import os
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as pfa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, ROOT)
# after repro_torch: chip_smoke puts its own checkout's src/ on the path,
# and the package already imported from PYTHONPATH stays the one timed
import chip_smoke as cs  # noqa: E402

# (name, BH, L, D, tile, window)
SHAPES = [("zamba2-7b serve", 256, 512, 112, 512, 0),
          ("qwen2.5-14b layer 0", 320, 512, 128, 512, 0),
          ("qwen2-1.5b layer 0", 96, 512, 128, 512, 0),
          ("gemma3-12b serve, local", 128, 4096, 256, 1024, 1024),
          ("gemma3-12b serve, global", 128, 4096, 256, 1024, 0),
          ("deepseek-v3 mla layer 0", 1024, 4096, 192, 1024, 0)]


def ms_a_call(fn, calls=50, rounds=5):
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
        print("flash_fwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{tag}] {smi}; package {os.path.dirname(pfa.__file__)}")
    _build.build_all(["flash_attention"])
    for kern, regs, _, st, ld in cs.ptxas_report(
            _build.build_log("flash_attention")):
        if kern.startswith(("flash_fwd_mma", "flash_fwd_wgmma")):
            print(f"[{tag}] {kern}: {regs} registers, spills {st}/{ld} "
                  f"bytes")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, bh, l, d, t, w in SHAPES:
        q, k, v = (torch.randn((bh, l, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kw = {"window": w} if w else {}
        try:
            ms = ms_a_call(lambda: pfa.flash_attention(
                q, k, v, causal=True, tq=t, tk=t, device=dev, **kw))
        except (TypeError, ValueError) as e:
            print(f"[{tag}] {name}: not taken ({e})")
            continue
        print(f"[{tag}] {name} (BH {bh} x L {l} x D {d}, tile {t}, window "
              f"{w}): {ms:.4f} ms a call")
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
