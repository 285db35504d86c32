"""A/B timing of the bfloat16 flash forward at the serves' shapes.

Run on a machine with a CUDA card, once for each checkout to compare, in
turns (parent, change, change, parent) within one call:

    PYTHONPATH=<checkout>/src python3 scripts/flash_fwd_ab.py <tag>

The package on PYTHONPATH builds its own `flash_attention` library into
its checkout's git-ignored `build/kernels/`. The script prints the
card's name and power limit, ptxas's registers and spills for the
bfloat16 forward kernels (`flash_fwd_wgmma`, and `flash_fwd_mma` where
the package has it) and any wgmma it serialised (when this process
built the library), and for each shape the forward's ms a call: CUDA
events over 50 calls after a warm-up, the median of 5 rounds, and its
kernel's device time a call over 20 calls under torch.profiler (at the
small shapes the events can time the wrapper's host work instead). Shapes, causal but Whisper's:
Zamba2-7B's serve (BH 8 x 32 = 256, L 512, D 112, tile 512),
Qwen2.5-14B's and Qwen2-1.5B's first layers (BH 320 and 96, L 512, D
128), LLaVA-NeXT-34B's first layer (BH 8 x 56 = 448, L 2,048, D 128,
tile 1,024), Qwen2-MoE-A2.7B's (BH 8 x 16 = 128, L 4,096, D 128, tile
1,024), Whisper-tiny's encoder (BH 64 x 6 = 384, L 1,500, D 64,
non-causal, one tile of 1,500), Gemma3-12B's serve (BH 8 x 16 = 128, L
4,096, D 256, tile 1,024, window 1,024 and causal) where the package
takes D 256 and a window, and DeepSeek-V3's first MLA layer (BH 8 x 128
= 1,024, L 4,096, D 192, tile 1,024).
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

# (name, BH, L, D, tile, window, causal)
SHAPES = [("zamba2-7b serve", 256, 512, 112, 512, 0, True),
          ("qwen2.5-14b layer 0", 320, 512, 128, 512, 0, True),
          ("qwen2-1.5b layer 0", 96, 512, 128, 512, 0, True),
          ("llava-next-34b layer 0", 448, 2048, 128, 1024, 0, True),
          ("qwen2-moe-a2.7b layer 0", 128, 4096, 128, 1024, 0, True),
          ("whisper-tiny encoder", 384, 1500, 64, 1500, 0, False),
          ("gemma3-12b serve, local", 128, 4096, 256, 1024, 1024, True),
          ("gemma3-12b serve, global", 128, 4096, 256, 1024, 0, True),
          ("deepseek-v3 mla layer 0", 1024, 4096, 192, 1024, 0, True)]


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
    log = _build.build_log("flash_attention")
    for kern, regs, _, st, ld in cs.ptxas_report(log):
        if kern.startswith(("flash_fwd_mma", "flash_fwd_wgmma")):
            print(f"[{tag}] {kern}: {regs} registers, spills {st}/{ld} "
                  f"bytes")
    for line in log.splitlines():   # wgmma serialised by ptxas
        if "Performance Loss" in line:
            print(f"[{tag}] {line.strip()[:300]}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, bh, l, d, t, w, causal in SHAPES:
        q, k, v = (torch.randn((bh, l, d), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        kw = {"window": w} if w else {}
        def call():
            return pfa.flash_attention(q, k, v, causal=causal, tq=t, tk=t,
                                       device=dev, **kw)
        try:
            ms = ms_a_call(call)
        except (TypeError, ValueError) as e:
            print(f"[{tag}] {name}: not taken ({e})")
            continue
        # the forward kernel's own device time: where the wrapper's host
        # work outlasts the kernel, the events time the host
        kernels = cs.kernel_device_ms(call, 20)
        device = "lost" if kernels is None else "{:.4f}".format(sum(
            m for kern, (m, _) in kernels.items() if "flash_fwd" in kern))
        print(f"[{tag}] {name} (BH {bh} x L {l} x D {d}, tile {t}, window "
              f"{w}, {'causal' if causal else 'non-causal'}): {ms:.4f} ms a "
              f"call, device {device} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
