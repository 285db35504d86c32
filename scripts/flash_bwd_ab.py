"""A/B timing of the bfloat16 flash backward at the training and serve
shapes.

Run on a machine with a CUDA card, once for each checkout to compare, in
turns (parent, change, change, parent) within one call:

    PYTHONPATH=<checkout>/src python3 scripts/flash_bwd_ab.py <tag>

The package on PYTHONPATH builds its own `flash_attention` library into
its checkout's git-ignored `build/kernels/`. The script prints the
card's name and power limit, ptxas's registers and spills for the
bfloat16 backward kernels (`flash_bwd_*_wgmma`, and `flash_bwd_*_mma`
where the package has them; when this process built the library), and
for each shape the backward's ms a call, given the forward's output and
log-sum-exp: CUDA events over 20 calls after a warm-up, the median of 5
rounds, and the device time a call by kernel (torch.profiler, 20
calls). Shapes: Gemma3-12B's training (BH 2 x 16 = 32, L 2,048, D 256,
tile 1,024; causal, window 1,024, and window 1,000 at tile 512) and
serve (BH 8 x 16 = 128, L 4,096; window 1,024 and causal), DeepSeek-V3's
training (MLA, BH 2 x 128 = 256, L 2,048, D 192, causal) and the narrow
builds': Qwen2-1.5B's training (BH 8 x 12 = 96, L 512, D 128, causal,
tile 512), Qwen2-MoE-A2.7B's (BH 2 x 16 = 32, L 2,048, D 128, causal,
tile 1,024), Zamba2-7B's (BH 8 x 32 = 256, L 512, D 112, causal, tile
512) and Whisper's encoder at 64 requests (BH 64 x 6 = 384, L 1,500,
D 64, non-causal, one tile).
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
SHAPES = [("gemma3-12b train, global", 32, 2048, 256, 1024, 0, True),
          ("gemma3-12b train, local", 32, 2048, 256, 1024, 1024, True),
          ("gemma3-12b train, window 1,000 at tile 512", 32, 2048, 256, 512,
           1000, True),
          ("gemma3-12b serve shape, local", 128, 4096, 256, 1024, 1024,
           True),
          ("gemma3-12b serve shape, global", 128, 4096, 256, 1024, 0, True),
          ("deepseek-v3 train (mla)", 256, 2048, 192, 1024, 0, True),
          ("qwen2-1.5b train", 96, 512, 128, 512, 0, True),
          ("qwen2-moe-a2.7b train", 32, 2048, 128, 1024, 0, True),
          ("zamba2-7b train", 256, 512, 112, 512, 0, True),
          ("whisper-tiny encoder, 64 requests", 384, 1500, 64, 1500, 0,
           False)]

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
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[{tag}] {smi}; package {os.path.dirname(pfa.__file__)}")
    _build.build_all(["flash_attention"])
    for kern, regs, _, st, ld in cs.ptxas_report(
            _build.build_log("flash_attention")):
        if kern.startswith("flash_bwd_") and ("mma" in kern):
            print(f"[{tag}] {kern}: {regs} registers, spills {st}/{ld} "
                  f"bytes")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for name, bh, l, d, t, w, causal in SHAPES:
        q, k, v, do = (torch.randn((bh, l, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = pfa._forward(q, k, v, causal, t, t, w, dev, True)

        def bwd():
            pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                    tq=t, tk=t, window=w, device=dev)
        ms = ms_a_call(bwd)
        split = cs.kernel_device_ms(bwd, 20)
        device = ("device time not measured (records lost)" if split is None
                  else f"device {sum(v for v, _ in split.values()):.4f} ms ("
                  + ", ".join(f"{k} {v:.4f}" for k, (v, _) in split.items())
                  + ")")
        print(f"[{tag}] {name} (BH {bh} x L {l} x D {d}, tile {t}, window "
              f"{w}, causal {causal}): {ms:.4f} ms a call; {device}",
              flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
