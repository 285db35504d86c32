"""Where the bfloat16 SSD scan backward kernel (`ssd_bwd_wgmma`) spends its
time: copies of `csrc/ssd_scan.cu` with one part of the kernel switched
off by a text edit (an edit whose text is not found exactly once stops
the script), built side by side with nvcc into
`build/kernels/ablate_bwd/` and launched through
`ssd_scan_bwd_wgmma_launch` at Mamba2-1.3B's and Zamba2-7B's training
shapes (8 x 512 tokens) at the heads a block the wrapper picks. Each
edit guards a part's compute with a launch argument that is never true
(`L < 0`), so the loads, block barriers and ring phases stay and the
compiler keeps the code it skips; the variants compute wrong
gradients: only their times mean anything, each the mean of 20 launches
(the kernel and the second kernel's sum of the blocks' partials of dB
and dC) by CUDA events beside the unedited build's, in one process on
one card. The parts: the column walk's state terms (u = B_j dS, dw_j),
its tile pairs (G^T, dW^T, W and dG, dx_j += W^T dy_i, the summed dG's
copy), the dB pass, the row walk (C S_c, the dS update), the dC pass,
and the blocks' writes of their dB and dC tiles (the partials).
Needs a CUDA card:

    python3 scripts/ssd_bwd_ablate.py
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as pss  # noqa: E402
from repro_torch.kernels.flash_attention import wgmma_operand  # noqa: E402

NEVER = "L < 0"
# name -> [(text, replacement)]
VARIANTS = {
    "all": [],
    "no state terms": [(
        "      if (mine) {\n        float wj[2], ej[2];",
        f"      if (mine && {NEVER}) {{\n        float wj[2], ej[2];")],
    "no pairs": [
        ("        if (mine) {\n          lm::fence_regs(dw);",
         f"        if (mine && {NEVER}) {{\n          lm::fence_regs(dw);"),
        ("        if (mine && sums) {\n          // L = 2^(cum_i - cum_j)",
         f"        if (mine && sums && {NEVER}) {{\n          // L = "
         f"2^(cum_i - cum_j)"),
        ("        if (wg == 0) {\n          // the block's heads' dG summed",
         f"        if (wg == 0 && {NEVER}) {{\n          // the block's heads' "
         f"dG summed")],
    "no dB pass": [(
        "          if (wg < NB) {\n            if (p < 0) {",
        f"          if (wg < NB && (kC || {NEVER})) {{\n            "
        f"if (p < 0) {{")],
    "no row walk": [
        ("        if (mine && pass == 0) {",
         f"        if (mine && pass == 0 && {NEVER}) {{"),
        ("        if (mine && pass == 1) {",
         f"        if (mine && pass == 1 && {NEVER}) {{")],
    "no dC pass": [(
        "          if (wg < NB) {\n            if (p < 0) {",
        f"          if (wg < NB && (!kC || {NEVER})) {{\n            "
        f"if (p < 0) {{")],
    "no partials' writes": [(
        "    for (int e = tid; e < kTile * w4; e += kBwdThreads) {",
        f"    for (int e = tid; e < kTile * w4 * !({NEVER}); "
        f"e += kBwdThreads) {{")],
}
SHAPES = {"mamba2-1.3b": (512, 512, 64, 128, 256, 64),
          "zamba2-7b": (896, 512, 64, 64, 256, 112)}


def build(out: pathlib.Path):
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: edit not found once: {old[:60]!r}")
            text = text.replace(old, new)
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
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        fn = ctypes.CDLL(str(so)).ssd_scan_bwd_wgmma_launch
        fn.argtypes = _build.SIGNATURES["ssd_scan"][
            "ssd_scan_bwd_wgmma_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_ablate: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = _build.BUILD_DIR / "ablate_bwd"
    out.mkdir(parents=True, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda", 0)
    for arch, (bh, l, p, n, q, rep) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(bh, l, p, generator=g, device=dev).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn(bh, l, generator=g, device=dev))
        a = -torch.exp(torch.randn(bh, generator=g, device=dev) * 0.3)
        b, c = ((torch.randn(bh // rep, l, n, generator=g, device=dev)
                 * 0.5).bfloat16() for _ in range(2))
        dy = torch.randn(bh, l, p, generator=g, device=dev).bfloat16()
        ds = torch.randn(bh, n, p, generator=g, device=dev)
        _, _, st = pss._forward(a, x, dt, b, c, q, rep, dev, True)
        x, b, c, dy = (wgmma_operand(t) for t in (x, b, c, dy))
        hb = pss.bwd_wgmma_heads(p, n, q, rep)
        sets, nt = -(-rep // hb), -(-q // 64)
        groups = bh // rep
        scratch = [torch.empty(bh, n, p, device=dev),
                   torch.empty(groups * sets, nt * (nt + 1) // 2, 64, 64,
                               dtype=torch.bfloat16, device=dev),
                   torch.empty_like(x), torch.empty(bh, l, device=dev),
                   torch.empty(bh, device=dev),
                   torch.empty(2, groups * sets, l, n, device=dev),
                   torch.empty(2, groups, l, n, dtype=torch.bfloat16,
                               device=dev)]
        args = ([t.data_ptr() for t in (a, x, dt, b, c, dy, st, ds)]
                + [t.data_ptr() for t in scratch])
        stream = torch.cuda.current_stream().cuda_stream
        row = {}
        for name, fn in fns.items():
            def go():
                rc = fn(*args, bh, l, p, n, p, n, q, rep, hb, stream)
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
            row[name] = e0.elapsed_time(e1) / 20
        base = row["all"]
        print(f"{arch} (BH {bh}, N {n}, rep {rep}, {hb} heads a block): "
              + "; ".join(f"{k} {v:.4f} ms ({base - v:+.4f})"
                          for k, v in row.items()), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
