"""Where the wide bfloat16 flash forward (`flash_fwd_wgmma`, D 192 and 256)
spends its time: copies of `csrc/flash_attention.cu` with one part of the
kernel changed or switched off by a text edit (an edit whose text is not
found as often as listed stops the script), built side by side with nvcc
into `build/kernels/ablate_flash/` and launched through
`flash_attention_launch` at Gemma3-12B's serve shape (BH 8 x 16 = 128, L
4,096, D 256, tile 1,024; causal and window 1,024) and DeepSeek-V3's first
MLA layer (BH 8 x 128 = 1,024, L 4,096, D 192, causal). Variants marked
"wrong" compute wrong outputs: only their times mean anything. Each time
is the least of four rounds (every variant in turn, then in reverse, twice)
of the mean of 10 launches by CUDA events, in one process on one card.
Needs a CUDA card:

    python3 scripts/flash_wgmma_ablate.py
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

# name -> [(text, replacement, times found)]; a guard reads a launch
# argument, so the compiler keeps the code it skips
VARIANTS = {
    "all": [],
    "no turns (warpgroups issue at will)": [
        ("lm::bar_sync(mine, 256);", "", 3),
        ("lm::bar_arrive(other, 256);", ";", 4)],
    "exp2f for the SFU's ex2.approx": [(
        '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "  y = exp2f(x);", 1)],
    "heads fastest in the grid": [
        ("  const int bh = blockIdx.y;\n  const int q0 = (gridDim.x - 1 - "
         "blockIdx.x) * kWgRows;",
         "  const int bh = blockIdx.x;\n  const int q0 = (gridDim.y - 1 - "
         "blockIdx.y) * kWgRows;", 1),
        ("  const dim3 grid((L + kWgRows - 1) / kWgRows, bh);",
         "  const dim3 grid(bh, (L + kWgRows - 1) / kWgRows);", 1)],
    "wrong: no correction of O": [(
        "#pragma unroll\n    for (int n = 0; n < NO / 4; ++n) {\n"
        "      acc[4 * n] *= c_lo;",
        "    if (L < 0)\n#pragma unroll\n    for (int n = 0; n < NO / 4; ++n) "
        "{\n      acc[4 * n] *= c_lo;", 1)],
    "wrong: S scaled, no softmax": [(
        "  auto softmax = [&](int j) {\n    const int k0 = kbeg + j * kKeys;",
        "  auto softmax = [&](int j) {\n    if (L > 0) {\n      c_lo = c_hi = "
        "1.f;\n#pragma unroll\n      for (int i = 0; i < 32; ++i) sc[i] *= "
        "scale_log2;\n      return;\n    }\n    const int k0 = kbeg + j * "
        "kKeys;", 1)],
    "wrong: k and v loaded once (no refills)": [(
        "    const int s = j % S;\n",
        "    const int s = j % S;\n    if (j >= S && L > 0) {\n"
        "      lm::mbar_arrive(full + 8 * s);\n      return;\n    }\n", 1)],
}
# (name, BH, L, D, tile, window), causal
SHAPES = [("gemma3-12b serve, causal", 128, 4096, 256, 1024, 0),
          ("gemma3-12b serve, window 1,024", 128, 4096, 256, 1024, 1024),
          ("deepseek-v3 mla layer 0", 1024, 4096, 192, 1024, 0)]


def build(out: pathlib.Path):
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new, times in edits:
            if text.count(old) != times:
                raise SystemExit(f"{name}: edit found {text.count(old)} "
                                 f"times, not {times}: {old[:60]!r}")
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
        fn = ctypes.CDLL(str(so)).flash_attention_launch
        fn.argtypes = _build.SIGNATURES["flash_attention"][
            "flash_attention_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_wgmma_ablate: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = _build.BUILD_DIR / "ablate_flash"
    out.mkdir(parents=True, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda", 0)
    order = list(fns) + list(fns)[::-1]
    for shape, bh, l, d, t, w in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((bh, l, d), generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: [] for name in fns}
        for name in order * 2:
            def go():
                rc = fns[name](1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), 0, bh, l, d, 1, t, t, w,
                               d ** -0.5, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            go()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(10):
                go()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / 10)
        base = min(times["all"])
        print(f"{shape} (BH {bh} x L {l} x D {d}, tile {t}, window {w}): "
              + "; ".join(f"{name} {min(x):.4f} ms ({min(x) - base:+.4f})"
                          for name, x in times.items()), flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
