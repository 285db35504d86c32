"""Where the wide bfloat16 flash backward (`flash_bwd_dq_wgmma` then
`flash_bwd_dkdv_wgmma`, D 192 and 256) spends its time: copies of
`csrc/flash_attention.cu` with one part of a kernel changed or switched
off by a text edit (an edit whose text is not found as often as listed
stops the script), built side by side with nvcc into
`build/kernels/ablate_flash_bwd/` and launched through
`flash_attention_bwd_launch` at Gemma3-12B's training shape (BH 2 x 16 =
32, L 2,048, D 256, tile 1,024; causal and window 1,024) and DeepSeek-V3's
(BH 2 x 128 = 256, L 2,048, D 192, causal, tile 1,024), given the
committed forward's output and log-sum-exp. Variants marked "wrong"
compute wrong gradients: only their times mean anything. Each time is the
least of four rounds (every variant in turn, then in reverse, twice) of
the mean of 10 launches by CUDA events, in one process on one card; the
committed build's two kernels are also split by their device time
(torch.profiler). Needs a CUDA card:

    python3 scripts/flash_bwd_ablate.py
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as pfa  # noqa: E402

# name -> [(text, replacement, times found)]; a guard reads a launch
# argument, so the compiler keeps the code it skips
VARIANTS = {
    "all": [],
    "wrong: exponentials replaced by a scale": [
        ("        float p_lo = ex2(fmaf(s[4 * n + e], scale_log2, -ls_lo));\n"
         "        float p_hi = ex2(fmaf(s[4 * n + 2 + e], scale_log2, "
         "-ls_hi));",
         "        float p_lo = s[4 * n + e] * scale_log2;\n"
         "        float p_hi = s[4 * n + 2 + e] * scale_log2;", 1),
        ("          const float p_lo = ex2(fmaf(sc[4 * n + e], scale_log2, "
         "-l2));\n          const float p_hi = ex2(fmaf(sc[4 * n + 2 + e], "
         "scale_log2, -l2));",
         "          const float p_lo = sc[4 * n + e] * scale_log2;\n"
         "          const float p_hi = sc[4 * n + 2 + e] * scale_log2;", 1)],
    "wrong: no wait for P^T (dK/dV pass)": [
        ("    if (c == 1) lm::bar_arrive(kPEmpty, 256);", "    ;", 1),
        ("      lm::bar_sync(kPEmpty, 256);", "      ;", 1),
        ("      lm::bar_arrive(kPFull, 256);", "      ;", 1),
        ("      lm::bar_sync(kPFull, 256);", "      ;", 1),
        ("      if (j + 1 < n_tiles) lm::bar_arrive(kPEmpty, 256);",
         "      ;", 1)],
    "wrong: q and dO loaded once (dK/dV pass, no refills)": [(
        "  auto load = [&](int j) {\n    const int s = j % S, i0 = (first + j) "
        "* kRows;\n",
        "  auto load = [&](int j) {\n    const int s = j % S, i0 = (first + j) "
        "* kRows;\n    if (j >= S && L > 0) {\n"
        "      lm::mbar_arrive(full + 8 * s);\n      return;\n    }\n", 1)],
    "wrong: k and v loaded once (dQ pass, no refills)": [(
        "    const int s = j % S;\n    // after both warpgroups' wgmma reads "
        "of the slot, before TMA's writes\n",
        "    const int s = j % S;\n    if (j >= S && L > 0) {\n"
        "      lm::mbar_arrive(full + 8 * s);\n      return;\n    }\n", 1)],
    "wrong: no dV, dK products": [
        ("    issue_acc(j);\n", "    if (L < 0) issue_acc(j);\n", 1)],
    "wrong: no S^T, dP^T products": [
        ("    issue_t(j);\n", "    if (L < 0) issue_t(j);\n", 1)],
    "wrong: no dQ products": [
        ("    issue_dq(j - 1);\n", "    if (L < 0) issue_dq(j - 1);\n", 1),
        ("  issue_dq(n_tiles - 1);\n", "  if (L < 0) issue_dq(n_tiles - 1);\n",
         1)],
    "exp2f for the SFU's ex2.approx": [(
        '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "  y = exp2f(x);", 1)],
    "heads fastest in the grid": [
        ("  const int bh = blockIdx.y;\n  const int q0 = (gridDim.x - 1 - "
         "blockIdx.x) * kRows;",
         "  const int bh = blockIdx.x;\n  const int q0 = (gridDim.y - 1 - "
         "blockIdx.y) * kRows;", 1),
        ("  const int bh = blockIdx.y;\n  const int k0 = blockIdx.x * kKeys;",
         "  const int bh = blockIdx.x;\n  const int k0 = blockIdx.y * kKeys;",
         1),
        ("  const dim3 grid((L + kRows - 1) / kRows, bh);  // heads outermost",
         "  const dim3 grid(bh, (L + kRows - 1) / kRows);", 1)],
}
# (name, BH, L, D, tile, window), causal
SHAPES = [("gemma3-12b train, causal", 32, 2048, 256, 1024, 0),
          ("gemma3-12b train, window 1,024", 32, 2048, 256, 1024, 1024),
          ("deepseek-v3 train (MLA, D 192)", 256, 2048, 192, 1024, 0)]


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
        fn = ctypes.CDLL(str(so)).flash_attention_bwd_launch
        fn.argtypes = _build.SIGNATURES["flash_attention"][
            "flash_attention_bwd_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_ablate: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = _build.BUILD_DIR / "ablate_flash_bwd"
    out.mkdir(parents=True, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda", 0)
    order = list(fns) + list(fns)[::-1]
    for shape, bh, l, d, t, w in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn((bh, l, d), generator=g, device=dev)
                       .bfloat16() for _ in range(4))
        o, lse = pfa._forward(q, k, v, True, t, t, w, dev, True)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        dsum = torch.empty(4 * bh * -(-l // 64) * 64, dtype=torch.float32,
                           device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: [] for name in fns}

        def launcher(name):
            def go():
                rc = fns[name](1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               dsum.data_ptr(), bh, l, d, 1, t, t, w,
                               d ** -0.5, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            return go
        for name in order * 2:
            go = launcher(name)
            go()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(10):
                go()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / 10)
        split = cs.kernel_device_ms(launcher("all"), 10)
        base = min(times["all"])
        print(f"{shape} (BH {bh} x L {l} x D {d}, tile {t}, window {w}): "
              f"the committed build's device time by kernel "
              + ("not measured" if split is None else ", ".join(
                  f"{k} {v:.4f} ms" for k, (v, _) in split.items()))
              + "; " + "; ".join(f"{name} {min(x):.4f} ms "
                                 f"({min(x) - base:+.4f})"
                                 for name, x in times.items()), flush=True)
        del q, k, v, do, o, lse, dq, dk, dv, dsum
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
