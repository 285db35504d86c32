"""Where the bfloat16 flash forward (`flash_fwd_wgmma`) spends its time:
copies of `csrc/flash_attention.cu` with one part of the kernel changed
or switched off by a text edit (an edit whose text is not found as often
as listed stops the script), built side by side with nvcc into
`build/kernels/ablate_flash/` and launched through
`flash_attention_launch`. Shapes, all causal but Whisper's: the narrow
builds (D <= 128) at LLaVA-NeXT-34B's first layer (BH 8 x 56 = 448, L
2,048, D 128, tile 1,024), Qwen2-MoE-A2.7B's (BH 8 x 16 = 128, L 4,096,
D 128, tile 1,024), Whisper-tiny's encoder (BH 64 x 6 = 384, L 1,500, D
64, non-causal, one tile), Qwen2.5-14B's first layer (BH 8 x 40 = 320, L
512, D 128) and Zamba2-7B's serve (BH 8 x 32 = 256, L 512, D 112); the
wide ones (`--wide`) at Gemma3-12B's serve (BH 8 x 16 = 128, L 4,096, D
256, tile 1,024; causal and window 1,024) and DeepSeek-V3's first MLA
layer (BH 8 x 128 = 1,024, L 4,096, D 192, causal). Variants marked
"wrong" compute wrong outputs: only their times mean anything. Each time
is the least of four rounds (every variant in turn, then in reverse,
twice) of the mean of 10 launches by CUDA events, in one process on one
card. Needs a CUDA card:

    python3 scripts/flash_wgmma_ablate.py [--wide]
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

BOUNDS = "__launch_bounds__(kWgThreads, 1)\n    flash_fwd_wgmma("
# name -> [(text, replacement, times found)]; a guard reads a launch
# argument, so the compiler keeps the code it skips
VARIANTS = {
    "all": [],
    "two blocks an SM at D 64": [
        (BOUNDS, BOUNDS.replace("1)", "D <= 64 ? 2 : 1)"), 1)],
    "two blocks an SM at D <= 128": [
        (BOUNDS, BOUNDS.replace("1)", "D <= 128 ? 2 : 1)"), 1)],
    "a ring of 3 slots at D <= 128": [
        ("      D <= 128 ? 2\n", "      D <= 128 ? 3\n", 1)],
    "rings as deep as 227 KB allows at D <= 128 (13 slots at D 64, 6 at "
    "128)": [("      D <= 128 ? 2\n", "      D <= 0 ? 2\n", 1)],
    "turns at D <= 128": [
        ("  constexpr bool kTurns = D > 128;",
         "  constexpr bool kTurns = true;", 1)],
    "no turns at any D": [
        ("  constexpr bool kTurns = D > 128;",
         "  constexpr bool kTurns = false;", 1)],
    "wrong: exponentials replaced by a scale": [(
        "        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale_log2, -b_lo));\n"
        "        sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], scale_log2, "
        "-b_hi));",
        "        sc[4 * n + e] = fmaf(sc[4 * n + e], scale_log2, -b_lo);\n"
        "        sc[4 * n + 2 + e] = fmaf(sc[4 * n + 2 + e], scale_log2, "
        "-b_hi);", 1)],
    "wrong: no S products": [(
        "    static_for<KS>([&](auto step) {  // 32 bytes a k-step within a "
        "box",
        "    static_for<0>([&](auto step) {", 1)],
    "wrong: no P v products": [(
        "    static_for<4>([&](auto step) {  // 16 rows of 128 bytes a "
        "k-step",
        "    static_for<0>([&](auto step) {", 1)],
    "wrong: S scaled, no softmax": [(
        "  auto softmax = [&](int j) {\n    const int k0 = kbeg + j * kKeys;",
        "  auto softmax = [&](int j) {\n    if (L > 0) {\n      c_lo = c_hi = "
        "1.f;\n#pragma unroll\n      for (int i = 0; i < 32; ++i) sc[i] "
        "*= scale_log2;\n      return;\n    }\n    const int k0 = kbeg + j * "
        "kKeys;", 1)],
    "wrong: k and v loaded once (no refills)": [(
        "    const int s = j % S;\n    // after both warpgroups' wgmma reads "
        "of the slot (their waits, then\n    // the release counts) and "
        "before TMA's writes\n",
        "    const int s = j % S;\n    if (j >= S && L > 0) {\n"
        "      lm::mbar_arrive(full + 8 * s);\n      return;\n    }\n", 1)],
}
# (name, BH, L, D, tile, window, causal)
NARROW = [("llava-next-34b layer 0", 448, 2048, 128, 1024, 0, True),
          ("qwen2-moe-a2.7b layer 0", 128, 4096, 128, 1024, 0, True),
          ("whisper-tiny encoder", 384, 1500, 64, 1500, 0, False),
          ("qwen2.5-14b layer 0", 320, 512, 128, 512, 0, True),
          ("zamba2-7b serve", 256, 512, 112, 512, 0, True)]
WIDE = [("gemma3-12b serve, causal", 128, 4096, 256, 1024, 0, True),
        ("gemma3-12b serve, window 1,024", 128, 4096, 256, 1024, 1024, True),
        ("deepseek-v3 mla layer 0", 1024, 4096, 192, 1024, 0, True)]


def sources() -> dict:
    """{variant: its copy of the source}; raises where an edit's text is
    not found as often as listed."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
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
                ln for ln in log.splitlines() if "fatal" in ln)[:600],
                flush=True)
            continue
        print(f"{name}: ptxas " + "; ".join(
            f"{k} {regs} registers, spills {st}/{ld} bytes"
            for k, regs, _, st, ld in cs.ptxas_report(log)
            if k.startswith("flash_fwd_wgmma")), flush=True)
        for ln in log.splitlines():     # wgmma serialised by ptxas
            if "Performance Loss" in ln:
                print(f"{name}: {ln.strip()[:400]}", flush=True)
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
    for shape, bh, l, d, t, w, causal in (
            WIDE if "--wide" in sys.argv[1:] else NARROW):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((bh, l, d), generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        if d % 8:       # the wrapper's contract: rows of a multiple of 8
            q, k, v = (torch.nn.functional.pad(x, (0, 8 - d % 8))
                       for x in (q, k, v))
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: [] for name in fns}
        for name in order * 2:
            def go():
                rc = fns[name](1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), 0, bh, l, q.shape[-1],
                               int(causal), t, t, w, d ** -0.5, stream)
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
        print(f"{shape} (BH {bh} x L {l} x D {d}, tile {t}, window {w}, "
              f"{'causal' if causal else 'non-causal'}): "
              + "; ".join(f"{name} {min(x):.4f} ms ({min(x) - base:+.4f})"
                          for name, x in times.items()), flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
