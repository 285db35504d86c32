"""Where the bfloat16 flash backward (`flash_bwd_dq_wgmma` then
`flash_bwd_dkdv_wgmma`) spends its time: copies of
`csrc/flash_attention.cu` with one part of a kernel changed or switched
off by a text edit (an edit whose text is not found as often as listed
stops the script; a copy nvcc refuses is left out, with its reason),
built side by side with nvcc into `build/kernels/ablate_flash_bwd/`
(each copy's registers and spills printed) and launched through
`flash_attention_bwd_launch`, given the committed forward's output and
log-sum-exp. Shapes: the narrow builds (D <= 128) at Qwen2-1.5B's
training shape (BH 8 x 12 = 96, L 512, D 128, causal, tile 512),
Qwen2-MoE-A2.7B's (BH 2 x 16 = 32, L 2,048, D 128, causal, tile 1,024),
Zamba2-7B's (BH 8 x 32 = 256, L 512, D 112, causal, tile 512) and
Whisper-tiny's encoder at 64 requests (BH 64 x 6 = 384, L 1,500, D 64,
non-causal, one tile); the wide ones (`--wide`) at Gemma3-12B's training
shape (BH 2 x 16 = 32, L 2,048, D 256, tile 1,024; causal and window
1,024) and DeepSeek-V3's (BH 2 x 128 = 256, L 2,048, D 192, causal,
tile 1,024). Variants marked "wrong" compute wrong gradients: only their
times mean anything. Each time is the least of four rounds (every
variant in turn, then in reverse, twice) of the mean of 10 launches by
CUDA events, in one process on one card; the committed build's two
kernels are also split by their device time (torch.profiler). Needs a
CUDA card:

    python3 scripts/flash_bwd_ablate.py [--wide]
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

DQ = "__launch_bounds__(kWgThreads, 1)\n    flash_bwd_dq_wgmma("
KV = "__launch_bounds__(kWgThreads, 1)\n    flash_bwd_dkdv_wgmma("
RING_DQ = "      kNarrow ? 2 : (kMax - 2 * kQBytes) / (2 * kTileBytes);"
RING_KV = "      kNarrow ? 4\n              : (kMax - 2 * kKBytes"
ROLES = "  static constexpr int kKvKeys = kNarrow ? 128 : 64;"
ANCHOR = "// f(std::integral_constant<int, I>()) for I = 0 .. N - 1, unrolled at"
# two floats as bfloat16, truncated: what the conversions cost
PACK_CUT = """__device__ __forceinline__ uint32_t pack_cut(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
"""
DQ_PACK = ("        da[kk][h] = lm::pack_bf16x2(s[8 * kk + 2 * h], s[8 * kk + 2 * h "
           "+ 1]);")
PT_PACK = ("          pa[kk][h] = lm::pack_bf16x2(sc[8 * kk + 2 * h],\n"
           "                                      sc[8 * kk + 2 * h + 1]);")
DST_PACK = ("          da[kk][h] = lm::pack_bf16x2(dp[8 * kk + 2 * h],\n"
            "                                      dp[8 * kk + 2 * h + 1]);")


# name -> [(text, replacement, times found)]; a guard reads a launch
# argument, so the compiler keeps the code it skips
VARIANTS = {
    "all": [],
    "dQ: 64 rows a block, the warpgroups splitting each tile's keys "
    "(the wide builds' design)": [
        ("  static constexpr int kDqRows = kNarrow ? 128 : 64;",
         "  static constexpr int kDqRows = 64;", 1)],
    "dK/dV: 64 keys a block, the warpgroups split by role (the wide "
    "builds' design)": [(ROLES, ROLES.replace("kNarrow ? 128 : 64", "64"), 1)],
    "dK/dV: the role split, a ring of 3": [
        (ROLES, ROLES.replace("kNarrow ? 128 : 64", "64"), 1),
        (RING_KV, RING_KV.replace("? 4", "? 3"), 1)],
    "dK/dV: a ring of 2 at D <= 128": [
        (RING_KV, RING_KV.replace("? 4", "? 2"), 1)],
    "dK/dV: a ring of 3 at D <= 128": [
        (RING_KV, RING_KV.replace("? 4", "? 3"), 1)],
    "dQ: rings a slot deeper at D <= 128 (k 4, v 3)": [
        (RING_DQ, RING_DQ.replace("? 2", "? 3"), 1)],
    "wrong: packs truncated (P, dS, P^T, dS^T)": [
        (ANCHOR, PACK_CUT + ANCHOR, 1)] + [
        (t, t.replace("lm::pack_bf16x2(", "pack_cut("), 1)
        for t in (DQ_PACK, PT_PACK, DST_PACK)],
    "heads outermost at every shape": [
        ("      4.0 * bh * L * Dr <= kHeadsFastBytes ? 1 : 0;",
         "      L < 0 ? 1 : 0;", 1)],
    "two blocks an SM at D 64": [
        (DQ, DQ.replace("1)", "D <= 64 ? 2 : 1)"), 1),
        (KV, KV.replace("1)", "D <= 64 ? 2 : 1)"), 1)],
    "wrong: exponentials replaced by a scale": [
        ("        float p_lo = ex2(fmaf(s[4 * n + e], scale_log2, -ls_lo));\n"
         "        float p_hi = ex2(fmaf(s[4 * n + 2 + e], scale_log2, "
         "-ls_hi));",
         "        float p_lo = s[4 * n + e] * scale_log2;\n"
         "        float p_hi = s[4 * n + 2 + e] * scale_log2;", 1),
        ("          float p_lo = ex2(fmaf(sc[4 * n + e], scale_log2, -l2));\n"
         "          float p_hi = ex2(fmaf(sc[4 * n + 2 + e], scale_log2, "
         "-l2));",
         "          float p_lo = sc[4 * n + e] * scale_log2;\n"
         "          float p_hi = sc[4 * n + 2 + e] * scale_log2;", 1),
        ("            const float p_lo = ex2(fmaf(sc[4 * n + e], scale_log2, "
         "-l2));\n            const float p_hi = ex2(fmaf(sc[4 * n + 2 + e], "
         "scale_log2, -l2));",
         "            const float p_lo = sc[4 * n + e] * scale_log2;\n"
         "            const float p_hi = sc[4 * n + 2 + e] * scale_log2;", 1)],
    "wrong: P, dS not formed (dQ pass: S, dP as they come)": [
        ("  auto grads = [&](int j) {\n    const int kb = ",
         "  auto grads = [&](int j) {\n    if (L > 0) return;\n"
         "    const int kb = ", 1)],
    "wrong: P^T, dS^T not formed (dK/dV pass at D <= 128)": [
        ("    auto grads = [&](int j) {\n      const int i0 = ",
         "    auto grads = [&](int j) {\n      if (L > 0) return;\n"
         "      const int i0 = ", 1)],
    "wrong: no dS products (dQ += dS k; dK += dS^T q at D <= 128)": [
        ("      issue_dq(j - 1);\n", "      if (L < 0) issue_dq(j - 1);\n",
         1),
        ("    issue_dq(n_tiles - 1);\n",
         "    if (L < 0) issue_dq(n_tiles - 1);\n", 1),
        ("        wgmma_rs_tb<D, kk * 2048 / 16>(acc_k, da[kk], q_b, hi);",
         "        if (L < 0) wgmma_rs_tb<D, kk * 2048 / 16>(acc_k, da[kk], "
         "q_b, hi);", 1)],
    "wrong: no dV, dK products": [
        ("        issue_acc(j - 1);\n", "        if (L < 0) issue_acc(j - 1);\n",
         1),
        ("      issue_acc(n_tiles - 1);\n",
         "      if (L < 0) issue_acc(n_tiles - 1);\n", 1),
        ("      issue_acc(j);\n", "      if (L < 0) issue_acc(j);\n", 1)],
    "wrong: no S^T, dP^T products (dK/dV pass)": [
        ("      issue_t(0);\n", "      if (L < 0) issue_t(0);\n", 1),
        ("        issue_t(j);\n", "        if (L < 0) issue_t(j);\n", 1),
        ("      issue_t(j);\n", "      if (L < 0) issue_t(j);\n", 1)],
    "wrong: no S, dP products (dQ pass)": [
        ("    issue_sdp(0);\n", "    if (L < 0) issue_sdp(0);\n", 1),
        ("      issue_sdp(j);\n", "      if (L < 0) issue_sdp(j);\n", 1)],
    "wrong: no wait for P^T (the role split)": [
        ("      if (c == 1) lm::bar_arrive(kPEmpty, 256);", "      ;", 1),
        ("        lm::bar_sync(kPEmpty, 256);", "        ;", 1),
        ("        lm::bar_arrive(kPFull, 256);", "        ;", 1),
        ("        lm::bar_sync(kPFull, 256);", "        ;", 1),
        ("        if (j + 1 < n_tiles) lm::bar_arrive(kPEmpty, 256);",
         "        ;", 1)],
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
    "exp2f for the SFU's ex2.approx": [(
        '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
        "  y = exp2f(x);", 1)],
    "heads fastest at every shape": [
        ("      4.0 * bh * L * Dr <= kHeadsFastBytes ? 1 : 0;",
         "      L > 0 ? 1 : 0;", 1)],
}
# (name, BH, L, D, tile, window, causal)
NARROW = [("qwen2-1.5b train", 96, 512, 128, 512, 0, True),
          ("qwen2-moe-a2.7b train", 32, 2048, 128, 1024, 0, True),
          ("zamba2-7b train", 256, 512, 112, 512, 0, True),
          ("whisper-tiny encoder, 64 requests", 384, 1500, 64, 1500, 0,
           False)]
WIDE = [("gemma3-12b train, causal", 32, 2048, 256, 1024, 0, True),
        ("gemma3-12b train, window 1,024", 32, 2048, 256, 1024, 1024, True),
        ("deepseek-v3 train (MLA, D 192)", 256, 2048, 192, 1024, 0, True)]


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
    import chip_smoke as cs
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
            if k.startswith("flash_bwd_") and "wgmma" in k), flush=True)
        for ln in log.splitlines():     # wgmma serialised by ptxas
            if "Performance Loss" in ln:
                print(f"{name}: {ln.strip()[:400]}", flush=True)
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
    for shape, bh, l, d, t, w, causal in (
            WIDE if "--wide" in sys.argv[1:] else NARROW):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn((bh, l, d), generator=g, device=dev)
                       .bfloat16() for _ in range(4))
        o, lse = pfa._forward(q, k, v, causal, t, t, w, dev, True)
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
                               dsum.data_ptr(), bh, l, d,
                               int(causal), t, t, w,
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
        print(f"{shape} (BH {bh} x L {l} x D {d}, tile {t}, window {w}, "
              f"{'causal' if causal else 'non-causal'}): "
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
