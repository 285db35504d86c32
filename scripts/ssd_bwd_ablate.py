"""Where the bfloat16 SSD scan backward kernel (`ssd_bwd_mma`) spends its
time: copies of `csrc/ssd_scan.cu` with one part of the kernel switched
off by a text edit (an edit whose text is not found exactly once stops
the script), built side by side with nvcc into `build/kernels/ablate/`
and launched through `ssd_scan_bwd_launch` at Mamba2-1.3B's and
Zamba2-7B's training shapes (8 x 512 tokens) at the heads a block the
wrapper picks. The variants compute wrong gradients: only their times
mean anything, each the mean of 20 launches by CUDA events beside the
unedited build's, in one process on one card. Needs a CUDA card:

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

# name -> [(text, replacement)]: each guard reads a launch argument, so
# the compiler keeps the code it skips
VARIANTS = {
    "all": [],
    "no pairs": [(
        "      const int npair = (Q - j0 + kTile - 1) / kTile;",
        "      const int npair = L < 0 ? 1 : 0;")],
    "no row walk": [(
        "    if (ci > 0) {\n      for (int h = 0; h < nh; ++h) {",
        "    if (ci > 0 && L < 0) {\n      for (int h = 0; h < nh; ++h) {")],
    "no state terms": [(
        "      for (int h = 0; h < HM; ++h) {\n        if (h >= nh) break;\n"
        "        const float* dSh = dS + h * nn * lds;",
        "      for (int h = 0; h < HM; ++h) {\n        if (h >= nh || L > 0) "
        "break;\n        const float* dSh = dS + h * nn * lds;")],
    "no per-head pair work": [(
        "          if (h >= nh) break;\n          const bf16* Dyh = Dyi + h * "
        "kTile * ldp;\n          // dW^T = x_j dy_i^T",
        "          if (h >= nh || L > 0) break;\n          const bf16* Dyh = "
        "Dyi + h * kTile * ldp;\n          // dW^T = x_j dy_i^T")],
    "no dB, dC products": [
        ("        // dB_j += dG^T C_i (rows j, this half's n; K = i)\n"
         "#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {",
         "        // dB_j += dG^T C_i (rows j, this half's n; K = i)\n"
         "#pragma unroll\n        for (int kk = 0; kk < 4 * (L < 0); ++kk) {"),
        ("        // dC_i (rows i, this half's n) += dG B_j (K = j)\n"
         "#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {",
         "        // dC_i (rows i, this half's n) += dG B_j (K = j)\n"
         "#pragma unroll\n"
         "        for (int kk = 0; kk < 4 * (L < 0); ++kk) {")],
    "no dC partial reads and writes": [
        ("                   16 * nb0 + 8 * f, f < 2 * nbn && j0 > 0 ? Q : 0, "
         "N);",
         "                   16 * nb0 + 8 * f, 0, N);"),
        ("            put_rows(dcb + static_cast<size_t>(c0) * N, dca[f],\n"
         "                     i0 + 16 * r, 16 * nb0 + 8 * f, Q, N);",
         "            put_rows(dcb + static_cast<size_t>(c0) * N, dca[f],\n"
         "                     i0 + 16 * r, 16 * nb0 + 8 * f, Q * (L < 0), "
         "N);")],
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
        fn = ctypes.CDLL(str(so)).ssd_scan_bwd_launch
        fn.argtypes = _build.SIGNATURES["ssd_scan"]["ssd_scan_bwd_launch"]
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
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        hb = pss.bwd_mma_heads(bh, rep, p, n, q, sms)
        outs = [torch.empty_like(x), torch.empty(bh, l, device=dev),
                torch.empty(bh, device=dev),
                torch.empty(bh // rep * -(-rep // hb), l, n, device=dev)]
        outs.append(torch.empty_like(outs[-1]))
        args = [t.data_ptr() for t in (a, x, dt, b, c, dy, st, ds, *outs)]
        stream = torch.cuda.current_stream().cuda_stream
        row = {}
        for name, fn in fns.items():
            def go():
                rc = fn(1, *args, bh, l, p, n, q, rep, hb, stream)
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
