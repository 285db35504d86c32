"""What the sweep kernel's time goes to, and how else it could be laid out.

Builds variants of `src/repro_torch/kernels/csrc/carbon_sweep.cu`, each
the committed source with the text edits listed in VARIANTS below (each
edited text must occur in the source exactly once, so a variant fails
loudly when the kernel changes under it), all `nvcc` runs started
together, into the git-ignored `build/kernels/layouts/`:

- `kept`: the committed kernel, 256 threads a cell at the main tile;
- `128 threads`, `64 threads`, `32 threads`: narrower blocks, one cell
  each (a warp a cell at 32);
- `register champions`: each thread's per-candidate counts and champion
  draws in registers (an unrolled select per candidate a draw, at most
  9 candidates) instead of its shared-memory columns;
- `match_any bins`: a warp adds its equal histogram bins once
  (`__match_any_sync`, one leader add per group) instead of one shared
  atomic a draw;
- `no champions`, `no argmin` (only candidate 0 evaluated), `no bins`
  (no log10 bin and no atomic a draw), `none of the three`: ablations,
  which compute something else and are timed only.

It runs each build through the port's own wrappers:

1. the main path's tile (1,024 cells x 4,096 draws x 9 candidates,
   float32) through build (a), `sweep_tile`, and build (b),
   `sweep_tile_drawn` without best_core (as the sweep runs it), each
   timed in rounds with CUDA events; every variant that computes the
   kernel's function is held exactly against `kept` but the per-cell
   sums, which follow the block's order (relative 2 (N - 1) u);
2. the main sweep (`chip_smoke.main_sweep_spec()`, 15,840 cells) through
   `run_sweep` with each of those variants in turns, its wall clock,
   every field equal to the first run's but the means (relative
   2 (N + 1) u).

Run it on a machine with a CUDA card, from the repository's root:

    python3 scripts/sweep_layouts.py

It prints the card's name and power limit first; every time is in ms.
"""
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ and tests/ on the path)

_TAKE = "    champs.take(bc, bo, d);\n"
_BIN = "    if (bin >= 0) atomicAdd(&s_hist[bin], 1);\n"
_ARGMIN = "csweep::argmin_draw(s_emb, s_base, life, fr, C, &bt, &bo);"
_REG_CHAMPS = """\
template <typename T, int kC>
struct RegChamps {
  T op[kC];
  int32_t dr[kC], n[kC];
  __device__ __forceinline__ void init(int C) {
    if (C > kC) __trap();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      op[c] = inf_of<T>();
      dr[c] = csweep::kIMax;
      n[c] = 0;
    }
  }
  __device__ __forceinline__ void take(int32_t bc, T bo, int32_t d) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c == bc) {
        ++n[c];
        if (csweep::champion_takes(bo, d, op[c], dr[c])) {
          op[c] = bo;
          dr[c] = d;
        }
      }
  }
  __device__ __forceinline__ void get(int c, T& o, int32_t& d,
                                      int32_t& m) const {
    o = op[0];
    d = dr[0];
    m = n[0];
#pragma unroll
    for (int j = 1; j < kC; ++j)
      if (j == c) {
        o = op[j];
        d = dr[j];
        m = n[j];
      }
  }
};

"""
_SHFL = "template <typename T>\n__device__ __forceinline__ T shfl_xor"
_MATCH = """\
    {
      const unsigned peers = __match_any_sync(__activemask(), bin);
      if (bin >= 0 && (tid & 31) == __ffs(peers) - 1)
        atomicAdd(&s_hist[bin], __popc(peers));
    }
"""


def _block(n):
    return [("constexpr int kMaxBlock = 256;",
             f"constexpr int kMaxBlock = {n};")]


# variant -> [(text of carbon_sweep.cu, its replacement)]; the first
# EXACT variants compute the kernel's function, the rest are ablations
VARIANTS = {
    "kept": [],
    "128 threads": _block(128),
    "64 threads": _block(64),
    "32 threads": _block(32),
    "register champions": [
        (_SHFL, _REG_CHAMPS + _SHFL),
        ("  const Columns<T> champs{c_op, c_dr, c_cnt, bd, tid};",
         "  RegChamps<T, 9> champs;")],
    "match_any bins": [(_BIN, _MATCH)],
    "no champions": [(_TAKE, "")],
    "no argmin": [(_ARGMIN, _ARGMIN.replace(", C, ", ", 1, "))],
    "no bins": [(_BIN, "")],
    "none of the three": [(_TAKE, ""), (_BIN, ""),
                          (_ARGMIN, _ARGMIN.replace(", C, ", ", 1, "))],
}
EXACT = 6


def build(out_dir):
    """{variant: loaded library}, every nvcc started together."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "carbon_sweep.cu").read_text()
    procs = {}
    for k, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            n = text.count(old)
            if n != 1:
                raise RuntimeError(f"variant {k}: {old!r} occurs {n} times "
                                   f"in carbon_sweep.cu")
            text = text.replace(old, new)
        d = os.path.join(out_dir, k.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        cu, so = os.path.join(d, "carbon_sweep.cu"), \
            os.path.join(d, "libcarbon_sweep.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", so, cu]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    so)
    libs = {}
    for k, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {k}:\n{log}")
        for kern, regs, smem, st, ld in cs.ptxas_report(log):
            if "cells" in kern:
                cs.log(f"[build] {k}: {kern}: {regs} registers, spill "
                       f"stores {st} / loads {ld} bytes")
        lib = ctypes.CDLL(so)
        for sym, argtypes in _build.SIGNATURES["carbon_sweep"].items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        libs[k] = lib
    return libs


def use(lib):
    """Make the wrappers launch `lib`'s kernels."""
    from repro_torch.kernels import _build
    _build._loaded["carbon_sweep"] = lib


def same_tile(want, got, n_draws, what):
    """Two numpy (TileOut, SweepAcc): exact but the per-cell sums."""
    import numpy as np
    import _torch_parity as tp
    tp.assert_tiles_equal(want[0], got[0], n_draws, np.float32, what)
    for a, b in zip(want[1], got[1]):
        np.testing.assert_array_equal(a, b, err_msg=what)


def tiles(libs, dev, rounds=3):
    import numpy as np
    import torch
    import _torch_parity as tp
    from repro_torch import convert
    from repro_torch.kernels import carbon_sweep as csk
    TC, N, C = 1024, 4096, 9
    fresh = lambda: csk.init_acc(64, 32, torch.float32, dev)  # noqa: E731
    case = tp.tile_inputs(np.random.default_rng(8), TC, N, C, np.float32,
                          inf_cells=2, invalid_frac=0.05)
    a_args = [torch.from_numpy(case[k]).to(dev) for k in tp.TILE_ORDER]
    case = tp.drawn_tile_inputs(np.random.default_rng(10), TC, N, C,
                                np.float32, invalid_frac=0.05)
    b_args = [torch.from_numpy(case[k]).to(dev) for k in tp.DRAWN_ORDER]
    kw = dict(tp.TILE_KW, n_draws=N, day_s=tp.DAY_S)

    def run_a(acc):
        return csk.sweep_tile(*a_args, acc, device=dev, **tp.TILE_KW)

    def run_b(acc, best_core=True):
        return csk.sweep_tile_drawn(case["key"], *b_args, acc,
                                    best_core=best_core, device=dev, **kw)

    def host(r):
        out, acc = r
        return (csk.TileOut(*(x.cpu().numpy() for x in out)),
                convert.sweep_acc_to_numpy(acc))
    names = tuple(VARIANTS)
    want = {}
    times = {(b, k): [] for b in "ab" for k in names}
    for _ in range(rounds):
        for i, k in enumerate(names):
            use(libs[k])
            if i < EXACT:
                for b, fn in (("a", run_a), ("b", run_b)):
                    got = host(fn(fresh()))
                    if b in want:
                        same_tile(want[b], got, N, f"({b}) variant {k}")
                    else:
                        want[b] = got
            else:                                 # ablations: warm-up only
                run_a(fresh())
                run_b(fresh())
            acc = fresh()
            times[("a", k)].append(cs.queued_ms(lambda: run_a(acc), 10))
            times[("b", k)].append(cs.queued_ms(
                lambda: run_b(acc, best_core=False), 10))
    for b in "ab":
        cs.log(f"[tile] ({b}) {TC} cells x {N} draws x {C}, float32 (the "
               f"first {EXACT} equal but the sums): " + "; ".join(
                   f"{k} {statistics.median(times[(b, k)]):.4f}"
                   f" (runs {', '.join(f'{x:.4f}' for x in times[(b, k)])})"
                   for k in names))


def main_sweep(libs, dev):
    import numpy as np
    import _torch_parity as tp
    from repro_torch.core import sweep as sw
    spec = cs.main_sweep_spec()
    sw.run_sweep(spec, tile_cells=1024, device=dev)           # warm-up
    names = tuple(VARIANTS)[:EXACT]
    walls, first = {}, None
    for k in names + names[::-1]:
        use(libs[k])
        res = sw.run_sweep(spec, tile_cells=1024, device=dev)
        walls.setdefault(k, []).append(res.wall_s * 1e3)
        if first is None:
            first = res
            continue
        for f in tp.RESULT_EXACT_FIELDS + ("hist",):
            np.testing.assert_array_equal(getattr(first, f), getattr(res, f),
                                          err_msg=f"variant {k}: {f}")
        for f in tp.PAR_FIELDS:
            np.testing.assert_array_equal(first.pareto[f], res.pareto[f],
                                          err_msg=f"{k}: pareto {f}")
        for f in tp.RESULT_SUM_FIELDS:
            tp.assert_rel_close(getattr(first, f), getattr(res, f),
                                2 * (spec.draws + 1) * 2.0 ** -24, f)
    cs.log(f"[main sweep] {spec.n_scenarios} scenarios, run_sweep wall "
           f"(ms), equal across variants but the means: " + "; ".join(
               f"{k} {statistics.median(v):.2f} (runs "
               f"{', '.join(f'{x:.2f}' for x in v)})"
               for k, v in walls.items()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_layouts: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{cs.nvidia_smi_line()}")
    libs = build(os.path.join(ROOT, "build", "kernels", "layouts"))
    tiles(libs, dev)
    main_sweep(libs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
