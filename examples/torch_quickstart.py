"""Quickstart on the PyTorch / CUDA port: the framework's layers in one
script, with no JAX.

1. FLEXIFLOW carbon model — pick the carbon-optimal FlexiBits core for a
   food-spoilage patch at two different deployment lifetimes (the paper's
   headline result: lifetime changes the answer).
2. FlexiBench on the ISS — run the food-spoilage workload bit-exactly on
   the port's RV32E simulator (`flexibits.iss.run`) and compare with the
   functional reference.
3. LM stack — train the qwen2-1.5b smoke config five steps from random
   parameters (`launch.train.train_loop`), then decode a few tokens with
   them (`launch.serve.generate`), as the reference's part 3 does.

Runs on the card by default; `--device cpu` runs the plain PyTorch path.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.carbon import DeviceProfile
from repro_torch.core.selection import optimal_core
from repro_torch.device import resolve
from repro_torch.flexibench.base import MONTH_S, WEEK_S, get
from repro_torch.flexibits import iss
from repro_torch.flexibits.pyiss import PyISS
from repro_torch.launch.serve import generate
from repro_torch.launch.train import train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # ------------------------------------------------------------ 1. carbon
    fs = get("FS")
    rng = np.random.default_rng(0)
    x = fs.gen_inputs(rng, 1)[0]
    sim = PyISS(fs.program.code, fs.total_mem_words,
                fs.initial_memory(x)).run()
    prof = DeviceProfile(sim.n_instr - sim.n_two_stage, sim.n_two_stage,
                         vm_kb=0.1, nvm_kb=fs.nvm_kb)
    for name, lifetime in [("meat (1 week)", WEEK_S),
                           ("rice (6 months)", 6 * MONTH_S)]:
        core, totals = optimal_core(prof, lifetime_s=lifetime,
                                    execs_per_day=24)
        print(f"[carbon] {name:16s} -> {core.name}  "
              + " ".join(f"{k}={v * 1e3:.2f}g" for k, v in totals.items()))

    # --------------------------------------------------------------- 2. ISS
    code = torch.as_tensor(np.asarray(fs.program.code).view(np.int32),
                           device=dev)
    state = iss.run(code, torch.as_tensor(fs.initial_memory(x), device=dev),
                    fs.max_steps)
    out = int(state.mem[fs.out_addr])
    want = int(fs.ref(x[None])[0])
    if out != want or int(state.n_instr) != sim.n_instr:
        raise SystemExit(f"[iss] FS gave class {out} in "
                         f"{int(state.n_instr)} instructions; the reference "
                         f"function gives {want}, PyISS {sim.n_instr}")
    mix = state.mix.cpu().tolist()
    print(f"[iss] spoilage class={out} (ref={want}) in "
          f"{int(state.n_instr)} instrs on {dev.type}, "
          f"mix={dict(zip(iss.MIX_CLASSES, mix))}")

    # ---------------------------------------------------------------- 3. LM
    cfg = get_smoke_config("qwen2-1.5b")
    out = train_loop(cfg=cfg, steps=5, batch=4, seq=64, ckpt_dir="",
                     device=dev, log=lambda *a: None)
    print(f"[lm] qwen2-1.5b smoke config, 5 train steps: loss "
          f"{out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    toks, stats = generate(cfg, batch=2, prompt_len=8, gen=8,
                           params=out["params"], device=dev,
                           log=lambda *a: None)
    print(f"[lm] generated {toks.shape} tokens "
          f"({stats['decode_s'] * 1e3:.0f}ms decode)")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
