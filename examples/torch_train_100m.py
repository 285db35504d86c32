"""End-to-end example on the PyTorch / CUDA port: train a ~100M-param
dense LM for a few hundred steps with checkpoints, resume, and the
straggler watchdog (the reference's `examples/train_100m.py`, through
the port's `launch.train.train_loop`).

Runs on the card by default; `--device cpu` runs the plain PyTorch path
(pass --steps 30 for a quick look). The config is qwen2-1.5b's family
scaled to ~100M params. Checkpoints go to `--ckpt-dir` (default: the
repository's git-ignored `build/ckpt_100m`); a second run resumes there.

Run:  PYTHONPATH=src python examples/torch_train_100m.py --steps 300 \
          [--device cpu]
"""
import argparse
import pathlib

from repro_torch.configs.qwen2_1_5b import CONFIG
from repro_torch.launch.train import train_loop
from repro_torch.models.model import count_params

CFG_100M = CONFIG.replace(
    name="qwen2-100m",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=2,
    d_ff=2048,
    vocab=32000,
    head_dim=64,
)
CKPT_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "ckpt_100m"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    print(f"[100m] {CFG_100M.name}, {args.steps} steps, batch "
          f"{args.batch} x seq {args.seq}")
    out = train_loop(cfg=CFG_100M, steps=args.steps, batch=args.batch,
                     seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                     device=args.device)
    print(f"[100m] {count_params(out['params']) / 1e6:.1f}M params; loss "
          f"{out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}; "
          f"{len(out['flagged'])} slow steps flagged")
    return out


if __name__ == "__main__":
    main()
