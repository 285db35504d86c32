"""`chip_smoke.py`'s phase 22(b) cell alone: Mamba2-1.3B at full width and
depth, TRAIN_STEPS `train_loop` steps of 8 x 512 with AdamW, then one
step under torch.profiler, through `chip_smoke.train_full` (the same
checks: the parameter count, 96 `ssd_scan` and 48 `ssd_scan_bwd`
launches a step, no plain call), REPEATS times in one process, so that
two readings of the step and of its device time by layer sit side by
side.

Run it on a machine with a CUDA card, from the repository's root:

    python3 scripts/ssm_train_cell.py

It prints the card's name and power limit first; every time is in ms.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ and tests/ on the path)

REPEATS = 2


def main() -> int:
    import torch
    from repro_torch.configs.registry import get_config
    if not torch.cuda.is_available():
        print("ssm_train_cell: needs a CUDA card", file=sys.stderr)
        return 2
    cs.log(cs.nvidia_smi_line())
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the context, before the memory counters
    cfg = get_config(cs.SSM_TRAIN_ARCH)
    for rep in range(REPEATS):
        cs.log(f"--- repeat {rep}")
        cs.train_full(dev, cfg, cs.TRAIN_STEPS,
                      {cs.SSD[0]: 2 * cfg.n_layers,
                       cs.SSD_BWD[0]: cfg.n_layers,
                       cs.FLASH[0]: 0, cs.FLASH_BWD[0]: 0},
                      cs.FULL_PARAMS[cs.SSM_TRAIN_ARCH])
    return 0


if __name__ == "__main__":
    sys.exit(main())
