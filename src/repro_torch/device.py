"""Device policy of the port: the card by default, the CPU only on request.

Every entry point (`run_plan`, `run_packed`, the kernel wrappers) takes
`device=None`, and None means "cuda". Without a card that raises; it
never quietly runs the plain PyTorch path on the CPU instead. Tests and
parity runs pass `device="cpu"` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on (None -> "cuda"; a card
    without an index is the current one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_power_limit_w(index: Optional[int] = None) -> Optional[float]:
    """The card's power limit in watts, as `nvidia-smi` reports it
    (None when the tool is missing or reports nothing usable)."""
    import subprocess

    cmd = ["nvidia-smi", "--query-gpu=power.limit",
           "--format=csv,noheader,nounits"]
    if index is not None:
        cmd += ["-i", str(index)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
