"""Registry of the architectures the port serves (``--arch <id>``) and
their smoke variants.

A copy of the reference's registry that resolves only the families the
port has: `hybrid` (Zamba2), `dense` (Qwen2, Qwen2.5, Minitron; Gemma3,
the dense family with 5:1 local:global attention), `ssm` (Mamba2) and
`moe` (Qwen2-MoE; DeepSeek-V3, with multi-head latent attention and
multi-token prediction). The reference's other architectures (the VLM
and audio families) are known by name and raise NotImplementedError,
naming the open item that ports them, until they are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}

# the reference's other architectures, still to port, and the open item
# of ROADMAP.md that ports each
_UNPORTED = {"llava-next-34b": "13e", "whisper-tiny": "13e"}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port serves "
            f"{list(ARCH_IDS)} (ROADMAP.md, open item {_UNPORTED[arch]})")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ARCH_IDS + tuple(_UNPORTED))}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
