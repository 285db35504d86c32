"""Registry of the architectures the port serves (``--arch <id>``) and
their smoke variants.

A copy of the reference's registry that resolves only the families the
port has: `hybrid` (Zamba2). The reference's other architectures are
known by name and raise NotImplementedError until they are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

# the reference's other architectures, still to port
_UNPORTED = ("minitron-8b", "qwen2-1.5b", "qwen2.5-14b", "gemma3-12b",
             "qwen2-moe-a2.7b", "deepseek-v3-671b", "llava-next-34b",
             "mamba2-1.3b", "whisper-tiny")

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the port serves "
            f"{list(ARCH_IDS)} (ROADMAP.md, open item 1.13)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ARCH_IDS + _UNPORTED)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
