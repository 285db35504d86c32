"""Registry of the architectures the port serves (``--arch <id>``) and
their smoke variants.

A copy of the reference's registry, every family of it: `hybrid`
(Zamba2), `dense` (Qwen2, Qwen2.5, Minitron; Gemma3, the dense family
with 5:1 local:global attention), `ssm` (Mamba2), `moe` (Qwen2-MoE;
DeepSeek-V3, with multi-head latent attention and multi-token
prediction), `vlm` (LLaVA-NeXT, image patches prepended to the tokens)
and `audio` (Whisper, the encoder-decoder).
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
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
