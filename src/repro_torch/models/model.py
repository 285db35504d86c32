"""Serving API of the port's models: build_model(config) -> Model with
init/cache/prefill/decode functions, as the reference's `build_model`
lays them out. The port serves the `hybrid` family (Zamba2); the
reference's other families raise NotImplementedError."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as HY


@dataclasses.dataclass(frozen=True)
class Model:
    """`init_params(generator=None, device=None)` -> parameters module;
    `init_cache(batch, seq_len, device=None)`;
    `prefill_fn(params, {"tokens": (B, L)}, seq_len)` -> (logits, cache);
    `decode_fn(params, cache, tokens (B, 1), pos)` -> (logits, cache),
    the cache updated in place."""
    cfg: ModelConfig
    init_params: Callable
    init_cache: Callable
    prefill_fn: Callable
    decode_fn: Callable


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port serves the "
            f"hybrid family (ROADMAP.md, open item 1.13)")

    def init_params(generator=None, device=None):
        return HY.init_hybrid(cfg, generator, device)

    def init_cache(batch, seq_len, device=None):
        return HY.hybrid_init_cache(cfg, batch, seq_len, device)

    def prefill_fn(params, batch, seq_len):
        return HY.hybrid_prefill(params, cfg, batch["tokens"], seq_len)

    def decode_fn(params, cache, tokens, pos):
        return HY.hybrid_decode_step(params, cfg, cache, tokens, pos)

    return Model(cfg, init_params, init_cache, prefill_fn, decode_fn)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())
