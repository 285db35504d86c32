"""API of the port's models: build_model(config) -> Model with
init/loss/cache/prefill/decode functions, as the reference's
`build_model` lays them out. The port serves the `dense` (Qwen2,
Qwen2.5, Minitron, Gemma3), `moe` (Qwen2-MoE, DeepSeek-V3), `hybrid`
(Zamba2) and `ssm` (Mamba2) families; the reference's `vlm` and `audio`
families raise NotImplementedError, naming the open item of ROADMAP.md
that ports each."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TF

_UNPORTED = {"vlm": "13e", "audio": "13e"}


@dataclasses.dataclass(frozen=True)
class Model:
    """`init_params(generator=None, device=None, trainable=False)` ->
    parameters module (frozen unless `trainable`);
    `loss_fn(params, {"tokens", "targets"[, "mask"]})` -> (loss,
    {"xent"[, "aux"][, "mtp"]}) (the MoE family's router aux loss and
    multi-token prediction loss where its config has them);
    `init_cache(batch, seq_len, device=None)`;
    `prefill_fn(params, {"tokens": (B, L)}, seq_len)` -> (logits, cache);
    `decode_fn(params, cache, tokens (B, 1), pos)` -> (logits, cache),
    the cache updated in place."""
    cfg: ModelConfig
    init_params: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill_fn: Callable
    decode_fn: Callable


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in _UNPORTED:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet: the port serves the dense, "
            f"moe, hybrid and ssm families (ROADMAP.md, open item "
            f"{_UNPORTED[fam]})")
    if fam in ("dense", "moe"):
        def init_params(generator=None, device=None, trainable=False):
            return TF.init_decoder(cfg, generator, device, trainable)

        def loss_fn(params, batch):
            return TF.decoder_loss(params, cfg, batch)

        def init_cache(batch, seq_len, device=None):
            return TF.init_cache(cfg, batch, seq_len, device)

        def prefill_fn(params, batch, seq_len):
            return TF.prefill(params, cfg, batch["tokens"], seq_len,
                              patches=batch.get("patches"))

        def decode_fn(params, cache, tokens, pos):
            return TF.decode_step(params, cfg, cache, tokens, pos)

    elif fam == "hybrid":
        def init_params(generator=None, device=None, trainable=False):
            return HY.init_hybrid(cfg, generator, device, trainable)

        def loss_fn(params, batch):
            return HY.hybrid_loss(params, cfg, batch)

        def init_cache(batch, seq_len, device=None):
            return HY.hybrid_init_cache(cfg, batch, seq_len, device)

        def prefill_fn(params, batch, seq_len):
            return HY.hybrid_prefill(params, cfg, batch["tokens"], seq_len)

        def decode_fn(params, cache, tokens, pos):
            return HY.hybrid_decode_step(params, cfg, cache, tokens, pos)

    elif fam == "ssm":
        def init_params(generator=None, device=None, trainable=False):
            return SM.init_ssm_lm(cfg, generator, device, trainable)

        def loss_fn(params, batch):
            return SM.ssm_loss(params, cfg, batch)

        def init_cache(batch, seq_len, device=None):
            return SM.ssm_init_cache(cfg, batch, seq_len, device)

        def prefill_fn(params, batch, seq_len):
            return SM.ssm_prefill(params, cfg, batch["tokens"], seq_len)

        def decode_fn(params, cache, tokens, pos):
            return SM.ssm_decode_step(params, cfg, cache, tokens, pos)

    else:
        raise KeyError(f"unknown family {fam!r}")

    return Model(cfg, init_params, loss_fn, init_cache, prefill_fn,
                 decode_fn)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())
