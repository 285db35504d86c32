"""API of the port's models: build_model(config) -> Model with
init/loss/cache/prefill/decode functions, as the reference's
`build_model` lays them out, for every family of the reference: `dense`
(Qwen2, Qwen2.5, Minitron, Gemma3), `moe` (Qwen2-MoE, DeepSeek-V3) and
`vlm` (LLaVA-NeXT) on the decoder, `hybrid` (Zamba2), `ssm` (Mamba2)
and `audio` (Whisper, the encoder-decoder)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as TF

@dataclasses.dataclass(frozen=True)
class Model:
    """`init_params(generator=None, device=None, trainable=False)` ->
    parameters module (frozen unless `trainable`);
    `loss_fn(params, {"tokens", "targets"[, "mask"]})` -> (loss,
    {"xent"[, "aux"][, "mtp"]}) (the MoE family's router aux loss and
    multi-token prediction loss where its config has them; the batch
    also holds "patches" (B, P, D) for the VLM family, "frames" (B, T,
    D) for the audio family);
    `init_cache(batch, seq_len, device=None)`;
    `prefill_fn(params, {"tokens": (B, L)[, "patches"][, "frames"]},
    seq_len)` -> (logits, cache);
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
    if fam in ("dense", "moe", "vlm"):
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

    elif fam == "audio":
        def init_params(generator=None, device=None, trainable=False):
            return ED.init_encdec(cfg, generator, device, trainable)

        def loss_fn(params, batch):
            return ED.encdec_loss(params, cfg, batch)

        def init_cache(batch, seq_len, device=None):
            return ED.encdec_init_cache(cfg, batch, seq_len, device)

        def prefill_fn(params, batch, seq_len):
            return ED.encdec_prefill(params, cfg, batch["frames"],
                                     batch["tokens"], seq_len)

        def decode_fn(params, cache, tokens, pos):
            return ED.encdec_decode_step(params, cfg, cache, tokens, pos)

    else:
        raise KeyError(f"unknown family {fam!r}")

    return Model(cfg, init_params, loss_fn, init_cache, prefill_fn,
                 decode_fn)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())
