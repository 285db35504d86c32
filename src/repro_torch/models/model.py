"""API of the port's models: build_model(config) -> Model with
init/loss/cache/prefill/decode functions, as the reference's
`build_model` lays them out, for every family of the reference: `dense`
(Qwen2, Qwen2.5, Minitron, Gemma3), `moe` (Qwen2-MoE, DeepSeek-V3) and
`vlm` (LLaVA-NeXT) on the decoder, `hybrid` (Zamba2), `ssm` (Mamba2)
and `audio` (Whisper, the encoder-decoder).

`Model.abstract_params`, `input_specs` and the parameter and FLOP
counts are the dry run's: shapes and dtypes with nothing allocated
(fake tensors, and meta tensors for the inputs)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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

    def abstract_params(self, seed: int = 0, fake_mode=None):
        """The parameters module with fake tensors (shapes and dtypes,
        nothing allocated), made under `fake_mode` (a new
        `FakeTensorMode` by default): the counterpart of the reference's
        `jax.eval_shape` of `init_params`. Trainable, so a step traced
        under the same mode differentiates them."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with fake_mode or FakeTensorMode():
            return self.init_params(
                generator=torch.Generator().manual_seed(seed), device="cpu",
                trainable=True)


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


# -------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a dry-run cell.

    train: token/target batch. prefill: prompt of seq_len. decode: one new
    token + the positions scalar (cache specs come from init_cache)."""
    b, l = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dtype = TF.torch_dtype(cfg)

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "train":
        specs = {"tokens": sds((b, l), i32), "targets": sds((b, l), i32),
                 "mask": sds((b, l), torch.float32)}
        if cfg.family == "vlm":
            lt = l - cfg.n_patches
            specs["tokens"] = sds((b, lt), i32)
            specs["targets"] = sds((b, lt), i32)
            specs["mask"] = sds((b, lt), torch.float32)
            specs["patches"] = sds((b, cfg.n_patches, cfg.d_model), dtype)
        if cfg.family == "audio":
            specs["frames"] = sds((b, cfg.n_audio_frames, cfg.d_model),
                                  dtype)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": sds((b, l), i32)}
        if cfg.family == "vlm":
            specs["tokens"] = sds((b, l - cfg.n_patches), i32)
            specs["patches"] = sds((b, cfg.n_patches, cfg.d_model), dtype)
        if cfg.family == "audio":
            specs["frames"] = sds((b, cfg.n_audio_frames, cfg.d_model),
                                  dtype)
        return specs
    # decode: one token against a cache of capacity seq_len
    return {"tokens": sds((b, 1), i32), "pos": sds((), i32)}


# -------------------------------------------------------- flops accounting

def count_params_abstract(model: Model) -> int:
    return count_params(model.abstract_params())


def active_params(cfg: ModelConfig, n_total: int) -> int:
    """Active params per token (MoE discounts inactive experts)."""
    if cfg.moe is None:
        return n_total
    m = cfg.moe
    n_moe_layers = cfg.n_layers - m.n_dense_layers
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
    return n_total - inactive


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_params: int) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (fwd) with N = active params."""
    n_act = active_params(cfg, n_params)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens
