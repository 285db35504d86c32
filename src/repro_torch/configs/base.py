"""Architecture config dataclasses for the assigned model pool.

Every architecture in the pool is expressed as a single ``ModelConfig``.
Families: dense | moe | vlm | hybrid | ssm | audio.

Shapes (assigned): train_4k, prefill_32k, decode_32k, long_500k.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    n_shared: int = 0               # always-on shared experts
    d_ff_expert: int = 0            # per-expert hidden dim
    n_dense_layers: int = 0         # leading dense layers (deepseek style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3
    # 'dense_capacity' (flat scatter/gather) or 'hierarchical' (per-data-
    # shard dispatch with an explicit shard axis — §Perf levers A/B)
    dispatch: str = "dense_capacity"
    # pad experts so EP sharding divides the model axis (e.g. 60 -> 64);
    # padded experts are masked in the router. 0 = no padding.
    n_experts_padded: int = 0

    @property
    def e_padded(self) -> int:
        return self.n_experts_padded or self.n_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|vlm|hybrid|ssm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # local/global attention (gemma3): every `global_every`-th layer is global,
    # the rest use sliding window `window`.
    window: int = 0                 # 0 = full attention everywhere
    global_every: int = 0
    # MoE / MLA / SSM sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): shared attention block applied after every
    # `shared_attn_period` mamba layers, alternating between 2 shared blocks.
    shared_attn_period: int = 0
    n_shared_blocks: int = 2
    # vlm stub: number of image patch embeddings prepended to the sequence
    n_patches: int = 0
    # audio stub (whisper): encoder config
    n_enc_layers: int = 0
    n_audio_frames: int = 0
    # MTP (deepseek): extra next-next-token prediction head
    use_mtp: bool = False
    mtp_weight: float = 0.1
    # training
    optimizer: str = "adamw"        # adamw | adafactor
    remat: bool = True
    zero1: bool = False             # shard optimizer state over data axis
    # serving: weight bit-width for bit-plane/quantized serving (16|8|4)
    serve_bits: int = 16
    # attention implementation: 'chunked' (flash-style jnp) or 'plain'
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    # scan-over-layers toggle (always true for big models; smokes keep it on)
    scan_layers: bool = True
    # decode with a python loop over layers (static cache indices let XLA
    # elide the stacked-cache copies that dynamic ds/dus provoke — §Perf C3)
    decode_unroll: bool = False
    # prefill-only causal triangle skip (dynamic-trip KV loop). OFF by
    # default: the HLO-text analyzer cannot multiply unknown-trip loops, so
    # dry-run numbers with this lever under-count (EXPERIMENTS §Perf it. 7)
    prefill_triangle_skip: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k only runs on sub-quadratic archs (ssm/hybrid); see
    DESIGN.md §3."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("skip: full-attention arch (quadratic prefill at 500k); "
                       "per-spec only SSM/hybrid run long_500k")
    return True, ""
