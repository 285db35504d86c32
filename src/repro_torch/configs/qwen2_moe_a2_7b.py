"""qwen2-moe-a2.7b: 4 shared + 60 routed top-4 MoE [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # per-expert hidden dim (per the assigned spec)
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        n_shared=4,
        d_ff_expert=1408,
        n_dense_layers=0,
        capacity_factor=1.25,
        # the reference pads 60 experts to 64 so expert parallelism
        # divides its mesh (padded experts are masked in the router) and
        # dispatches per data shard; on one device the port's dispatch is
        # the flat form, which the reference's is at one shard
        n_experts_padded=64,
        dispatch="hierarchical",
    ),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
        head_dim=12,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64),
    )
