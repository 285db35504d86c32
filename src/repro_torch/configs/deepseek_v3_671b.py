"""deepseek-v3-671b: MLA + 1 shared + 256 routed top-8 MoE + MTP [arXiv:2412.19437].

The config selects adafactor (factored second moment), as the
reference's does.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,            # MLA: latent cache, head count for attention
    d_ff=18432,                # dense-layer FFN width (first 3 layers)
    vocab=129280,
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        n_dense_layers=3,
        capacity_factor=1.25,
        # per-data-shard dispatch in the reference; the flat form on the
        # port's one device
        dispatch="hierarchical",
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    use_mtp=True,
    optimizer="adafactor",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                      n_dense_layers=1),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
    )
