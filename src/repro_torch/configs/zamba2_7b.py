"""zamba2-7b: Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 mamba layers; after every 6 mamba layers one of 2 alternating *shared*
attention blocks is applied (13 invocations). LoRA adapters and the
original-embedding concat of the real Zamba2 are omitted (DESIGN.md §8.5).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attn_period=6,
    n_shared_blocks=2,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        head_dim=16,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        shared_attn_period=3,
    )
