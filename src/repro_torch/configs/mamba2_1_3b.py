"""mamba2-1.3b: attention-free SSD (state-space duality) LM [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=0,                     # no FFN; mamba block contains the mixing MLP
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    )
