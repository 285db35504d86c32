"""qwen2-1.5b: dense GQA LM with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                          d_ff=96, vocab=256, head_dim=12)
