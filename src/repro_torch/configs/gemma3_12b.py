"""gemma3-12b: dense LM with 5:1 local:global attention [hf:google/gemma-3]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    rope_theta=1e6,
    window=1024,        # sliding window for local layers
    global_every=6,     # every 6th layer is global (5 local : 1 global)
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16, window=16,
                          global_every=3)
