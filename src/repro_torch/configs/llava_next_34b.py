"""llava-next-34b: VLM backbone with anyres patch-embedding stub.

Per the assignment spec the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings which are prepended to the token
sequence. Total sequence length still equals the assigned shape's seq_len.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    n_patches=576,             # base-res anyres tile (stub frontend)
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_ff=128, vocab=256, head_dim=16, n_patches=8)
