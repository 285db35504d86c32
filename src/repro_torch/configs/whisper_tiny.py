"""whisper-tiny: enc-dec audio backbone, conv frontend stubbed [arXiv:2212.04356].

``input_specs()`` provides precomputed frame embeddings (B, n_frames, d_model)
in place of the conv-over-mel frontend, per the assignment spec.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    n_audio_frames=1500,
    rope_theta=0.0,             # whisper uses learned positions; we use sinusoidal
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=48, n_heads=4,
                          n_kv_heads=4, d_ff=96, vocab=256, head_dim=12,
                          n_audio_frames=16)
