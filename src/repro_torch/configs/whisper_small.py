"""whisper-small — enc-dec, conv frontend STUB [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
``input_specs()`` provides precomputed frame embeddings (B, 1500, 768); the
conv/mel frontend is a stub per the assignment. Learned absolute positions
in the reference model are replaced with RoPE on the decoder (TPU-friendly,
documented in DESIGN.md); encoder uses sinusoidal-free full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm_type="layernorm",
    mlp_act="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=12,
    num_audio_frames=1500,
)

REDUCED = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    norm_type="layernorm",
    mlp_act="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=2,
    num_audio_frames=16,
)
