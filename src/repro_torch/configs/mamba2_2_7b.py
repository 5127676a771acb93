"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560, attention-free, vocab=50280, ssm_state=128, headdim 64,
expand 2 => d_inner 5120, 80 SSD heads. O(1)/token decode state => long-ctx ok.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    norm_type="rmsnorm",
    tie_embeddings=True,
    supports_long_context=True,
)

REDUCED = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_chunk=32,
    conv_width=4,
    norm_type="rmsnorm",
    tie_embeddings=True,
    supports_long_context=True,
)
