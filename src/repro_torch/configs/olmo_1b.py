"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="layernorm_nonparam",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="olmo-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    norm_type="layernorm_nonparam",
    tie_embeddings=True,
)
