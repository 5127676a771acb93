"""llava-next-mistral-7b — VLM, anyres tiling STUB [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The anyres vision tower is a STUB: ``input_specs()`` provides precomputed
patch embeddings (B, num_patches, patch_dim) that a learned 2-layer projector
maps into the token stream (early fusion as a prefix).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    num_patches=576,  # one anyres tile worth of CLIP patches
    patch_dim=1024,
)

REDUCED = ModelConfig(
    name="llava-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    num_patches=8,
    patch_dim=32,
)
