"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 recurrent [arXiv:2402.19427].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru_width=2560,
local window 2048. Unit = (rec, rec, attn) x 8 + (rec, rec) tail.
Bounded state at any context => long-ctx ok.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_unit=("rec", "rec", "attn"),
    lru_width=2560,
    local_window=2048,
    conv_width=4,
    mlp_act="swiglu",
    tie_embeddings=True,
    supports_long_context=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,  # 1 unit (rec, rec, attn) + tail (rec, rec)
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    block_unit=("rec", "rec", "attn"),
    lru_width=64,
    local_window=32,
    conv_width=4,
    tie_embeddings=True,
    supports_long_context=True,
)
