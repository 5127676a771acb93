"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) routed d_ff=1408, shared expert hidden = 4*1408=5632,
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5632,  # shared-expert hidden (4 shared experts merged, 4*1408)
    vocab_size=151936,
    num_experts=60,
    num_experts_per_tok=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    qkv_bias=True,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen2-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    num_experts=8,
    num_experts_per_tok=2,
    num_shared_experts=2,
    moe_d_ff=48,
    qkv_bias=True,
)
