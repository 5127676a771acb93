"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) per-expert d_ff=8192 vocab=202048.
Interleaved chunked-local / global attention (iRoPE-style, 3 local : 1 global),
shared expert in every MoE layer. Chunked-local layers give bounded KV at 500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,  # shared expert hidden
    vocab_size=202048,
    num_experts=16,
    num_experts_per_tok=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    attn_unit=("local", "local", "local", "global"),
    attn_chunk=8192,
    rope_theta=5e5,
    supports_long_context=True,
)

REDUCED = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=1,
    num_shared_experts=1,
    moe_d_ff=128,
    attn_unit=("local", "local", "local", "global"),
    attn_chunk=64,
    supports_long_context=True,
)
