"""Model + shape configuration for the assigned architecture pool.

Every architecture in the pool is expressed as a ``ModelConfig``: a plain
copy of ``repro.configs.base`` (the port imports nothing of ``repro``).
The full configs carry the published dims; tests use the ``REDUCED``
variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_nonparam
    mlp_act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (d_ff is the shared/dense hidden)
    capacity_factor: float = 1.25
    # §Perf: pad the expert dim with never-routed dummies so it divides the
    # TP axis (e.g. qwen2-moe 60 -> 64 on a 16-wide mesh). 0 = no padding.
    expert_pad: int = 0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # hybrid (recurrentgemma): repeating unit of block kinds + tail
    block_unit: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 0  # sliding-window size for local attention layers

    # llama4-style interleaved local(chunked)/global attention
    attn_unit: Tuple[str, ...] = ()  # e.g. ("local","local","local","global")
    attn_chunk: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_audio_frames: int = 1500

    # vlm stub frontend
    num_patches: int = 0
    patch_dim: int = 0

    # which shape cells run sub-quadratically at 500k ctx
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived ----
    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        from repro_torch.models import api

        return api.count_params(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        from repro_torch.models import api

        return api.count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    # gradient-accumulation microbatches for train (memory control)
    accum: int = 1


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256, accum=8),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason string if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention: 524k ctx skipped per spec (see DESIGN.md)"
    return True, ""
