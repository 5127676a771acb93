"""Shared layer primitives: norms, RoPE, MLPs, embeddings (port of
``repro.models.layers``).

All norms and RoPE compute in fp32 and cast back; params live in bf16.
The reference's activation anchors (``cs``) are kept at the same sites;
they do nothing outside an ``activation_sharding`` context. ``silu`` and ``gelu_tanh`` compute as ``jax.nn.silu`` and
``jax.nn.gelu`` do in bf16: one rounding after each op of their formulas
(``F.silu`` and ``F.gelu`` round once, which moves about a third of bf16
outputs by one ulp).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constraints import cs
from repro_torch.models.params import p


# ----------------------------------------------------------------- norms
def norm_specs(cfg: ModelConfig, stack: tuple = ()):
    """Spec for one norm layer (possibly layer-stacked with leading dims)."""
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    if cfg.norm_type == "layernorm_nonparam":
        return {}  # OLMo: no learned scale/bias
    if cfg.norm_type == "layernorm":
        return {
            "scale": p(stack + (cfg.d_model,), axes + (None,), init="ones"),
            "bias": p(stack + (cfg.d_model,), axes + (None,), init="zeros"),
        }
    return {"scale": p(stack + (cfg.d_model,), axes + (None,), init="ones")}


def apply_norm(x: torch.Tensor, prm, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type in ("layernorm", "layernorm_nonparam"):
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-5)
        if len(prm):
            y = y * prm["scale"].float() + prm["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6)
        if len(prm):
            y = y * prm["scale"].float()
    return y.to(x.dtype)


def rms_norm_1d(x: torch.Tensor, scale, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with optional scale (qk_norm)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # fp32 theta made on the device (a host scalar copied over would wait
    # for the stream)
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- activations
def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), the sigmoid as 1 / (1 + exp(-x)), each op in
    ``x``'s dtype (XLA's expansion of ``jax.nn.silu``)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU (``jax.nn.gelu``'s default), each op in
    ``x``'s dtype with the constants rounded to it."""
    c = torch.full((), math.sqrt(2 / math.pi), dtype=torch.float32,
                   device=x.device).to(x.dtype)
    k = torch.full((), 0.044715, dtype=torch.float32,
                   device=x.device).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


# ----------------------------------------------------------------- mlp
def mlp_specs(cfg: ModelConfig, stack: tuple = (), d_ff: int | None = None):
    d_ff = d_ff if d_ff is not None else cfg.d_ff
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    if cfg.mlp_act == "gelu":
        return {
            "w_in": p(stack + (cfg.d_model, d_ff), axes + ("embed", "mlp")),
            "w_out": p(stack + (d_ff, cfg.d_model), axes + ("mlp", "embed")),
        }
    return {
        "w_gate": p(stack + (cfg.d_model, d_ff), axes + ("embed", "mlp")),
        "w_up": p(stack + (cfg.d_model, d_ff), axes + ("embed", "mlp")),
        "w_out": p(stack + (d_ff, cfg.d_model), axes + ("mlp", "embed")),
    }


def apply_mlp(x: torch.Tensor, prm, cfg: ModelConfig) -> torch.Tensor:
    nb = x.ndim - 1  # leading dims before the feature dim ((B,S,d) or (T,d))
    hid = ("batch",) + ("act_seq",) * (nb - 1) + ("mlp",)
    res = ("batch",) + ("act_seq",) * (nb - 1) + (None,)
    if "w_in" in prm:  # gelu: jax.nn.gelu's default is the tanh form
        h = cs(gelu_tanh(x @ prm["w_in"]), *hid)
        return cs(h @ prm["w_out"], *res)
    g = cs(silu(x @ prm["w_gate"]), *hid)
    return cs((g * cs(x @ prm["w_up"], *hid)) @ prm["w_out"], *res)


# ----------------------------------------------------------------- embeddings
def embed_specs(cfg: ModelConfig):
    out = {"embedding": p((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          scale=1.0)}
    if not cfg.tie_embeddings:
        out["lm_head"] = p((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return out


def embed_tokens(prm, tokens: torch.Tensor) -> torch.Tensor:
    x = prm["embedding"][tokens]
    return cs(x, *(("batch",) + ("act_seq",) * (tokens.ndim - 1) + (None,)))


def lm_logits(prm, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits: the bf16 operands widen to fp32 (exactly), so the
    products accumulate in fp32 as the reference's
    ``preferred_element_type=float32`` does."""
    w = prm["lm_head"] if "lm_head" in prm else prm["embedding"].T
    logits = x.float() @ w.float()
    return cs(logits, *(("batch",) + ("act_seq",) * (x.ndim - 2) + ("vocab",)))
