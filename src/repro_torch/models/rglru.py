"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
(port of ``repro.models.rglru``).

Recurrent block = [linear -> causal conv1d -> RG-LRU] * [linear -> GeLU]
-> linear out. The diagonal recurrence h_t = a_t h_{t-1} + b_t runs as a
log-depth scan in fp32 (``linear_scan``: ceil(log2 T) shifted
multiply-adds, where the reference calls ``lax.associative_scan``). The
additions come in another order than XLA's tree; fp32 keeps that within
the model tests' tolerance.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constraints import cs
from repro_torch.models.layers import gelu_tanh
from repro_torch.models.params import p
from repro_torch.models.ssm import conv_window, shift_sum_conv

_C = 8.0  # Griffin's fixed temperature


def rglru_specs(cfg: ModelConfig, stack: tuple = ()):
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    d, w, W = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        "w_in": p(stack + (d, w), axes + ("embed", "inner")),
        "w_gate_in": p(stack + (d, w), axes + ("embed", "inner")),
        "conv": p(stack + (W, w), axes + (None, "inner"), scale=0.5),
        "w_a": p(stack + (w, w), axes + ("inner", "inner2")),
        "b_a": p(stack + (w,), axes + ("inner",), init="zeros"),
        "w_i": p(stack + (w, w), axes + ("inner", "inner2")),
        "b_i": p(stack + (w,), axes + ("inner",), init="zeros"),
        "lam": p(stack + (w,), axes + ("inner",), dtype=torch.float32,
                 init="ones"),
        "w_out": p(stack + (w, d), axes + ("inner", "embed")),
    }


def _gates(u: torch.Tensor, prm):
    r = torch.sigmoid((u @ prm["w_a"]).float() + prm["b_a"].float())
    i = torch.sigmoid((u @ prm["w_i"]).float() + prm["b_i"].float())
    log_a = -_C * r * F.softplus(-prm["lam"])  # (B,T,w) fp32, <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * u.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the inclusive
    scan of the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2,
    b2 + a2 b1), by doubling strides (Hillis-Steele), ceil(log2 T) steps."""
    T, d = a.shape[1], 1
    while d < T:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < T:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(x: torch.Tensor, prm, cfg: ModelConfig,
                  init_state: Optional[torch.Tensor] = None):
    """x: (B, T, d_model) -> (y, final state (B, w) fp32)."""
    u = cs(x @ prm["w_in"], "batch", "act_seq", "inner")
    u = shift_sum_conv(u, prm["conv"])  # no activation
    a, b = _gates(u, prm)
    if init_state is not None:
        # the carried state folds in as a virtual step 0:
        # b_0' = b_0 + a_0 * h_in
        b = torch.cat([b[:, :1] + a[:, :1] * init_state.float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    gate = gelu_tanh(x @ prm["w_gate_in"])
    y = h.to(x.dtype) * gate
    return y @ prm["w_out"], h[:, -1]


def rglru_decode_step(x: torch.Tensor, prm, cfg: ModelConfig, cache: dict):
    """x: (B, 1, d); cache: {h: (B, w) fp32, conv: (B, W-1, w)}."""
    u = x @ prm["w_in"]  # (B,1,w)
    uc, conv = conv_window(cache["conv"], u, prm["conv"])
    a, b = _gates(uc[:, None], prm)
    h = a[:, 0] * cache["h"] + b[:, 0]  # (B,w)
    gate = gelu_tanh(x @ prm["w_gate_in"])
    y = h[:, None].to(x.dtype) * gate
    return y @ prm["w_out"], {"h": h, "conv": conv}


def rglru_cache_specs(cfg: ModelConfig, batch: int, stack: tuple = ()):
    ax = tuple(["layers"] * len(stack))
    w, W = cfg.lru_width, cfg.conv_width
    return {
        "h": p(stack + (batch, w), ax + ("batch", "inner"),
               dtype=torch.float32, init="zeros"),
        "conv": p(stack + (batch, W - 1, w), ax + ("batch", None, "inner"),
                  init="zeros"),
    }
