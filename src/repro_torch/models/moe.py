"""Routed mixture-of-experts with capacity-based dispatch (port of
``repro.models.moe``'s dense dispatch).

Each (token, slot) gets its position within its expert by arrival order
(a cumsum over one-hot routes); slots past the capacity are dropped, and
the kept ones scatter into an (E, C, d) expert buffer. The
expert-parallel variant (``apply_moe_ep``) waits for ROADMAP queue 1's
collectives item.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, mlp_specs, silu
from repro_torch.models.params import p


def moe_specs(cfg: ModelConfig, stack: tuple = ()):
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    E, d, f = cfg.num_experts + cfg.expert_pad, cfg.d_model, cfg.moe_d_ff
    out = {
        "router": p(stack + (d, cfg.num_experts), axes + ("embed", None)),
        "w_gate": p(stack + (E, d, f), axes + ("experts", "embed", "mlp")),
        "w_up": p(stack + (E, d, f), axes + ("experts", "embed", "mlp")),
        "w_out": p(stack + (E, f, d), axes + ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts > 0:
        # shared experts are dense and always-on; merged into one MLP of
        # width d_ff
        out["shared"] = mlp_specs(cfg, stack, d_ff=cfg.d_ff)
    return out


def capacity_for(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * num_tokens * cfg.num_experts_per_tok
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def apply_moe(x: torch.Tensor, prm, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux_loss). Top-k capacity-routed experts plus
    the shared MLP."""
    B, S, d = x.shape
    E, k = cfg.num_experts + cfg.expert_pad, cfg.num_experts_per_tok
    T = B * S
    xt = x.reshape(T, d)
    C = capacity_for(cfg, T)

    logits = xt.float() @ prm["router"].float()  # fp32 accumulation
    probs = torch.softmax(logits, dim=-1)  # (T, E) fp32
    topk_p, topk_i = torch.topk(probs, k, dim=-1)  # (T, k)
    if k > 1:
        topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, slot) within its expert, by arrival order
    flat_e = topk_i.reshape(T * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)  # (T*k, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1  # (T*k,)
    keep = pos < C  # selection bitmap over routed slots (capacity mask)
    pos_c = torch.where(keep, pos, 0)

    # dispatch: every kept slot owns its (expert, position); the dropped
    # ones add zeros at position 0, so the accumulating put is exact
    x_rep = torch.repeat_interleave(xt, k, dim=0)  # (T*k, d)
    x_disp = torch.where(keep[:, None], x_rep, 0)
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, pos_c), x_disp, accumulate=True)

    # expert FFN (SwiGLU), batched over experts
    g = silu(torch.einsum("ecd,edf->ecf", buf, prm["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", buf, prm["w_up"])
    h = torch.einsum("ecf,efd->ecd", g * u, prm["w_out"])  # (E, C, d)

    # combine: gather back, weight by gate prob, drop over-capacity slots
    y_slots = h[flat_e, pos_c]  # (T*k, d)
    gates = (topk_p.reshape(T * k) * keep).to(x.dtype)
    y = (y_slots * gates[:, None]).reshape(T, k, d).sum(dim=1)

    # Switch-style load-balance auxiliary loss (over real experts only)
    E_real = cfg.num_experts
    frac_tokens = F.one_hot(topk_i[:, 0], E_real).float().mean(dim=0)
    mean_probs = probs.mean(dim=0)
    aux = E_real * torch.sum(frac_tokens * mean_probs)

    if cfg.num_shared_experts > 0:
        y = y + apply_mlp(xt, prm["shared"], cfg)
    return y.reshape(B, S, d), aux
