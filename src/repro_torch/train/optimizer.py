"""AdamW with fp32 moments over bf16 parameters (port of
``repro.train.optimizer``).

Moments are fp32; parameters stay in their storage dtype. Each update is
computed in fp32 and rounded once to the parameter's dtype, as the
reference's is (``torch.optim.AdamW`` would update a bf16 parameter in
bf16, decay it as ``p *= 1 - lr * wd`` and clip nothing).

The parameters are a family's module (``models.api.init_params``), whose
layers are unstacked. ``OptState.m`` and ``.v`` are modules of the same
family holding fp32 zeros at first: ``apply`` pairs them with the
parameters by name, and their ``.tree()`` gives the stacked layout (what
``train.checkpoint`` writes). ``apply`` updates the parameters and
moments in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import torch
from torch import nn

from repro_torch.models import api
from repro_torch.models import params as Pm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: nn.Module
    v: nn.Module
    step: torch.Tensor  # int32 scalar: steps taken


def _zeros_like(params: nn.Module) -> nn.Module:
    specs = api.init_specs(params.cfg)
    return type(params)(params.cfg, Pm.tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=torch.float32,
                              device=params.device), specs))


def init(params: nn.Module) -> OptState:
    return OptState(m=_zeros_like(params), v=_zeros_like(params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=params.device))


def init_specs(param_specs) -> OptState:
    """ParamSpec tree of the optimizer state in the stacked layout (the
    parameters' logical axes, fp32)."""
    f32 = Pm.tree_map_specs(
        lambda s: Pm.ParamSpec(s.shape, s.axes, torch.float32, "zeros", 0.0),
        param_specs)
    step = Pm.ParamSpec((), (), torch.int32, "zeros", 0.0)
    return OptState(m=f32, v=f32, step=step)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (fp32, from the int32
    ``step``)."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _leaves(tree: Union[nn.Module, Sequence[torch.Tensor]]
            ) -> List[torch.Tensor]:
    return list(tree.parameters()) if isinstance(tree, nn.Module) \
        else list(tree)


def aligned(params: nn.Module, tree: Union[nn.Module, Sequence[torch.Tensor]]
            ) -> List[torch.Tensor]:
    """``tree``'s leaves in ``params.parameters()`` order: a module of the
    same family by parameter name (its order follows the dict it was built
    from), a list as it is."""
    if not isinstance(tree, nn.Module):
        return list(tree)
    by_name = dict(tree.named_parameters())
    return [by_name[n] for n, _ in params.named_parameters()]


def global_norm(tree) -> torch.Tensor:
    """fp32 norm over every leaf (a module's parameters, or a list)."""
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(leaf.float() ** 2)
    return torch.sqrt(total)


def _decayed(path) -> bool:
    """Weight decay on matmul weights only (skip norms/biases/scalars);
    ``path`` is a parameter's names, the last one its leaf name."""
    leafname = str(path[-1]) if path else ""
    return not any(s in leafname for s in ("norm", "bias", "scale", "b_",
                                           "lam", "A_log", "dt_bias", "D"))


def decay_mask(params: nn.Module) -> List[bool]:
    """Whether each parameter (in ``parameters()`` order) is decayed. The
    reference decides on its stacked tree (``_decayed(path) and ndim >=
    2``); the leaf name is the same unstacked, and no leaf of the ten
    families changes its decision with the stacked axes gone
    (``tests/test_torch_train.py`` holds every leaf to the reference)."""
    return [_decayed(name.split(".")) and p.ndim >= 2
            for name, p in params.named_parameters()]


@torch.no_grad()
def apply(cfg: AdamWConfig, params: nn.Module, opt: OptState, grads
          ) -> Tuple[nn.Module, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params``, ``opt.m`` and ``opt.v``.
    ``grads`` is a module of the parameters' family or a list in
    ``parameters()`` order. Returns (params, the new state, stats)."""
    gl = aligned(params, grads)
    gnorm = global_norm(gl)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-6), max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, opt.step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, m, v, decay in zip(params.parameters(), gl,
                                 aligned(params, opt.m),
                                 aligned(params, opt.v), decay_mask(params)):
        g = g.float() * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay:
            u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return params, OptState(opt.m, opt.v, step), {"grad_norm": gnorm,
                                                  "lr": lr}
