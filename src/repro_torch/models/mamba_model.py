"""Mamba2 LM: embed -> [norm -> SSD -> residual] x L -> norm -> logits
(port of ``repro.models.mamba_model``).

``MambaLM`` holds one ``ParamTree`` a layer; ``MambaLM(cfg, tree)`` takes
the reference's tree with ``layers`` stacked on a leading (L,) axis and
``tree()`` stacks it back. Decode caches keep the reference's stacked
layout: every leaf (L, B, ...).
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_norm, embed_specs, embed_tokens,
                                       lm_logits, norm_specs)
from repro_torch.models.ssm import (ssd_decode_step, ssd_forward,
                                    ssm_cache_specs, ssm_specs)
from repro_torch.models.transformer import (ParamTree, remat_unit,
                                            stack_trees, unstack_tree)


def init_specs(cfg: ModelConfig):
    L = cfg.num_layers
    return {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg),
        "layers": {"norm": norm_specs(cfg, (L,)), "ssm": ssm_specs(cfg, (L,))},
    }


class MambaLM(nn.Module):
    """``embed``, ``final_norm`` and ``layers`` (one ``ParamTree`` of
    ``norm`` and ``ssm`` a layer)."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.layers = nn.ModuleList(
            ParamTree(unstack_tree(tree["layers"], i))
            for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def tree(self) -> Dict:
        """The parameters in the reference's stacked layout."""
        return {"embed": self.embed.tree(),
                "final_norm": self.final_norm.tree(),
                "layers": stack_trees([lp.tree() for lp in self.layers])}


def forward(params: MambaLM, cfg: ModelConfig, batch, *,
            remat: Union[bool, str] = False, collect_cache: bool = False,
            **_):
    """-> (logits fp32, aux 0, loss_mask, decode cache or None). ``remat``
    checkpoints each layer (``transformer.remat_unit``); ``blockwise`` and
    ``causal_skip`` are accepted and ignored, as the reference's ``**_``
    does."""
    dev = params.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(params.embed, tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)

    def body(x, lp):
        h = apply_norm(x, lp["norm"], cfg)
        y, cache = ssd_forward(h, lp["ssm"], cfg, return_cache=collect_cache)
        return x + y, cache

    body = remat_unit(body, remat)
    caches = []
    for lp in params.layers:
        x, cache = body(x, lp)
        if collect_cache:
            caches.append(cache)
    x = apply_norm(x, params.final_norm, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return (lm_logits(params.embed, x), aux, mask,
            stack_trees(caches) if collect_cache else None)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    del seq_len  # O(1) state whatever the context
    return ssm_cache_specs(cfg, batch, (cfg.num_layers,))


def decode_step(params: MambaLM, cfg: ModelConfig, cache, pos, token):
    """token: (B, 1) int; ``pos`` is unused (the recurrence carries no
    position). Returns (logits (B, 1, V) fp32, the new cache)."""
    del pos
    x = embed_tokens(params.embed, torch.as_tensor(token,
                                                   device=params.device))
    new = []
    for i, lp in enumerate(params.layers):
        h = apply_norm(x, lp["norm"], cfg)
        y, nc = ssd_decode_step(h, lp["ssm"], cfg, unstack_tree(cache, i))
        x = x + y
        new.append(nc)
    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(params.embed, x), stack_trees(new)
