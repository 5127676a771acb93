"""Unified model API, dispatched by family (port of ``repro.models.api``).

- ``init_specs(cfg)``                     parameter ParamSpec tree
- ``init_params(cfg, generator, device)`` a ``transformer.Decoder``
- ``from_reference(cfg, tree, device)``   the reference's parameters
- ``forward(params, cfg, batch, ...)``    -> (logits, aux, loss_mask, cache?)
- ``loss_fn(params, cfg, batch, ...)``    next-token CE (+ MoE aux)
- ``cache_specs / prefill / decode_step / build_decode_cache`` serving
- ``count_params(cfg)``                   analytic parameter count

The port has the generic decoder's families (``dense``, ``moe``, ``vlm``).
``ssm``, ``hybrid`` and ``audio`` (mamba2, recurrentgemma, whisper) raise
``NotImplementedError``: they are ROADMAP queue 1's next models item.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models import transformer

_GENERIC = ("dense", "moe", "vlm")


def _mod(cfg: ModelConfig):
    if cfg.family not in _GENERIC:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            "ROADMAP queue 1, the ssm/rglru/hybrid/mamba_model/whisper item")
    return transformer


def init_specs(cfg: ModelConfig):
    return _mod(cfg).init_specs(cfg)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> transformer.Decoder:
    """Random parameters with the reference's distributions, drawn on
    ``device`` (the GPU by default) from ``generator`` (seed 0 when
    None; it must live on ``device``)."""
    dev = resolve_device(device)
    specs = init_specs(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return transformer.Decoder(cfg, P.materialize(specs, generator, dev))


def from_reference(cfg: ModelConfig, tree,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> transformer.Decoder:
    """The reference's parameter tree (numpy arrays) as the port's
    module, bit for bit."""
    return _mod(cfg).Decoder(cfg, P.from_reference(tree,
                                                   resolve_device(device)))


def forward(params, cfg: ModelConfig, batch, **kw):
    return _mod(cfg).forward(params, cfg, batch, **kw)


def loss_fn(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01,
            blockwise: bool = False) -> torch.Tensor:
    logits, aux, mask, _ = forward(params, cfg, batch, blockwise=blockwise)
    labels = torch.as_tensor(batch["tokens"], device=logits.device)
    # VLM: logits cover patch prefix + tokens; score text positions only
    logits_t = logits[:, logits.shape[1] - labels.shape[1]:]
    lf = logits_t[:, :-1].float()
    tgt = labels[:, 1:].long()
    lmax = lf.amax(dim=-1).detach()
    lse = torch.log(torch.exp(lf - lmax[..., None]).sum(-1)) + lmax
    # the reference sums lf * one_hot(tgt) over the vocab (a form that keeps
    # a sharded vocab axis sharded); one nonzero term: the same value
    label_logit = lf.gather(-1, tgt[..., None])[..., 0]
    nll = lse - label_logit
    m = mask[:, mask.shape[1] - labels.shape[1] + 1:]
    loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return loss + aux_weight * aux


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    return _mod(cfg).cache_specs(cfg, batch, seq_len)


def prefill(params, cfg: ModelConfig, batch, *, blockwise: bool = True):
    """Run the full prompt, return (last_logits, cache)."""
    logits, _, _, cache = forward(params, cfg, batch, blockwise=blockwise,
                                  collect_cache=True)
    return logits[:, -1], cache


def decode_step(params, cfg: ModelConfig, cache, pos, token):
    return _mod(cfg).decode_step(params, cfg, cache, pos, token)


def _pad_dim(x: torch.Tensor, dim: int, target: int) -> torch.Tensor:
    if x.shape[dim] == target:
        return x
    if x.shape[dim] > target:  # keep the most recent positions (ring layout)
        if x.shape[dim] % target:
            raise ValueError(f"a cache of {x.shape[dim]} positions does not "
                             f"fold into a ring of {target}")
        return x.narrow(dim, x.shape[dim] - target, target)
    pad = [0, 0] * (x.ndim - dim - 1) + [0, target - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def build_decode_cache(params, cfg: ModelConfig, batch, max_len: int,
                       *, blockwise: bool = True):
    """Prefill the prompt and lay the collected KV out as a decode cache of
    capacity ``max_len`` (linear caches padded, chunk caches ring-ified)."""
    last_logits, (k, v) = prefill(params, cfg, batch, blockwise=blockwise)
    if cfg.attn_unit:  # llama4-style: (k, v) each (U, ul, B, S, KV, hd)
        loc = [j for j, t in enumerate(cfg.attn_unit) if t == "local"]
        glo = [j for j, t in enumerate(cfg.attn_unit) if t != "local"]
        return last_logits, {
            "k_local": _pad_dim(k[:, loc], 3, cfg.attn_chunk),
            "v_local": _pad_dim(v[:, loc], 3, cfg.attn_chunk),
            "k_global": _pad_dim(k[:, glo], 3, max_len),
            "v_global": _pad_dim(v[:, glo], 3, max_len),
        }
    # (L, B, S, KV, hd)
    return last_logits, {"k": _pad_dim(k, 2, max_len),
                         "v": _pad_dim(v, 2, max_len)}


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    specs = init_specs(cfg)
    total = P.count(specs)
    if active_only and cfg.num_experts > 0:
        layers = specs["layers"]
        ep = sum(P.count(layers["ffn"][k]) for k in ("w_gate", "w_up",
                                                      "w_out"))
        total = total - ep + int(ep * cfg.num_experts_per_tok
                                 / cfg.num_experts)
    return total
