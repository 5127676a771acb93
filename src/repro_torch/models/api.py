"""Unified model API, dispatched by family (port of ``repro.models.api``).

- ``init_specs(cfg)``                     parameter ParamSpec tree
- ``init_params(cfg, generator, device)`` the family's model module
- ``from_reference(cfg, tree, device)``   the reference's parameters
- ``forward(params, cfg, batch, ...)``    -> (logits, aux, loss_mask, cache?)
- ``loss_fn(params, cfg, batch, ...)``    next-token CE (+ MoE aux)
- ``cache_specs / prefill / decode_step / build_decode_cache`` serving
- ``count_params(cfg)``                   analytic parameter count

Families: ``dense``, ``moe`` and ``vlm`` run the generic decoder
(``transformer.Decoder``), ``ssm`` mamba2 (``mamba_model.MambaLM``),
``hybrid`` recurrentgemma (``hybrid.HybridLM``) and ``audio`` whisper
(``whisper.EncoderDecoder``, whose batches carry ``frames``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid, mamba_model, transformer, whisper
from repro_torch.models import params as P

_GENERIC = ("dense", "moe", "vlm")
# family -> (module, its parameter module)
_FAMILIES = {"ssm": (mamba_model, mamba_model.MambaLM),
             "hybrid": (hybrid, hybrid.HybridLM),
             "audio": (whisper, whisper.EncoderDecoder)}
_FAMILIES.update({f: (transformer, transformer.Decoder) for f in _GENERIC})


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} "
                         f"({cfg.name})")
    return _FAMILIES[cfg.family]


def _mod(cfg: ModelConfig):
    return _family(cfg)[0]


def init_specs(cfg: ModelConfig):
    return _mod(cfg).init_specs(cfg)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> nn.Module:
    """Random parameters with the reference's distributions, drawn on
    ``device`` (the GPU by default) from ``generator`` (seed 0 when
    None; it must live on ``device``), as the family's module."""
    dev = resolve_device(device)
    specs = init_specs(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _family(cfg)[1](cfg, P.materialize(specs, generator, dev))


def from_reference(cfg: ModelConfig, tree,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> nn.Module:
    """The reference's parameter tree (numpy arrays) as the port's
    module, bit for bit."""
    return _family(cfg)[1](cfg, P.from_reference(tree,
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
    capacity ``max_len`` (linear caches padded, chunk caches ring-ified;
    an SSM's state as it is)."""
    last_logits, cache = prefill(params, cfg, batch, blockwise=blockwise)
    fam = cfg.family
    if fam == "ssm":
        return last_logits, cache
    if fam == "audio":
        return last_logits, dict(cache, k=_pad_dim(cache["k"], 2, max_len),
                                 v=_pad_dim(cache["v"], 2, max_len))
    if fam == "hybrid":
        w = min(cfg.local_window, max_len)

        def fix(tree):
            # as the reference: dim 2 of every attention cache, which for
            # an unstacked tail block is the KV axis (no config has an
            # attention block in its tail)
            return {name: ({"k": _pad_dim(c["k"], 2, w),
                            "v": _pad_dim(c["v"], 2, w)} if "k" in c else c)
                    for name, c in tree.items()}
        return last_logits, {"units": fix(cache["units"]),
                             "tail": fix(cache["tail"])}
    k, v = cache
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
