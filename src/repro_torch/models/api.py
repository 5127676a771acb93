"""Unified model API, dispatched by family (port of ``repro.models.api``).

- ``init_specs(cfg)``                     parameter ParamSpec tree
- ``init_params(cfg, generator, device)`` the family's model module
- ``from_reference(cfg, tree, device)``   the reference's parameters
- ``forward(params, cfg, batch, ...)``    -> (logits, aux, loss_mask, cache?)
- ``loss_fn(params, cfg, batch, ...)``    next-token CE (+ MoE aux); its
                                          ``remat`` checkpoints each unit
- ``cache_specs / prefill / decode_step / build_decode_cache`` serving,
                                          under ``no_grad``: a module that
                                          trains serves without a graph
- ``input_specs(cfg, shape)``             meta-tensor stand-ins per cell
- ``count_params / count_matmul_params``  analytic parameter counts
- ``with_depth / scan_units``             depth scaling for the dry run's
                                          cost extrapolation

Families: ``dense``, ``moe`` and ``vlm`` run the generic decoder
(``transformer.Decoder``), ``ssm`` mamba2 (``mamba_model.MambaLM``),
``hybrid`` recurrentgemma (``hybrid.HybridLM``) and ``audio`` whisper
(``whisper.EncoderDecoder``, whose batches carry ``frames``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.distributed import constraints
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
    return params_module(cfg, P.materialize(specs, generator, dev))


def params_module(cfg: ModelConfig, tree) -> nn.Module:
    """The family's parameter module over a stacked tree of tensors (or
    of DTensors: ``distributed.sharding.distribute_tree``'s)."""
    return _family(cfg)[1](cfg, tree)


def from_reference(cfg: ModelConfig, tree,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> nn.Module:
    """The reference's parameter tree (numpy arrays) as the port's
    module, bit for bit."""
    return params_module(cfg, P.from_reference(tree, resolve_device(device)))


def forward(params, cfg: ModelConfig, batch, **kw):
    return _mod(cfg).forward(params, cfg, batch, **kw)


def loss_fn(params, cfg: ModelConfig, batch, *,
            remat: Union[bool, str] = False, aux_weight: float = 0.01,
            blockwise: bool = False) -> torch.Tensor:
    logits, aux, mask, _ = forward(params, cfg, batch, remat=remat,
                                   blockwise=blockwise)
    labels = torch.as_tensor(batch["tokens"], device=logits.device)
    # VLM: logits cover patch prefix + tokens; score text positions only
    logits_t = logits[:, logits.shape[1] - labels.shape[1]:]
    lf = logits_t[:, :-1].float()
    tgt = labels[:, 1:].long()
    lmax = lf.amax(dim=-1).detach()  # the reference's stop_gradient
    lse = torch.log(torch.exp(lf - lmax[..., None]).sum(-1)) + lmax
    if constraints.active():
        # every reduction over the (TP-sharded) vocab axis, so the logits
        # stay sharded (a gather over a sharded axis would replicate them)
        onehot = torch.nn.functional.one_hot(tgt, lf.shape[-1]).to(lf.dtype)
        label_logit = (lf * onehot).sum(-1)
    else:
        # one nonzero term of the one-hot sum: the same value
        label_logit = lf.gather(-1, tgt[..., None])[..., 0]
    nll = lse - label_logit
    m = mask[:, mask.shape[1] - labels.shape[1] + 1:]
    loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return loss + aux_weight * aux


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    return _mod(cfg).cache_specs(cfg, batch, seq_len)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, *, blockwise: bool = True):
    """Run the full prompt, return (last_logits, cache)."""
    logits, _, _, cache = forward(params, cfg, batch, blockwise=blockwise,
                                  collect_cache=True)
    return logits[:, -1], cache


@torch.no_grad()
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
    return last_logits, decode_cache_layout(cfg, cache, max_len)


def decode_cache_layout(cfg: ModelConfig, cache, max_len: int):
    """A prefill's collected cache laid out as a decode cache of capacity
    ``max_len`` (see ``build_decode_cache``)."""
    fam = cfg.family
    if fam == "ssm":
        return cache
    if fam == "audio":
        return dict(cache, k=_pad_dim(cache["k"], 2, max_len),
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
        return {"units": fix(cache["units"]), "tail": fix(cache["tail"])}
    k, v = cache
    if cfg.attn_unit:  # llama4-style: (k, v) each (U, ul, B, S, KV, hd)
        loc = [j for j, t in enumerate(cfg.attn_unit) if t == "local"]
        glo = [j for j, t in enumerate(cfg.attn_unit) if t != "local"]
        return {
            "k_local": _pad_dim(k[:, loc], 3, cfg.attn_chunk),
            "v_local": _pad_dim(v[:, loc], 3, cfg.attn_chunk),
            "k_global": _pad_dim(k[:, glo], 3, max_len),
            "v_global": _pad_dim(v[:, glo], 3, max_len),
        }
    # (L, B, S, KV, hd)
    return {"k": _pad_dim(k, 2, max_len), "v": _pad_dim(v, 2, max_len)}


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


# ------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract model inputs for one shape cell, as meta tensors (no
    allocation).

    train/prefill: full (B, S) token batch (+ modality stubs).
    decode: one new token (B, 1) + scalar position; the KV cache itself is
    part of the state signature (see launch/steps.py)."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"tokens": meta((B, S), tok),
                    "frames": meta((B, cfg.num_audio_frames, cfg.d_model),
                                   torch.bfloat16)}
        if cfg.family == "vlm":
            return {"tokens": meta((B, S - cfg.num_patches), tok),
                    "patches": meta((B, cfg.num_patches, cfg.patch_dim),
                                    torch.bfloat16)}
        return {"tokens": meta((B, S), tok)}
    return {"token": meta((B, 1), tok), "pos": meta((), torch.int32)}


def count_matmul_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Params participating in per-token matmuls, for MODEL_FLOPS = 6*N*D.

    The embedding *gather* does no matmul FLOPs; the lm_head projection
    does. Tied models reuse the table as the lm_head weight, so the (V, d)
    count is kept either way — untied models already count lm_head
    separately, so the gather table is simply removed."""
    total = count_params(cfg, active_only)
    if "lm_head" in init_specs(cfg)["embed"]:
        total -= cfg.vocab_size * cfg.d_model  # drop the gather-only table
    return total


# ------------------------------------------------------------- depth scaling
def scan_units(cfg: ModelConfig) -> int:
    """Number of repeated units (the linear-extrapolation variable)."""
    if cfg.family == "hybrid":
        return hybrid.structure(cfg)[0]
    if cfg.family == "audio":
        return cfg.num_layers  # enc and dec scale together
    return (transformer.num_units(cfg) if cfg.family in _GENERIC
            else cfg.num_layers)


def with_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """Config with ``units`` repeated units (tails/ratios preserved)."""
    if cfg.family == "hybrid":
        u = len(cfg.block_unit)
        tail = cfg.num_layers % u
        return dataclasses.replace(cfg, num_layers=units * u + tail)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=units,
                                   num_encoder_layers=units)
    ul = transformer.unit_len(cfg)
    return dataclasses.replace(cfg, num_layers=units * ul)
