"""RecurrentGemma-style hybrid: repeating (rec, rec, attn) units and a tail
(port of ``repro.models.hybrid``).

26 layers = 8 units of 3 and a 2-layer (rec, rec) tail. Every block:
x += temporal(norm1(x)); x += mlp(norm2(x)). Attention blocks use
sliding-window (local) attention with a ring cache at decode.

``HybridLM`` holds one ``HybridBlock`` a layer: the units' blocks in
``(u, i)`` order, then the tail's. Decode caches keep the reference's
layout: ``{"units": {"b{i}": leaves (U, B, ...)}, "tail": {"b{i}": leaves
(B, ...)}}``.

The reference's ring quirk is kept: prefill caches an attention block's
last ``w`` keys as ``k[:, S - w:]`` (slot 0 holds position S - w), while
decode addresses the ring as ``pos % w``. When S > w and S is not a
multiple of w the ring is rotated by S mod w, and decode overwrites and
masks the wrong slots; the port decodes as the reference does.
"""
from __future__ import annotations

from typing import Dict, List, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention, attn_out, attn_specs,
                                          decode_attention,
                                          local_window_attention, qkv_proj)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_specs,
                                       embed_tokens, lm_logits, mlp_specs,
                                       norm_specs)
from repro_torch.models.params import p
from repro_torch.models.rglru import (rglru_cache_specs, rglru_decode_step,
                                      rglru_forward, rglru_specs)
from repro_torch.models.transformer import (ParamTree, _cache_positions,
                                            cache_update, remat_unit,
                                            stack_trees, unstack_tree)


def structure(cfg: ModelConfig):
    u = len(cfg.block_unit)
    full = cfg.num_layers // u
    tail = cfg.num_layers % u
    return full, tuple(cfg.block_unit[:tail])


def _block_specs(cfg: ModelConfig, kind: str, stack: tuple):
    t = rglru_specs(cfg, stack) if kind == "rec" else attn_specs(cfg, stack)
    return {"norm1": norm_specs(cfg, stack), "temporal": t,
            "norm2": norm_specs(cfg, stack), "mlp": mlp_specs(cfg, stack)}


def init_specs(cfg: ModelConfig):
    U, tail = structure(cfg)
    units = {f"b{i}": _block_specs(cfg, k, (U,))
             for i, k in enumerate(cfg.block_unit)}
    tails = {f"b{i}": _block_specs(cfg, k, ()) for i, k in enumerate(tail)}
    return {"embed": embed_specs(cfg), "final_norm": norm_specs(cfg),
            "units": units, "tail": tails}


class HybridBlock(ParamTree):
    """One block's parameters and its kind (``rec`` or ``attn``)."""

    def __init__(self, tree: Dict, kind: str):
        super().__init__(tree)
        self.kind = kind


class HybridLM(nn.Module):
    """``embed``, ``final_norm``, ``units`` (U x len(block_unit) blocks in
    ``(u, i)`` order) and ``tail``."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        U, tail = structure(cfg)
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.units = nn.ModuleList(
            HybridBlock(unstack_tree(tree["units"][f"b{i}"], u), kind)
            for u in range(U) for i, kind in enumerate(cfg.block_unit))
        self.tail = nn.ModuleList(
            HybridBlock(tree["tail"][f"b{i}"], kind)
            for i, kind in enumerate(tail))

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def unit(self, u: int) -> List[HybridBlock]:
        ul = len(self.cfg.block_unit)
        return list(self.units[u * ul:(u + 1) * ul])

    def tree(self) -> Dict:
        """The parameters in the reference's stacked layout."""
        U, _ = structure(self.cfg)
        units = {f"b{i}": stack_trees([self.unit(u)[i].tree()
                                       for u in range(U)])
                 for i in range(len(self.cfg.block_unit))}
        return {"embed": self.embed.tree(),
                "final_norm": self.final_norm.tree(), "units": units,
                "tail": {f"b{i}": b.tree() for i, b in enumerate(self.tail)}}


def _block_fwd(x, bp: HybridBlock, cfg: ModelConfig, positions,
               collect_cache: bool):
    h = apply_norm(x, bp["norm1"], cfg)
    cache = None
    if bp.kind == "rec":
        y, state = rglru_forward(h, bp["temporal"], cfg)
        if collect_cache:
            W = cfg.conv_width
            u_pre = h @ bp["temporal"]["w_in"]
            cache = {"h": state, "conv": u_pre[:, u_pre.shape[1] - (W - 1):]}
    else:
        q, k, v = qkv_proj(h, bp["temporal"], cfg, positions, rope=True)
        S, w = q.shape[1], cfg.local_window
        if S > w and S % w == 0:
            y = local_window_attention(q, k, v, cfg, w)
        else:
            y = attention(q, k, v, cfg, kind="local_window", width=w,
                          q_pos=positions, kv_pos=positions)
        y = attn_out(y, bp["temporal"])
        if collect_cache:
            # the reference's layout: slot 0 holds position S - w_eff (a
            # ring rotated by S mod w when S > w; see the module docstring)
            w_eff = min(w, S)
            cache = {"k": k[:, S - w_eff:], "v": v[:, S - w_eff:]}
    x = x + y
    x = x + apply_mlp(apply_norm(x, bp["norm2"], cfg), bp["mlp"], cfg)
    return x, cache


def forward(params: HybridLM, cfg: ModelConfig, batch, *,
            remat: Union[bool, str] = False, collect_cache: bool = False,
            **_):
    """-> (logits fp32, aux 0, loss_mask, cache or None). ``remat``
    checkpoints each unit of ``len(block_unit)`` blocks, not the tail, as
    the reference's scan body (``transformer.remat_unit``); ``blockwise``
    and ``causal_skip`` are accepted and ignored, as the reference's
    ``**_`` does."""
    dev = params.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(params.embed, tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
    positions = torch.arange(x.shape[1], device=dev)
    U, _ = structure(cfg)

    def unit_body(x, u):
        caches = {}
        for i, bp in enumerate(params.unit(u)):
            x, caches[f"b{i}"] = _block_fwd(x, bp, cfg, positions,
                                            collect_cache)
        return x, caches

    body = remat_unit(unit_body, remat)
    unit_caches = []
    for u in range(U):
        x, caches = body(x, u)
        unit_caches.append(caches)
    tail_caches = {}
    for i, bp in enumerate(params.tail):
        x, tail_caches[f"b{i}"] = _block_fwd(x, bp, cfg, positions,
                                             collect_cache)
    x = apply_norm(x, params.final_norm, cfg)
    logits = lm_logits(params.embed, x)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    cache = ({"units": stack_trees(unit_caches), "tail": tail_caches}
             if collect_cache else None)
    return logits, aux, mask, cache


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    U, tail = structure(cfg)
    w = min(cfg.local_window, seq_len)
    KV, hd = cfg.num_kv_heads, cfg.head_dim

    def one(kind, stack):
        if kind == "rec":
            return rglru_cache_specs(cfg, batch, stack)
        ax = tuple(["layers"] * len(stack)) + ("batch", "kv_seq", "kv_heads",
                                               None)
        shp = stack + (batch, w, KV, hd)
        return {"k": p(shp, ax, init="zeros"), "v": p(shp, ax, init="zeros")}

    return {"units": {f"b{i}": one(k, (U,))
                      for i, k in enumerate(cfg.block_unit)},
            "tail": {f"b{i}": one(k, ()) for i, k in enumerate(tail)}}


def _block_decode(x, bp: HybridBlock, cfg: ModelConfig, at, bc):
    """One token through one block. ``at`` is the position as an int and
    as a (1,) tensor on the device."""
    pos, pos_t = at
    h = apply_norm(x, bp["norm1"], cfg)
    if bp.kind == "rec":
        y, nc = rglru_decode_step(h, bp["temporal"], cfg, bc)
    else:
        q, k, v = qkv_proj(h, bp["temporal"], cfg, pos_t, rope=True)
        size = bc["k"].shape[1]
        slot = pos % size
        kc = cache_update(bc["k"], k, slot)
        vc = cache_update(bc["v"], v, slot)
        cpos = _cache_positions(pos, size, "local_window", cfg.local_window,
                                x.device)
        y = decode_attention(q, kc, vc, pos_t, kind="local_window",
                             width=cfg.local_window, kv_pos=cpos)
        y = attn_out(y, bp["temporal"])
        nc = {"k": kc, "v": vc}
    x = x + y
    x = x + apply_mlp(apply_norm(x, bp["norm2"], cfg), bp["mlp"], cfg)
    return x, nc


def decode_step(params: HybridLM, cfg: ModelConfig, cache, pos, token):
    """token: (B, 1) int; pos: int. Returns (logits (B, 1, V) fp32, the
    new cache)."""
    dev = params.device
    x = embed_tokens(params.embed, torch.as_tensor(token, device=dev))
    pos = int(pos)
    # filled on the device: a host scalar copied over would wait for the
    # stream at every attention block
    at = (pos, torch.full((1,), pos, dtype=torch.int64, device=dev))
    U, _ = structure(cfg)
    new_units = []
    for u in range(U):
        ncs = {}
        for i, bp in enumerate(params.unit(u)):
            x, ncs[f"b{i}"] = _block_decode(
                x, bp, cfg, at, unstack_tree(cache["units"][f"b{i}"], u))
        new_units.append(ncs)
    new_tail = {}
    for i, bp in enumerate(params.tail):
        x, new_tail[f"b{i}"] = _block_decode(x, bp, cfg, at,
                                             cache["tail"][f"b{i}"])
    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(params.embed, x), {"units": stack_trees(new_units),
                                        "tail": new_tail}
