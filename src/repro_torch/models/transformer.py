"""Generic decoder LM: dense, MoE, llama4-interleaved and VLM (port of
``repro.models.transformer``).

``Decoder`` is an ``nn.Module`` with one block per layer in an
``nn.ModuleList``; each block knows its attention kind (llama4 configs
repeat a unit of ``len(cfg.attn_unit)`` local/global positions). The
reference stacks layers on leading axes, ``(U, ...)`` or ``(U, ul, ...)``;
``Decoder(cfg, tree)`` takes such a tree and unstacks it in ``(u, j)``
order, and ``Decoder.tree()`` stacks it back. KV caches keep the
reference's stacked layout.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constraints import cs
from repro_torch.models.attention import (attention, attn_out, attn_specs,
                                          blockwise_attention,
                                          decode_attention,
                                          local_chunk_attention,
                                          local_window_attention, qkv_proj)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_specs,
                                       embed_tokens, gelu_tanh, lm_logits,
                                       mlp_specs, norm_specs)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.params import p, tree_map_specs


# --------------------------------------------------------------- structure
def unit_len(cfg: ModelConfig) -> int:
    return len(cfg.attn_unit) if cfg.attn_unit else 1


def num_units(cfg: ModelConfig) -> int:
    u = unit_len(cfg)
    if cfg.num_layers % u:
        raise ValueError(f"{cfg.num_layers} layers do not divide into "
                         f"units of {u}")
    return cfg.num_layers // u


def _layer_specs(cfg: ModelConfig, stack: tuple):
    out = {
        "norm1": norm_specs(cfg, stack),
        "attn": attn_specs(cfg, stack),
        "norm2": norm_specs(cfg, stack),
    }
    if cfg.num_experts > 0:
        out["ffn"] = moe_specs(cfg, stack)
    else:
        out["ffn"] = mlp_specs(cfg, stack)
    return out


def init_specs(cfg: ModelConfig):
    U = num_units(cfg)
    stack = (U,) if unit_len(cfg) == 1 else (U, unit_len(cfg))
    specs = {"embed": embed_specs(cfg), "final_norm": norm_specs(cfg),
             "layers": _layer_specs(cfg, stack)}
    if cfg.family == "vlm":
        specs["projector"] = {
            "w1": p((cfg.patch_dim, cfg.d_model), (None, "embed")),
            "w2": p((cfg.d_model, cfg.d_model), ("embed", "embed")),
        }
    return specs


def _attn_kind(cfg: ModelConfig, pos_in_unit: int):
    if cfg.attn_unit:
        k = cfg.attn_unit[pos_in_unit]
        if k == "local":
            return "local_chunk", cfg.attn_chunk, True
        return "causal", 0, False  # llama4 global layers: NoPE (iRoPE)
    if cfg.local_window:
        return "local_window", cfg.local_window, True
    return "causal", 0, True


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: ``tree[name]`` is a
    parameter or a sub-tree, ``name in tree`` and ``len(tree)`` work as on
    the reference's dicts. Parameters are made without gradients, so that
    serving builds no graph; training turns them on (``requires_grad_``)."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._names = tuple(tree)
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __len__(self) -> int:
        return len(self._names)

    def tree(self) -> Dict:
        return {n: (self[n].tree() if isinstance(self[n], ParamTree)
                    else self[n].data) for n in self._names}


def stack_trees(trees: List[Dict]) -> Dict:
    """Trees of equal layout stacked leaf by leaf on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def unstack_tree(tree: Dict, idx) -> Dict:
    """Entry ``idx`` of every leaf's leading axes."""
    return tree_map_specs(lambda t: t[idx], tree)


class Block(ParamTree):
    """One decoder layer's parameters and its static attention kind."""

    def __init__(self, tree: Dict, kind: str, width: int, rope: bool):
        super().__init__(tree)
        self.kind, self.width, self.rope = kind, width, rope


class Decoder(nn.Module):
    """The decoder's parameters: ``embed``, ``final_norm``, ``blocks`` (one
    ``Block`` a layer, in ``(u, j)`` order) and, for a VLM, the patch
    ``projector``."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        U, ul = num_units(cfg), unit_len(cfg)
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        blocks = []
        for u in range(U):
            for j in range(ul):
                idx = (u,) if ul == 1 else (u, j)
                blocks.append(Block(unstack_tree(tree["layers"], idx),
                                    *_attn_kind(cfg, j)))
        self.blocks = nn.ModuleList(blocks)
        self.projector = (ParamTree(tree["projector"])
                          if "projector" in tree else None)

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def tree(self) -> Dict:
        """The parameters in the reference's stacked layout."""
        U, ul = num_units(self.cfg), unit_len(self.cfg)
        layers = [b.tree() for b in self.blocks]
        if ul > 1:
            layers = [stack_trees(layers[u * ul:(u + 1) * ul])
                      for u in range(U)]
        out = {"embed": self.embed.tree(),
               "final_norm": self.final_norm.tree(),
               "layers": stack_trees(layers)}
        if self.projector is not None:
            out["projector"] = self.projector.tree()
        return out


# --------------------------------------------------------------- remat
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matmuls without batch dimensions and recompute the rest
    (the attention's batched products, the elementwise chains). An
    ``einsum`` projection reaches ``bmm`` over one batch entry, its form of
    such a matmul."""
    if op in _SAVED_DOTS or (op is torch.ops.aten.bmm.default
                             and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_unit(body: Callable, remat: Union[bool, str]) -> Callable:
    """``body`` as the reference's ``jax.checkpoint`` of a unit body:
    ``remat=True`` keeps only the unit's inputs for backward and recomputes
    the unit, ``"dots"`` also keeps the matmul outputs without batch
    dimensions; a false ``remat`` runs ``body`` as it is. Recomputation
    runs the same ops on the same inputs, so no value changes."""
    if not remat:
        return body
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(body, *args, use_reentrant=False, **kw)


# --------------------------------------------------------------- forward
def _sublayer(x, blk: Block, cfg: ModelConfig, positions, blockwise,
              causal_skip):
    kind, width = blk.kind, blk.width
    h = apply_norm(x, blk["norm1"], cfg)
    q, k, v = qkv_proj(h, blk["attn"], cfg, positions, rope=blk.rope)
    S = q.shape[1]
    if kind == "local_chunk" and S > width and S % width == 0:
        y = local_chunk_attention(q, k, v, cfg, width)
    elif kind == "local_window" and S > width and S % width == 0:
        y = local_window_attention(q, k, v, cfg, width)
    elif blockwise and kind == "causal":
        y = blockwise_attention(q, k, v, cfg, kind=kind, width=width,
                                causal_skip=causal_skip)
    else:
        if kind == "local_chunk" and S <= width:
            kind = "causal"  # whole sequence fits in one chunk
        y = attention(q, k, v, cfg, kind=kind, width=width, q_pos=positions,
                      kv_pos=positions)
    x = x + attn_out(y, blk["attn"])
    h = apply_norm(x, blk["norm2"], cfg)
    if cfg.num_experts > 0:
        f, aux = apply_moe(h, blk["ffn"], cfg)
    else:
        f, aux = apply_mlp(h, blk["ffn"], cfg), None
    return x + f, aux, (k, v)


def _prefix_embed(params: Decoder, cfg: ModelConfig, batch):
    """Token (+ patch-prefix) embedding. Returns (x, loss_mask)."""
    dev = params.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(params.embed, tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
    if cfg.family == "vlm" and "patches" in batch:
        pj = params.projector
        patches = torch.as_tensor(batch["patches"], device=dev)
        pe = gelu_tanh(patches @ pj["w1"]) @ pj["w2"]
        x = torch.cat([pe.to(x.dtype), x], dim=1)
        mask = torch.cat([torch.zeros(pe.shape[:2], dtype=torch.float32,
                                      device=dev), mask], dim=1)
    return x, mask


def forward(params: Decoder, cfg: ModelConfig, batch, *,
            blockwise: bool = False, remat: Union[bool, str] = False,
            causal_skip: bool = False, collect_cache: bool = False):
    """-> (logits fp32, aux_loss, loss_mask, cache_kv or None). The cache
    is ``(k, v)``, each ``(U, B, S, KV, hd)`` or ``(U, ul, B, S, KV, hd)``
    as the reference's scan stacks them. ``remat`` checkpoints each unit
    (one block, or llama4's ``ul`` blocks; see ``remat_unit``)."""
    x, mask = _prefix_embed(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ul = unit_len(cfg)

    def unit_body(x, aux, u):
        kvs = []
        for blk in params.blocks[u * ul:(u + 1) * ul]:
            x, a, kv = _sublayer(x, blk, cfg, positions, blockwise,
                                 causal_skip)
            if a is not None:
                aux = aux + a
            kvs.append(kv)
        return x, aux, kvs

    body = remat_unit(unit_body, remat)
    ks, vs = [], []
    for u in range(num_units(cfg)):
        x, aux, kvs = body(x, aux, u)
        if collect_cache:
            ks += [k for k, _ in kvs]
            vs += [v for _, v in kvs]
    x = apply_norm(x, params.final_norm, cfg)
    logits = lm_logits(params.embed, x)
    cache = None
    if collect_cache:
        U, ul = num_units(cfg), unit_len(cfg)
        shape = (U,) if ul == 1 else (U, ul)
        cache = tuple(torch.stack(t).reshape(shape + t[0].shape)
                      for t in (ks, vs))
    return logits, aux, mask, cache


# --------------------------------------------------------------- decode
def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """KV-cache layout for decode_step."""
    U, ul = num_units(cfg), unit_len(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    if not cfg.attn_unit:
        S = min(seq_len, cfg.local_window) if cfg.local_window else seq_len
        shp = (U, batch, S, KV, hd)
        ax = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"k": p(shp, ax, init="zeros"), "v": p(shp, ax, init="zeros")}
    n_local = sum(1 for k in cfg.attn_unit if k == "local")
    n_glob = ul - n_local
    lshp = (U, n_local, batch, cfg.attn_chunk, KV, hd)
    gshp = (U, n_glob, batch, seq_len, KV, hd)
    ax = ("layers", None, "batch", "kv_seq", "kv_heads", None)
    return {"k_local": p(lshp, ax, init="zeros"),
            "v_local": p(lshp, ax, init="zeros"),
            "k_global": p(gshp, ax, init="zeros"),
            "v_global": p(gshp, ax, init="zeros")}


def _ring_slot(pos, size):
    return pos % size


def cache_update(c, new, slot):
    """Write one (B,1,KV,hd) entry at ``slot`` of a (B,S,KV,hd) cache, as a
    new tensor (a masked select, as the reference's)."""
    mask = (torch.arange(c.shape[1], device=c.device) == slot
            )[None, :, None, None]
    c = torch.where(mask, new.to(c.dtype), c)
    return cs(c, "batch", "kv_seq", "kv_heads", None)


def _decode_sublayer(x, blk: Block, cfg, pos, kc, vc, kind, width,
                     cache_pos):
    """One token through one attention sublayer; returns (x, new_k, new_v).
    ``pos`` is the position as an int and as a (1,) tensor on the device."""
    pos, pos_t = pos
    h = apply_norm(x, blk["norm1"], cfg)
    q, k, v = qkv_proj(h, blk["attn"], cfg, pos_t, rope=blk.rope)
    slot = _ring_slot(pos, kc.shape[1])
    kc = cache_update(kc, k, slot)
    vc = cache_update(vc, v, slot)
    y = decode_attention(q, kc, vc, pos_t, kind=kind, width=width,
                         kv_pos=cache_pos)
    x = x + attn_out(y, blk["attn"])
    h = apply_norm(x, blk["norm2"], cfg)
    if cfg.num_experts > 0:
        f, _ = apply_moe(h, blk["ffn"], cfg)
    else:
        f = apply_mlp(h, blk["ffn"], cfg)
    return x + f, kc, vc


def _cache_positions(pos, size, kind, width, device):
    """Logical positions held by each cache slot (invalid slots negative)."""
    s = torch.arange(size, device=device)
    if kind == "causal" and width == 0 and size > 0:
        return s  # linear cache
    if kind == "local_chunk":
        base = (pos // width) * width
        return base + s  # slots past pos % width are future: masked
    # sliding window ring: most recent position congruent to s (mod size)
    return pos - torch.remainder(pos - s, size)


def decode_step(params: Decoder, cfg: ModelConfig, cache: dict, pos, token
                ) -> Tuple[torch.Tensor, dict]:
    """token: (B, 1) int; pos: int. Returns (logits (B, 1, V) fp32, the new
    cache)."""
    dev = params.device
    x = embed_tokens(params.embed, torch.as_tensor(token, device=dev))
    pos = int(pos)
    # filled on the device: a host scalar copied over would wait for the
    # stream at every layer
    at = (pos, torch.full((1,), pos, dtype=torch.int64, device=dev))
    if not cfg.attn_unit:
        kind, width, _ = _attn_kind(cfg, 0)
        size = cache["k"].shape[2]
        cpos = _cache_positions(pos, size, kind, width, dev)
        ks, vs = [], []
        for blk, kc, vc in zip(params.blocks, cache["k"], cache["v"]):
            x, kc, vc = _decode_sublayer(x, blk, cfg, at, kc, vc, kind,
                                         width, cpos)
            ks.append(kc)
            vs.append(vc)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        ul = unit_len(cfg)
        out: Dict[str, List[List[torch.Tensor]]] = {
            n: [] for n in ("k_local", "v_local", "k_global", "v_global")}
        for u in range(num_units(cfg)):
            il = ig = 0
            unit = {n: [] for n in out}
            for j in range(ul):
                blk = params.blocks[u * ul + j]
                kind, width = blk.kind, blk.width
                if kind == "local_chunk":
                    kl, vl = cache["k_local"][u, il], cache["v_local"][u, il]
                    cpos = _cache_positions(pos, kl.shape[1], kind, width,
                                            dev)
                    x, kc, vc = _decode_sublayer(x, blk, cfg, at, kl, vl,
                                                 kind, width, cpos)
                    unit["k_local"].append(kc)
                    unit["v_local"].append(vc)
                    il += 1
                else:
                    kg, vg = cache["k_global"][u, ig], cache["v_global"][u, ig]
                    cpos = _cache_positions(pos, kg.shape[1], "causal", 0,
                                            dev)
                    x, kc, vc = _decode_sublayer(x, blk, cfg, at, kg, vg,
                                                 kind, width, cpos)
                    unit["k_global"].append(kc)
                    unit["v_global"].append(vc)
                    ig += 1
            for n in out:
                out[n].append(torch.stack(unit[n]))
        new_cache = {n: torch.stack(t) for n, t in out.items()}

    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(params.embed, x), new_cache
