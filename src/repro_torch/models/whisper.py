"""Whisper-style encoder-decoder (port of ``repro.models.whisper``).

The conv/mel frontend is a stub, as in the reference: the model consumes
precomputed frame embeddings (B, n_frames, d_model). The decoder's
self-attention uses RoPE and the encoder's is position-free, as the
reference's.

``EncoderDecoder`` holds one ``ParamTree`` an encoder layer and one a
decoder layer; ``tree()`` stacks them back into the reference's
``enc_layers``/``dec_layers`` (leading (E,) and (L,) axes). Decode caches
keep the reference's stacked layout: ``k``/``v`` (L, B, S, KV, hd) and
the cross-attention's ``xk``/``xv`` (L, B, F, KV, hd).
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention, attn_out, attn_specs,
                                          blockwise_attention,
                                          decode_attention, qkv_proj)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_specs,
                                       embed_tokens, lm_logits, mlp_specs,
                                       norm_specs)
from repro_torch.models.params import p
from repro_torch.models.transformer import (ParamTree, cache_update,
                                            remat_unit, stack_trees,
                                            unstack_tree)


def init_specs(cfg: ModelConfig):
    E, L = cfg.num_encoder_layers, cfg.num_layers
    enc = {"norm1": norm_specs(cfg, (E,)), "attn": attn_specs(cfg, (E,)),
           "norm2": norm_specs(cfg, (E,)), "mlp": mlp_specs(cfg, (E,))}
    dec = {"norm1": norm_specs(cfg, (L,)), "attn": attn_specs(cfg, (L,)),
           "norm_x": norm_specs(cfg, (L,)), "xattn": attn_specs(cfg, (L,)),
           "norm2": norm_specs(cfg, (L,)), "mlp": mlp_specs(cfg, (L,))}
    return {"embed": embed_specs(cfg), "enc_layers": enc,
            "enc_norm": norm_specs(cfg), "dec_layers": dec,
            "final_norm": norm_specs(cfg)}


class EncoderDecoder(nn.Module):
    """``embed``, ``enc_layers``, ``enc_norm``, ``dec_layers`` and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.enc_layers = nn.ModuleList(
            ParamTree(unstack_tree(tree["enc_layers"], i))
            for i in range(cfg.num_encoder_layers))
        self.enc_norm = ParamTree(tree["enc_norm"])
        self.dec_layers = nn.ModuleList(
            ParamTree(unstack_tree(tree["dec_layers"], i))
            for i in range(cfg.num_layers))
        self.final_norm = ParamTree(tree["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed["embedding"].device

    def tree(self) -> Dict:
        """The parameters in the reference's stacked layout."""
        return {"embed": self.embed.tree(),
                "enc_layers": stack_trees([lp.tree()
                                           for lp in self.enc_layers]),
                "enc_norm": self.enc_norm.tree(),
                "dec_layers": stack_trees([lp.tree()
                                           for lp in self.dec_layers]),
                "final_norm": self.final_norm.tree()}


def encode(params: EncoderDecoder, cfg: ModelConfig, frames):
    """frames: (B, F, d_model) precomputed embeddings -> encoder states."""
    x = torch.as_tensor(frames, device=params.device)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in params.enc_layers:
        h = apply_norm(x, lp["norm1"], cfg)
        q, k, v = qkv_proj(h, lp["attn"], cfg, positions, rope=False)
        x = x + attn_out(attention(q, k, v, cfg, kind="bidir"), lp["attn"])
        x = x + apply_mlp(apply_norm(x, lp["norm2"], cfg), lp["mlp"], cfg)
    return apply_norm(x, params.enc_norm, cfg)


def _cross_kv(lp, cfg: ModelConfig, enc):
    k = torch.einsum("bsd,dhk->bshk", enc, lp["xattn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc, lp["xattn"]["wv"])
    return k, v


def forward(params: EncoderDecoder, cfg: ModelConfig, batch, *,
            blockwise: bool = False, remat: Union[bool, str] = False,
            collect_cache: bool = False, **_):
    """-> (logits fp32, aux 0, loss_mask, cache or None). ``remat``
    checkpoints each decoder layer, not the encoder, as the reference's
    scan body (``transformer.remat_unit``); ``causal_skip`` is accepted and
    ignored, as the reference's ``**_`` does."""
    dev = params.device
    enc = encode(params, cfg, batch["frames"])
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(params.embed, tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
    positions = torch.arange(x.shape[1], device=dev)

    def body(x, enc, lp):
        h = apply_norm(x, lp["norm1"], cfg)
        q, k, v = qkv_proj(h, lp["attn"], cfg, positions, rope=True)
        if blockwise:
            y = blockwise_attention(q, k, v, cfg, kind="causal")
        else:
            y = attention(q, k, v, cfg, kind="causal", q_pos=positions,
                          kv_pos=positions)
        x = x + attn_out(y, lp["attn"])
        h = apply_norm(x, lp["norm_x"], cfg)
        qx = torch.einsum("bsd,dhk->bshk", h, lp["xattn"]["wq"])
        kx, vx = _cross_kv(lp, cfg, enc)
        x = x + attn_out(attention(qx, kx, vx, cfg, kind="bidir"),
                         lp["xattn"])
        x = x + apply_mlp(apply_norm(x, lp["norm2"], cfg), lp["mlp"], cfg)
        return x, {"k": k, "v": v, "xk": kx, "xv": vx}

    body = remat_unit(body, remat)
    caches = []
    for lp in params.dec_layers:
        x, cache = body(x, enc, lp)
        if collect_cache:
            caches.append(cache)
    x = apply_norm(x, params.final_norm, cfg)
    logits = lm_logits(params.embed, x)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, aux, mask, stack_trees(caches) if collect_cache else None


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    L, KV, hd, F = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                    cfg.num_audio_frames)
    ax = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {
        "k": p((L, batch, seq_len, KV, hd), ax, init="zeros"),
        "v": p((L, batch, seq_len, KV, hd), ax, init="zeros"),
        "xk": p((L, batch, F, KV, hd), ax, init="zeros"),
        "xv": p((L, batch, F, KV, hd), ax, init="zeros"),
    }


def decode_step(params: EncoderDecoder, cfg: ModelConfig, cache, pos, token):
    """token: (B, 1) int; pos: int. Returns (logits (B, 1, V) fp32, the
    new cache; ``xk``/``xv`` pass through)."""
    dev = params.device
    x = embed_tokens(params.embed, torch.as_tensor(token, device=dev))
    pos = int(pos)
    # filled on the device: a host scalar copied over would wait for the
    # stream at every layer
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=dev)
    ks, vs = [], []
    for lp, kc, vc, kx, vx in zip(params.dec_layers, cache["k"], cache["v"],
                                  cache["xk"], cache["xv"]):
        h = apply_norm(x, lp["norm1"], cfg)
        q, k, v = qkv_proj(h, lp["attn"], cfg, pos_t, rope=True)
        kc = cache_update(kc, k, pos % kc.shape[1])
        vc = cache_update(vc, v, pos % vc.shape[1])
        x = x + attn_out(decode_attention(q, kc, vc, pos_t), lp["attn"])
        h = apply_norm(x, lp["norm_x"], cfg)
        qx = torch.einsum("bsd,dhk->bshk", h, lp["xattn"]["wq"])
        y = decode_attention(qx, kx, vx, pos_t, kind="bidir")
        x = x + attn_out(y, lp["xattn"])
        x = x + apply_mlp(apply_norm(x, lp["norm2"], cfg), lp["mlp"], cfg)
        ks.append(kc)
        vs.append(vc)
    x = apply_norm(x, params.final_norm, cfg)
    return lm_logits(params.embed, x), {"k": torch.stack(ks),
                                        "v": torch.stack(vs),
                                        "xk": cache["xk"], "xv": cache["xv"]}
