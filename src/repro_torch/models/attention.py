"""Attention: GQA projections and its execution regimes (port of
``repro.models.attention``).

- ``attention``              materialized scores
- ``blockwise_attention``    online softmax over KV blocks (prefill); the
                             baseline computes every block pair masked,
                             ``causal_skip`` only the lower triangle
- ``local_chunk_attention``  block-diagonal causal (llama4 local layers)
- ``local_window_attention`` banded sliding window
- ``decode_attention``       one query token against a KV cache

Scores accumulate in fp32 (the bf16 operands widen to fp32 exactly, which is
what the reference's ``preferred_element_type=float32`` computes), are
scaled by ``sqrt(hd)`` in fp32, masked with ``NEG_INF``, softmaxed in fp32
and cast to the query's dtype before the value product. Plain torch ops;
no fused attention kernel. The batched products go through
``constraints.einsum``: ``torch.einsum`` itself on plain tensors, each
rank's blocks on DTensors.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constraints import cs, einsum, mesh_axis_size
from repro_torch.models import flags
from repro_torch.models.layers import apply_rope, rms_norm_1d
from repro_torch.models.params import p

NEG_INF = -2.0e38


def attn_specs(cfg: ModelConfig, stack: tuple = ()):
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    hd, H, KV, d = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    out = {
        "wq": p(stack + (d, H, hd), axes + ("embed", "heads", None)),
        "wk": p(stack + (d, KV, hd), axes + ("embed", "kv_heads", "kv_hd")),
        "wv": p(stack + (d, KV, hd), axes + ("embed", "kv_heads", "kv_hd")),
        "wo": p(stack + (H, hd, d), axes + ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = p(stack + (H, hd), axes + ("heads", None), init="zeros")
        out["bk"] = p(stack + (KV, hd), axes + ("kv_heads", None),
                      init="zeros")
        out["bv"] = p(stack + (KV, hd), axes + ("kv_heads", None),
                      init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = p(stack + (hd,), axes + (None,), init="ones")
        out["k_norm"] = p(stack + (hd,), axes + (None,), init="ones")
    return out


def qkv_proj(x, prm, cfg: ModelConfig, positions, rope: bool = True):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd).

    q: heads -> TP axis; when the head count doesn't divide it, the
    `attn_seq` fallback context-parallelizes the query sequence instead."""
    q = cs(torch.einsum("bsd,dhk->bshk", x, prm["wq"]),
           "batch", "attn_seq", "heads", None)
    k = cs(torch.einsum("bsd,dhk->bshk", x, prm["wk"]),
           "batch", None, "kv_heads", "kv_hd")
    v = cs(torch.einsum("bsd,dhk->bshk", x, prm["wv"]),
           "batch", None, "kv_heads", "kv_hd")
    if cfg.qkv_bias:
        q, k, v = q + prm["bq"], k + prm["bk"], v + prm["bv"]
    if cfg.qk_norm:
        q = rms_norm_1d(q, prm["q_norm"])
        k = rms_norm_1d(k, prm["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(y, prm):
    return cs(torch.einsum("bshk,hkd->bsd", y, prm["wo"]),
              "batch", "act_seq", None)


def _group(q, num_kv):
    """(B,S,H,hd) -> (B,S,KV,G,hd)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, num_kv, H // num_kv, hd)


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return einsum(eq, a.float(), b.float())


def _scale(hd: int) -> float:
    """fp32 ``sqrt(hd)``, as the reference's ``jnp.sqrt(hd)`` is."""
    return float(np.float32(math.sqrt(hd)))


def _mask(q_pos, kv_pos, kind: str, width: int) -> torch.Tensor:
    """Boolean keep-mask (..., Sq, Sk)."""
    qp, kp = q_pos[..., :, None], kv_pos[..., None, :]
    if kind == "bidir":
        return torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool, device=qp.device)
    keep = (kp <= qp) & (kp >= 0)  # kp < 0: never-written ring-cache slots
    if kind == "local_window":
        keep &= kp > qp - width
    elif kind == "local_chunk":
        keep &= torch.div(kp, width, rounding_mode="floor") == \
            torch.div(qp, width, rounding_mode="floor")
    return keep


def attention(q, k, v, cfg: ModelConfig, kind: str = "causal", width: int = 0,
              q_pos: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None):
    """Materialized-score attention. q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(Sk, device=q.device)
    keep = _mask(q_pos, kv_pos, kind, width)
    flat_ok = H % max(1, mesh_axis_size("model")) == 0  # else the repeated
    # K/V can't shard on heads and replicates (B,Sk,H,hd) per layer
    if flags.current_attn_impl() == "flat" and H != KV and flat_ok:
        # K/V repeated to the head dim; on one device the same values as
        # the grouped form
        kf = cs(torch.repeat_interleave(k, H // KV, dim=2),
                "batch", None, "heads", None)
        vf = cs(torch.repeat_interleave(v, H // KV, dim=2),
                "batch", None, "heads", None)
        s = _f32_einsum("bshd,bthd->bhst", q, kf)
        s = torch.where(keep, s / _scale(hd), NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        return einsum("bhst,bthd->bshd", w, vf)
    qg = _group(q, KV)
    scores = _f32_einsum("bskgh,btkh->bkgst", qg, k)
    scores = scores / _scale(hd)
    scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    y = einsum("bkgst,btkh->bskgh", w, v)
    return y.reshape(B, Sq, H, hd)


def blockwise_attention(q, k, v, cfg: ModelConfig, kind: str = "causal",
                        width: int = 0, q_block: int = 1024,
                        kv_block: int = 1024, causal_skip: bool = False):
    """Memory-bounded online-softmax attention for long prefill.

    q: (B,S,H,hd); k/v: (B,S,KV,hd). Short or ragged prompts (S below two
    query blocks, or not a multiple of both blocks) take ``attention``.

    causal_skip=False: every (q-block, kv-block) pair is computed and
    masked, all query blocks at once per KV block. causal_skip=True: only
    the lower-triangular pairs, one pair per step.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if S < 2 * q_block or S % q_block or S % kv_block:
        return attention(q, k, v, cfg, kind=kind, width=width)
    nq, nk = S // q_block, S // kv_block
    dev = q.device
    scale = 1.0 / _scale(hd)
    qg = _group(q, KV).reshape(B, nq, q_block, KV, G, hd)

    m0 = torch.full((B, nq, KV, G, q_block), NEG_INF, dtype=torch.float32,
                    device=dev)
    l0 = torch.zeros((B, nq, KV, G, q_block), dtype=torch.float32, device=dev)
    o0 = torch.zeros((B, nq, KV, G, q_block, hd), dtype=torch.float32,
                     device=dev)

    if not causal_skip:
        qpos = torch.arange(S, device=dev).reshape(nq, q_block)

        def body(carry, j):
            m, l, o = carry
            kj = k[:, j * kv_block:(j + 1) * kv_block]
            vj = v[:, j * kv_block:(j + 1) * kv_block]
            kpos = j * kv_block + torch.arange(kv_block, device=dev)
            s = _f32_einsum("bnqkgh,btkh->bnkgqt", qg, kj) * scale
            keep = _mask(qpos, kpos, kind, width)  # (nq, qb, kvb)
            s = torch.where(keep[None, :, None, None], s, NEG_INF)
            bm = s.amax(-1)
            e = torch.exp(s - bm[..., None])
            bl = e.sum(-1)
            bo = einsum("bnkgqt,btkh->bnkgqh", e.to(v.dtype), vj)
            mn = torch.maximum(m, bm)
            a1, a2 = torch.exp(m - mn), torch.exp(bm - mn)
            return (mn, l * a1 + bl * a2,
                    o * a1[..., None] + bo * a2[..., None]), None

        (m, l, o), _ = flags.maybe_scan(body, (m0, l0, o0), range(nk))
    else:
        pairs = [(i, j) for i in range(nq) for j in range(nk)
                 if j * kv_block < (i + 1) * q_block]

        def body(carry, ij):
            m, l, o = carry
            i, j = ij
            qi = qg[:, i]
            kj = k[:, j * kv_block:(j + 1) * kv_block]
            vj = v[:, j * kv_block:(j + 1) * kv_block]
            qpos = i * q_block + torch.arange(q_block, device=dev)
            kpos = j * kv_block + torch.arange(kv_block, device=dev)
            s = _f32_einsum("bqkgh,btkh->bkgqt", qi, kj) * scale
            s = torch.where(_mask(qpos, kpos, kind, width), s, NEG_INF)
            bm = s.amax(-1)
            e = torch.exp(s - bm[..., None])
            bl = e.sum(-1)
            bo = einsum("bkgqt,btkh->bkgqh", e.to(v.dtype), vj)
            mi, li, oi = m[:, i], l[:, i], o[:, i]
            mn = torch.maximum(mi, bm)
            a1, a2 = torch.exp(mi - mn), torch.exp(bm - mn)
            m[:, i] = mn
            l[:, i] = li * a1 + bl * a2
            o[:, i] = oi * a1[..., None] + bo.float() * a2[..., None]
            return (m, l, o), None

        (m, l, o), _ = flags.maybe_scan(body, (m0, l0, o0), pairs)

    y = o / torch.clamp(l[..., None], min=1e-30)
    # (B,nq,KV,G,qb,hd) -> (B,S,H,hd)
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, hd)
    return y.to(q.dtype)


def local_chunk_attention(q, k, v, cfg: ModelConfig, chunk: int,
                          blockwise: bool = True):
    """Block-diagonal causal attention (llama4 local layers). S % chunk == 0.

    Chunks fold into the batch dim; within a chunk of more than 1024 (a
    multiple of 1024) the blockwise online softmax bounds the scores."""
    B, S, H, hd = q.shape
    nc = S // chunk
    fold = lambda t: cs(t.reshape(B * nc, chunk, *t.shape[2:]),  # noqa: E731
                        "batch", "attn_seq", None, None)
    qf, kf, vf = fold(q), fold(k), fold(v)
    if blockwise and chunk % 1024 == 0 and chunk > 1024:
        y = blockwise_attention(qf, kf, vf, cfg, kind="causal")
    else:
        y = attention(qf, kf, vf, cfg, kind="causal")
    return y.reshape(B, S, H, hd)


def local_window_attention(q, k, v, cfg: ModelConfig, window: int):
    """Banded sliding-window attention via (prev, self) block pairs.

    S % window == 0; each query attends to positions (p - window, p].
    Only the 2w band is materialized.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    w = window
    nb = S // w
    dev = q.device
    qb = cs(q.reshape(B, nb, w, KV, G, hd),
            "batch", "attn_seq", None, "kv_heads", None, None)
    blk = lambda t: cs(t.reshape(B, nb, w, KV, hd),  # noqa: E731
                       "batch", "attn_seq", None, "kv_heads", None)
    kb, vb = blk(k), blk(v)

    def pair(t):
        prev = torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1)
        return torch.cat([prev, t], dim=2)

    kp_, vp_ = pair(kb), pair(vb)  # (B, nb, 2w, KV, hd)
    s = _f32_einsum("bnqkgh,bntkh->bnkgqt", qb, kp_) * (1.0 / _scale(hd))
    qpos = w + torch.arange(w, device=dev)
    kpos = torch.arange(2 * w, device=dev)
    keep = (kpos[None, :] <= qpos[:, None]) & \
        (kpos[None, :] > qpos[:, None] - w)  # (w, 2w)
    valid = torch.ones((nb, 2 * w), dtype=torch.bool, device=dev)
    valid[0, :w] = False  # block 0 has no prev
    keep = keep[None, :, :] & valid[:, None, :]  # (nb, w, 2w)
    s = torch.where(keep[None, :, None, None], s, NEG_INF)
    wts = torch.softmax(s, dim=-1).to(q.dtype)
    y = einsum("bnkgqt,bntkh->bnqkgh", wts, vp_)
    return y.reshape(B, S, H, hd)


def decode_attention(q, k_cache, v_cache, pos, kind: str = "causal",
                     width: int = 0, kv_pos: Optional[torch.Tensor] = None):
    """q: (B,1,H,hd); caches: (B,S,KV,hd); pos: the current position.

    kv_pos: positions of cache slots (for ring-buffer local caches)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if kv_pos is None:
        kv_pos = torch.arange(S, device=dev)
    qg = _group(q, KV)[:, 0]  # (B,KV,G,hd)
    s = _f32_einsum("bkgh,btkh->bkgt", qg, k_cache) / _scale(hd)
    q_pos = torch.as_tensor(pos, device=dev).reshape(1)
    keep = _mask(q_pos, kv_pos, kind, width)[0]  # (S,)
    s = torch.where(keep, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    y = einsum("bkgt,btkh->bkgh", w, v_cache)
    return y.reshape(B, 1, H, hd)
