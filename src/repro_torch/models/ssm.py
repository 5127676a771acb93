"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060] (port of
``repro.models.ssm``).

Train and prefill use the chunked dual form: quadratic *within* a chunk
(batched matmuls) and a linear inter-chunk state recurrence (a Python loop
over chunks on an fp32 (B, H, P, N) state). Decode is the O(1)-a-token
recurrence on that state.

ngroups = 1 (B/C shared across heads), a scalar A per head: the
mamba2-2.7b configuration. The projections are kept un-fused (separate
wz/wx/wB/wC/wdt), as in the reference. Plain torch ops; the reference has
no Pallas kernel here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.constraints import cs
from repro_torch.models.layers import rms_norm_1d, silu
from repro_torch.models.params import p


def ssm_specs(cfg: ModelConfig, stack: tuple = ()):
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    d, di, N, H, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.conv_width)
    return {
        "wz": p(stack + (d, di), axes + ("embed", "inner")),
        "wx": p(stack + (d, di), axes + ("embed", "inner")),
        "wB": p(stack + (d, N), axes + ("embed", None)),
        "wC": p(stack + (d, N), axes + ("embed", None)),
        "wdt": p(stack + (d, H), axes + ("embed", "inner")),
        "conv_x": p(stack + (W, di), axes + (None, "inner"), scale=0.5),
        "conv_B": p(stack + (W, N), axes + (None, None), scale=0.5),
        "conv_C": p(stack + (W, N), axes + (None, None), scale=0.5),
        "A_log": p(stack + (H,), axes + ("inner",), dtype=torch.float32,
                   init="ssm_a"),
        "D": p(stack + (H,), axes + ("inner",), dtype=torch.float32,
               init="ones"),
        "dt_bias": p(stack + (H,), axes + ("inner",), dtype=torch.float32,
                     init="zeros"),
        "norm": p(stack + (di,), axes + ("inner",), init="ones"),
        "out": p(stack + (di, d), axes + ("inner", "embed")),
    }


def shift_sum_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: (B, T, C), w: (W, C), as a shift-sum (W is
    small), in ``x``'s dtype and the reference's order of adds."""
    W, T = w.shape[0], x.shape[1]
    y = x * w[W - 1]
    for i in range(W - 1):
        shift = W - 1 - i
        y = y + F.pad(x, (0, 0, shift, 0))[:, :T] * w[i]
    return y


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return silu(shift_sum_conv(x, w))


def conv_window(hist: torch.Tensor, val: torch.Tensor, w: torch.Tensor):
    """One decode step of the causal conv: ``hist`` (B, W-1, C) holds the
    last W-1 pre-conv rows and ``val`` (B, 1, C) the new one. Returns the
    conv's (B, C) output and the shifted history.

    The sum runs in ``shift_sum_conv``'s order of ops in ``val``'s dtype,
    so a decode step's conv equals forward's at that position bit for bit.
    The reference's decode sums the window in an fp32 einsum instead, one
    bf16 rounding away from its own forward (within the tolerance of the
    reference's decode: ``tests/test_torch_recurrent.py``)."""
    window = torch.cat([hist, val], dim=1)  # (B, W, C)
    W = w.shape[0]
    out = window[:, W - 1] * w[W - 1]
    for i in range(W - 1):
        out = out + window[:, i] * w[i]
    return out, window[:, 1:]


def _project(x, prm, cfg: ModelConfig):
    z = cs(x @ prm["wz"], "batch", "act_seq", "inner")
    xc = cs(x @ prm["wx"], "batch", "act_seq", "inner")
    Bc = x @ prm["wB"]
    Cc = x @ prm["wC"]
    dt = (x @ prm["wdt"]).float()
    dt = F.softplus(dt + prm["dt_bias"])
    return z, xc, Bc, Cc, dt


def ssd_forward(x: torch.Tensor, prm, cfg: ModelConfig,
                init_state: Optional[torch.Tensor] = None,
                return_cache: bool = False):
    """x: (B, T, d_model) -> (y, final_state | decode_cache). Chunked SSD;
    a T that is not a chunk multiple is padded after the projections."""
    Bsz, T, _ = x.shape
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    W = cfg.conv_width
    z, xc, Bc, Cc, dt = _project(x, prm, cfg)
    # the decode cache's conv history: the *pre-conv* projections' last
    # W-1 rows, taken before padding
    conv_tails = (xc[:, T - (W - 1):], Bc[:, T - (W - 1):],
                  Cc[:, T - (W - 1):])
    T_pad = -(-T // Q) * Q
    if T_pad != T:
        # pad to a chunk multiple after dt's softplus: dt = 0 on padded
        # steps gives decay 1 and zero input, so the state and the valid
        # outputs are exactly unchanged
        z, xc, Bc, Cc, dt = (F.pad(a, (0, 0, 0, T_pad - T))
                             for a in (z, xc, Bc, Cc, dt))
    nc = T_pad // Q
    xc = _causal_conv(xc, prm["conv_x"])
    Bc = _causal_conv(Bc, prm["conv_B"])
    Cc = _causal_conv(Cc, prm["conv_C"])

    A = -torch.exp(prm["A_log"])  # (H,) negative
    xh = cs(xc.reshape(Bsz, nc, Q, H, P), "batch", None, None, "inner", None)
    Bh = Bc.reshape(Bsz, nc, Q, N).float()
    Ch = Cc.reshape(Bsz, nc, Q, N).float()
    dth = dt.reshape(Bsz, nc, Q, H)  # fp32

    a = dth * A  # (B,nc,Q,H) log-decay per step
    cum_a = torch.cumsum(a, dim=2)  # inclusive within a chunk
    seg_end = cum_a[:, :, -1]  # (B,nc,H) a chunk's total decay

    # ---- intra-chunk (the dual quadratic form) ----
    # L[s,t] = exp(cum_a[s] - cum_a[t]) for t <= s
    diff = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]  # (B,nc,s,t,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # mask the *exponent*: exp of a large positive future entry would be
    # inf, and inf * 0 poisons gradients with NaNs
    diff = torch.where(mask[None, None, :, :, None], diff, -1e30)
    L = torch.exp(diff)
    del diff
    cb = torch.einsum("bcsn,bctn->bcst", Ch, Bh)  # (B,nc,s,t)
    xdt = xh.float() * dth[..., None]  # (B,nc,Q,H,P)
    # the reference's einsum("bcst,bcsth,bcthp->bcshp", cb, L, xdt) as
    # (cb * L) then one batched matmul over t: the (b,c,s,t,h,p) product
    # is never formed (10.7 GB a batch row at mamba2-2.7b's width)
    M = (cb[..., None] * L).permute(0, 1, 4, 2, 3)  # (B,nc,H,s,t)
    del L
    y_intra = torch.matmul(M, xdt.permute(0, 1, 3, 2, 4))  # (B,nc,H,s,P)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)  # (B,nc,s,H,P)
    del M

    # ---- chunk states ----
    w_state = torch.exp(seg_end[:, :, None, :] - cum_a)  # decay t -> end
    S_chunk = torch.einsum("bctn,bcthp->bchpn", Bh,
                           xdt * w_state[..., None])

    # ---- inter-chunk recurrence ----
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqn,bhpn->bqhp", Ch[:, c], h)
                       * torch.exp(cum_a[:, c])[..., None])
        h = h * torch.exp(seg_end[:, c])[..., None, None] + S_chunk[:, c]
    y_inter = torch.stack(y_inter, dim=1)  # (B,nc,Q,H,P)

    y = y_intra + y_inter + xh.float() * prm["D"][:, None]
    y = y.reshape(Bsz, T_pad, H * P)[:, :T].to(x.dtype)
    y = rms_norm_1d(y * silu(z[:, :T]), prm["norm"])
    out = y @ prm["out"]
    if return_cache:
        cx, cB, cC = conv_tails
        return out, {"h": h, "conv_x": cx, "conv_B": cB, "conv_C": cC}
    return out, h


def ssd_decode_step(x: torch.Tensor, prm, cfg: ModelConfig, cache: dict):
    """x: (B, 1, d_model); cache: {h: (B,H,P,N) fp32, conv_x: (B,W-1,di),
    conv_B/conv_C: (B,W-1,N)}."""
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z, xc, Bc, Cc, dt = _project(x, prm, cfg)
    xcs, conv_x = conv_window(cache["conv_x"], xc, prm["conv_x"])
    Bcs, conv_B = conv_window(cache["conv_B"], Bc, prm["conv_B"])
    Ccs, conv_C = conv_window(cache["conv_C"], Cc, prm["conv_C"])
    xcs, Bcs, Ccs = silu(xcs), silu(Bcs), silu(Ccs)

    A = -torch.exp(prm["A_log"])
    dt1 = dt[:, 0]  # (B,H)
    decay = torch.exp(dt1 * A)  # (B,H)
    xf = xcs.reshape(-1, H, P).float()
    xhp = xf * dt1[..., None]
    h = cache["h"] * decay[..., None, None] + \
        xhp[..., None] * Bcs.float()[:, None, None, :]  # (B,H,P,N)
    y = torch.einsum("bn,bhpn->bhp", Ccs.float(), h)
    y = y + xf * prm["D"][:, None]
    y = y.reshape(-1, 1, H * P).to(x.dtype)
    y = rms_norm_1d(y * silu(z), prm["norm"])
    out = y @ prm["out"]
    return out, {"h": h, "conv_x": conv_x, "conv_B": conv_B,
                 "conv_C": conv_C}


def ssm_cache_specs(cfg: ModelConfig, batch: int, stack: tuple = ()):
    """The decode cache's layout (per layer stack)."""
    H, Pd, N, W, di = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                       cfg.conv_width, cfg.d_inner)
    ax = tuple(["layers"] * len(stack))
    return {
        "h": p(stack + (batch, H, Pd, N), ax + ("batch", "inner", None, None),
               dtype=torch.float32, init="zeros"),
        "conv_x": p(stack + (batch, W - 1, di), ax + ("batch", None, "inner"),
                    init="zeros"),
        "conv_B": p(stack + (batch, W - 1, N), ax + ("batch", None, None),
                    init="zeros"),
        "conv_C": p(stack + (batch, W - 1, N), ax + ("batch", None, None),
                    init="zeros"),
    }
