"""Routed mixture-of-experts with capacity-based dispatch (port of
``repro.models.moe``'s dense dispatch).

Each (token, slot) gets its position within its expert by arrival order
(a cumsum over one-hot routes); slots past the capacity are dropped, and
the kept ones scatter into an (E, C, d) expert buffer.

``apply_moe_ep`` is the expert-parallel variant (``flags.moe_impl("ep")``
inside an ``activation_sharding`` context): each rank routes its batch
shard's tokens to only its own experts and the per-token outputs combine
with one differentiable all-reduce over `model`, the in-mesh form of the
paper's distributed-data-shuffle pushdown.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import constraints
from repro_torch.distributed.constraints import cs
from repro_torch.models import flags
from repro_torch.models.layers import apply_mlp, mlp_specs, silu
from repro_torch.models.params import p


def _dt(t, mesh) -> DTensor:
    """A tensor as a DTensor on ``mesh`` (a plain one is replicated)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _replicate(t, mesh) -> DTensor:
    """``t`` replicated on every dim of ``mesh``."""
    t = _dt(t, mesh)
    plc = [Replicate()] * mesh.ndim
    return t if list(t.placements) == plc else t.redistribute(mesh, plc)


def moe_specs(cfg: ModelConfig, stack: tuple = ()):
    axes = tuple([("layers" if i == 0 else None) for i in range(len(stack))])
    E, d, f = cfg.num_experts + cfg.expert_pad, cfg.d_model, cfg.moe_d_ff
    out = {
        "router": p(stack + (d, cfg.num_experts), axes + ("embed", None)),
        "w_gate": p(stack + (E, d, f), axes + ("experts", "embed", "mlp")),
        "w_up": p(stack + (E, d, f), axes + ("experts", "embed", "mlp")),
        "w_out": p(stack + (E, f, d), axes + ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts > 0:
        # shared experts are dense and always-on; merged into one MLP of
        # width d_ff
        out["shared"] = mlp_specs(cfg, stack, d_ff=cfg.d_ff)
    return out


def capacity_for(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * num_tokens * cfg.num_experts_per_tok
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def apply_moe(x: torch.Tensor, prm, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux_loss). Top-k capacity-routed experts plus
    the shared MLP."""
    if flags.current_moe_impl() == "ep":
        y, aux = apply_moe_ep(x, prm, cfg)
        if y is not None:
            return y, aux
    B, S, d = x.shape
    E, k = cfg.num_experts + cfg.expert_pad, cfg.num_experts_per_tok
    T = B * S
    # rows batch-major on the batch's axes, here and for the gradient
    # (a gradient split over more ranks would not fold back to (B, S, d))
    xt = cs(x.reshape(T, d), "batch", None)
    C = capacity_for(cfg, T)

    logits = xt.float() @ prm["router"].float()  # fp32 accumulation
    probs = torch.softmax(logits, dim=-1)  # (T, E) fp32
    topk_p, topk_i = torch.topk(probs, k, dim=-1)  # (T, k)
    if k > 1:
        topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, slot) within its expert, by arrival order
    flat_e = topk_i.reshape(T * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)  # (T*k, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1  # (T*k,)
    keep = pos < C  # selection bitmap over routed slots (capacity mask)
    pos_c = torch.where(keep, pos, 0)

    # dispatch: every kept slot owns its (expert, position); the dropped
    # ones add zeros at position 0, so the accumulating put is exact
    x_rep = torch.repeat_interleave(xt, k, dim=0)  # (T*k, d)
    x_disp = torch.where(keep[:, None], x_rep, 0)
    # DTensor has no sharding strategy for an accumulating put: on
    # DTensors every rank puts the replicated operands into its own
    # replicated buffer
    mesh = x_disp.device_mesh if isinstance(x_disp, DTensor) else None
    if mesh is not None:
        flat_e, pos_c, x_disp = (_replicate(t, mesh).to_local()
                                 for t in (flat_e, pos_c, x_disp))
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x_disp.device)
    buf.index_put_((flat_e, pos_c), x_disp, accumulate=True)
    if mesh is not None:
        buf = DTensor.from_local(buf, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
        flat_e, pos_c = (_dt(t, mesh) for t in (flat_e, pos_c))
    buf = cs(buf, "experts", None, None)  # EP: expert dim on the model axis

    # expert FFN (SwiGLU), batched over experts
    g = cs(silu(torch.einsum("ecd,edf->ecf", buf, prm["w_gate"])),
           "experts", None, "mlp")
    u = cs(torch.einsum("ecd,edf->ecf", buf, prm["w_up"]),
           "experts", None, "mlp")
    h = cs(torch.einsum("ecf,efd->ecd", g * u, prm["w_out"]),
           "experts", None, None)  # (E, C, d)

    # combine: gather back, weight by gate prob, drop over-capacity slots
    y_slots = h[flat_e, pos_c]  # (T*k, d)
    gates = (topk_p.reshape(T * k) * keep).to(x.dtype)
    y = (y_slots * gates[:, None]).reshape(T, k, d).sum(dim=1)
    # token rows are batch-major: keep them on the batch's axes, so that
    # the reshape back to (B, S, d) splits no batch row across ranks
    y = cs(y, "batch", None)

    # Switch-style load-balance auxiliary loss (over real experts only)
    E_real = cfg.num_experts
    frac_tokens = F.one_hot(topk_i[:, 0], E_real).float().mean(dim=0)
    mean_probs = probs.mean(dim=0)
    aux = E_real * torch.sum(frac_tokens * mean_probs)

    if cfg.num_shared_experts > 0:
        y = y + apply_mlp(xt, prm["shared"], cfg)
    return y.reshape(B, S, d), aux


# ------------------------------------------------------------------ EP
def apply_moe_ep(x: torch.Tensor, prm, cfg: ModelConfig):
    """Expert parallelism (the reference's ``shard_map`` body, per rank).

    The residual stream is batch-sharded over the DP axes and replicated
    over `model`; experts are sharded over `model`. Every model shard
    therefore already HOLDS every token of its batch shard — it routes and
    executes only ITS experts (partition at the source, Fig 5b; other
    experts' slots go to the trash slot ``E_loc``) and the per-token
    outputs combine with one all-reduce over `model` of a (T_local, d)
    tensor.

    Gradients: each rank's partial output enters as a DTensor that is
    ``Partial`` over `model` and is redistributed to ``Replicate`` (the
    all-reduce; its backward hands every rank the whole cotangent), and
    the local inputs leave with ``Partial`` gradient placements, so the
    contributions of the ranks sum. ``aux`` is the mean over the batch
    shards: each rank's value over the mesh size, ``Partial`` over every
    mesh dim, then replicated.

    Returns (None, None) when the mesh doesn't apply (falls back to the
    dense dispatch): no active context, no `model` axis, or an expert
    count that does not divide it.
    """
    from repro_torch.distributed import sharding as shd

    ctx = constraints.current()
    if ctx is None:
        return None, None
    mesh, rules = ctx
    ms = shd.mesh_shape(mesh)
    if "model" not in ms:
        return None, None
    n = ms["model"]
    E_tot = cfg.num_experts + cfg.expert_pad
    if E_tot % n:
        return None, None
    bax = shd.batch_axes(mesh, rules)
    B, S, d = x.shape
    dp = 1
    for a in bax:
        dp *= ms[a]
    if B % max(1, dp):
        bax, dp = (), 1
    E_loc = E_tot // n
    k = cfg.num_experts_per_tok
    E_real = cfg.num_experts
    names = list(mesh.mesh_dim_names)
    m_dim = names.index("model")
    bspec = (bax if len(bax) > 1 else (bax[0] if bax else None), None, None)
    x_plc = shd.placements(bspec, mesh)
    # backward: each model shard's input gradient is a partial sum
    x_grad = [Partial() if i == m_dim else pl for i, pl in enumerate(x_plc)]
    all_partial = [Partial()] * mesh.ndim
    w_plc = shd.placements(("model", None, None), mesh)
    w_grad = [pl if i == m_dim else Partial() for i, pl in enumerate(w_plc)]

    def local(t, plc, grad_plc):
        t = _dt(t, mesh)
        if tuple(t.placements) != tuple(plc):
            t = t.redistribute(mesh, plc)
        return t.to_local(grad_placements=grad_plc)

    xl = local(x, x_plc, x_grad)
    router = local(prm["router"], [Replicate()] * mesh.ndim, all_partial)
    wg = local(prm["w_gate"], w_plc, w_grad)
    wu = local(prm["w_up"], w_plc, w_grad)
    wo = local(prm["w_out"], w_plc, w_grad)

    Bl, Sl, _ = xl.shape
    T = Bl * Sl
    xt = xl.reshape(T, d)
    C = capacity_for(cfg, T)
    logits = xt.float() @ router.float()  # fp32 accumulation
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = torch.topk(probs, k, dim=-1)
    if k > 1:
        topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)

    r = mesh.get_coordinate()[m_dim]
    flat_e = topk_i.reshape(T * k)
    gates_all = topk_p.reshape(T * k)
    is_local = torch.div(flat_e, E_loc, rounding_mode="floor") == r
    le = torch.where(is_local, flat_e - r * E_loc, E_loc)  # E_loc = trash
    onehot = F.one_hot(le, E_loc + 1).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = is_local & (pos < C)
    pos_c = torch.where(keep, pos, 0)
    le_c = torch.where(keep, le, 0)

    x_rep = torch.repeat_interleave(xt, k, dim=0)
    x_disp = torch.where(keep[:, None], x_rep, 0)
    buf = torch.zeros((E_loc, C, d), dtype=x.dtype, device=xl.device)
    buf.index_put_((le_c, pos_c), x_disp, accumulate=True)

    g = silu(torch.einsum("ecd,edf->ecf", buf, wg))
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    h = torch.einsum("ecf,efd->ecd", g * u, wo)

    y_slots = h[le_c, pos_c]
    gates = (gates_all * keep).to(x.dtype)
    y = (y_slots * gates[:, None]).reshape(T, k, d).sum(dim=1)
    # combine across expert shards: the all-reduce over `model`
    y_plc = [Partial() if i == m_dim else pl for i, pl in enumerate(x_plc)]
    y = DTensor.from_local(y.reshape(Bl, Sl, d), mesh, y_plc,
                           run_check=False).redistribute(mesh, x_plc)

    frac = F.one_hot(topk_i[:, 0], E_real).float().mean(dim=0)
    aux = E_real * torch.sum(frac * probs.mean(dim=0))
    # batch shards see different tokens: the mean over them
    if mesh.size() > 1:
        aux = aux / mesh.size()
    aux = DTensor.from_local(aux, mesh, all_partial, run_check=False
                             ).redistribute(mesh, [Replicate()] * mesh.ndim)
    if cfg.num_shared_experts > 0:
        y = y + apply_mlp(_dt(x, mesh).reshape(-1, d), prm["shared"],
                          cfg).reshape(x.shape)
    return y, aux
