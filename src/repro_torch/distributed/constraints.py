"""Logical activation-sharding constraints (port of
``repro.distributed.constraints``).

Model code is mesh-agnostic: it annotates activations with *logical* axis
names via ``cs(x, "batch", "act_seq", "heads", None)``. When a mesh+rules
context is active (set by ``repro_torch.launch.steps`` around a step), the
names resolve through the same rule table as the parameters and a DTensor
is redistributed to their placements; otherwise, or on a plain tensor,
``cs`` returns its input (single-device runs, the tests of the models).
As GSPMD's constraint does, an anchor also constrains the gradient that
flows back through it.

Why this exists: FSDP shards the *contracting* dim of every weight, so
without activation anchors the propagation resolves the
batch-vs-contracting conflict by replicating attention heads or MLP
hidden activations. An anchor is the eager form of GSPMD's
``with_sharding_constraint``: a ``redistribute``, whose collectives the
launch layer's recorder counts.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor

# NOTE: repro_torch.distributed.sharding is imported lazily — model
# modules import this file, and sharding imports the model param helpers.

_ACTIVE = contextvars.ContextVar("repro_torch_act_ctx", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules=None):
    """Make ``mesh`` (a ``DeviceMesh``) and ``rules`` the anchors' context."""
    if rules is None:
        from repro_torch.distributed import sharding as shd
        rules = shd.BASELINE_RULES
    tok = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def active() -> bool:
    return _ACTIVE.get() is not None


def current():
    """The active ``(mesh, rules)``, or None."""
    return _ACTIVE.get()


class _Pinned(torch.autograd.Function):
    """Identity forward; the gradient redistributed to ``plc`` (the
    transpose of a sharding constraint is the same constraint on the
    cotangent)."""

    @staticmethod
    def forward(ctx, x, plc):
        ctx.plc = plc
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.plc:
            g = g.redistribute(g.device_mesh, ctx.plc)
        return g, None


def _constrain(x: DTensor, plc: tuple) -> DTensor:
    if tuple(x.placements) != plc:
        x = x.redistribute(x.device_mesh, plc)
    return _Pinned.apply(x, plc) if x.requires_grad else x


def cs(x: torch.Tensor, *names):
    """Constrain ``x``'s dims (and its gradient's) to the mesh axes the
    logical ``names`` map to (per-dim divisibility-checked; unmapped dims
    replicate)."""
    ctx = _ACTIVE.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    from repro_torch.distributed import sharding as shd
    mesh, rules = ctx
    spec = shd.spec_to_pspec(tuple(x.shape), names, mesh, rules)
    return _constrain(x, shd.placements(spec, mesh))


def cs_like(x: torch.Tensor, like):
    """Constrain ``x`` to the placements of ``like`` (a DTensor, or a
    placement tuple on ``x``'s mesh), e.g. grads -> param layout."""
    ctx = _ACTIVE.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    plc = tuple(like.placements) if isinstance(like, DTensor) else tuple(like)
    return _constrain(x, plc)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands; on DTensors it runs on each rank's
    blocks (``shard_map``'s form of a batched product): every mesh dim that
    shards one of ``a``'s batch labels (a label of both operands and the
    output) keeps that sharding on both operands and the output, every
    other dim of the operands is replicated first. DTensor's own
    propagation flattens the batch dims into one ``bmm`` batch, which some
    torch versions refuse when two of them are sharded (batch over `data`
    and heads over `model`)."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Replicate, Shard
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    a, b = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (a, b))
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    batch = set(la) & set(lb) & set(out)
    pa, pb, po = [], [], []
    for pl in a.placements:
        if isinstance(pl, Shard) and la[pl.dim] in batch:
            lab = la[pl.dim]
            pa.append(pl)
            pb.append(Shard(lb.index(lab)))
            po.append(Shard(out.index(lab)))
        else:
            pa.append(Replicate())
            pb.append(Replicate())
            po.append(Replicate())
    a, b = (t if tuple(t.placements) == tuple(p) else t.redistribute(mesh, p)
            for t, p in ((a, pa), (b, pb)))
    y = torch.einsum(eq, a.to_local(), b.to_local())
    return DTensor.from_local(y, mesh, po, run_check=False)


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis in the active context (1 when inactive/absent).
    Lets model code make divisibility-dependent choices."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return 1
    from repro_torch.distributed import sharding as shd
    return shd.mesh_shape(ctx[0]).get(name, 1)
