"""Logical-axis -> mesh-axis sharding rules as DTensor placements (port of
``repro.distributed.sharding``).

Every ParamSpec in the model zoo carries *logical* axis names
("embed", "heads", "mlp", "experts", "vocab", "batch", "kv_seq", ...).
This module turns a spec tree into placements on a concrete
``DeviceMesh``.

Baseline layout (the reference's "eager" distribution):

- FSDP  : "embed" (the d_model dim present in every matmul weight) shards
          over the `data` axis -> ZeRO-3-style weight/grad/opt-state sharding.
- TP    : "heads"/"kv_heads"/"mlp"/"inner"/"experts"/"vocab" shard over
          `model` (Megatron-style).
- DP    : "batch" shards over (`pod`, `data`) — the pod axis is pure DP.
- SP    : "kv_seq" (decode KV caches) shards over `model`.

A rule is applied *only if divisible* and only if the mesh axis is not
already consumed by an earlier dim of the same tensor; otherwise the dim
falls through to the next candidate axis (or replication).

``spec_to_pspec`` returns the reference's canonical ``PartitionSpec`` as a
tuple: one entry per tensor dim (an axis name, a tuple of names, or None),
trailing Nones trimmed. It reads only ``mesh.shape`` as a name -> size
mapping, so a duck-typed mesh works; ``mesh_shape`` gives a
``DeviceMesh``'s. ``placements`` turns such a tuple into one DTensor
``Placement`` per mesh dim: a tensor dim sharded over ``("pod", "data")``
is ``Shard(i)`` on both mesh dims.

Layers: the reference stacks layers on leading axes, and the port's
modules hold them unstacked in ``(u, j)`` order. ``"layers"`` never shards
(``BASELINE_RULES["layers"] == ()``), so ``tree_shardings`` and
``abstract`` place the *stacked* tree and the family's module unstacks it
by indexing each DTensor: a layer's placement is the stacked spec's
placement without its leading stacked dims.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import params as Pm

# logical axis -> ordered candidate mesh axes. Each candidate is either a
# mesh-axis name or a tuple of names (sharded over their product).
Rules = Dict[Optional[str], Tuple]

BASELINE_RULES: Rules = {
    "embed": ("data",),
    "vocab": ("model",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "inner2": (),          # second dim of square recurrent mats: replicated
    "layers": (),          # stacked layer dim: never sharded
    "batch": (("pod", "data"), "data"),
    "kv_seq": ("model",),
    "kv_hd": (),           # kv head_dim: sharded only when kv_heads can't be
    "act_seq": (),         # residual-stream sequence dim (SP rules enable)
    "attn_seq": ("model",),  # context-parallel fallback inside attention when
                             # the head count doesn't divide the model axis
    None: (),
}

# Serving layout: no FSDP (per-token weight all-gathers would dominate
# decode). Weights shard over `model` on heads/mlp/vocab, and over kv
# head_dim when the kv-head count doesn't divide the axis; `data` carries
# the batch and the KV-cache; `kv_seq` takes `model`.
INFERENCE_RULES: Rules = dict(
    BASELINE_RULES,
    embed=(),
    kv_hd=("model",),
    # 2D expert sharding: experts take `model`, the ffn dim falls through
    # to `data`
    mlp=("model", "data"),
)

# sequence-parallel residual stream: activations stay sharded on the seq
# dim over `model` between attention/MLP blocks
SP_RULES: Rules = dict(BASELINE_RULES, act_seq=("model",))

# fully-sharded states (FSDP over data *and* pod) + sequence-parallel
# activations
ZERO3_POD_RULES: Rules = dict(
    BASELINE_RULES,
    embed=(("pod", "data"), "data"),
    act_seq=("model",),
)

# assignment priority: TP-critical names first, then FSDP/batch, then
# sequence fallbacks — so e.g. `attn_seq` only takes `model` when the head
# dim couldn't (40 heads on a 16-wide axis).
_PRIORITY = {
    "vocab": 0, "experts": 0,
    "heads": 1, "kv_heads": 1, "mlp": 1, "inner": 1,
    "kv_hd": 2,
    "embed": 3,
    "batch": 4,
    "kv_seq": 5, "attn_seq": 5, "act_seq": 5,
}

PSpec = Tuple  # the reference's PartitionSpec, as a tuple


def mesh_shape(mesh) -> Dict[str, int]:
    """A mesh's axis name -> size mapping: a ``DeviceMesh``'s, or the
    ``shape`` dict of a duck-typed mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: Dict[str, int], cand) -> int:
    return math.prod(shape[n] for n in _cand_names(cand))


def _cand_names(cand) -> Tuple[str, ...]:
    return cand if isinstance(cand, tuple) else (cand,)


def spec_to_pspec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                  mesh, rules: Rules) -> PSpec:
    """Greedy assignment of mesh axes to tensor dims, in _PRIORITY order
    (ties broken left-to-right), each mesh axis used at most once."""
    ms = mesh_shape(mesh)
    used: set = set()
    out = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda i: (_PRIORITY.get(axes[i], 9), i))
    for i in order:
        dim, name = shape[i], axes[i]
        for cand in rules.get(name, ()):
            names = _cand_names(cand)
            if any(n not in ms for n in names):
                continue
            if any(n in used for n in names):
                continue
            if dim % _axis_size(ms, cand) != 0 or dim == 0:
                continue
            out[i] = cand
            used.update(names)
            break
    # trim trailing Nones (canonical PartitionSpec form)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_pspecs(spec_tree, mesh, rules: Rules = BASELINE_RULES):
    return Pm.tree_map_specs(
        lambda s: spec_to_pspec(s.shape, s.axes, mesh, rules), spec_tree)


def batch_pspec(mesh, rules: Rules = BASELINE_RULES) -> PSpec:
    """PartitionSpec entry for a batch dim under these rules."""
    return spec_to_pspec((1 << 30,), ("batch",), mesh, rules)


def batch_axes(mesh, rules: Rules = BASELINE_RULES) -> Tuple[str, ...]:
    ps = batch_pspec(mesh, rules)
    if not ps:
        return ()
    e = ps[0]
    return e if isinstance(e, tuple) else (e,)


# ------------------------------------------------------- DTensor placements
def placements(pspec: Sequence, device_mesh) -> Tuple:
    """One DTensor placement per mesh dim for a PartitionSpec tuple: mesh
    dim ``a`` is ``Shard(i)`` when tensor dim ``i``'s entry names ``a``,
    else ``Replicate()``. A mesh dim of size 1 holds the whole tensor, so
    it replicates (on one rank every op is then a plain local op)."""
    out = [Replicate()] * device_mesh.ndim
    names = list(device_mesh.mesh_dim_names)
    sizes = mesh_shape(device_mesh)
    for i, entry in enumerate(pspec):
        if entry is None:
            continue
        for a in _cand_names(entry):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(i)
    return tuple(out)


def _local_shard(t: torch.Tensor, device_mesh, plc) -> torch.Tensor:
    """This rank's block of ``t`` under ``plc`` (a view; each mesh dim
    narrows its tensor dim by its coordinate, in mesh-dim order, which is
    the order DTensor splits a dim sharded over several mesh dims)."""
    coord = device_mesh.get_coordinate()
    for md, pl in enumerate(plc):
        if isinstance(pl, Shard):
            n = device_mesh.size(md)
            step = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[md] * step, step)
    return t


def distribute(t: torch.Tensor, device_mesh, pspec: Sequence,
               copy: bool = False) -> DTensor:
    """``t`` (the same global value on every rank) as a DTensor with
    ``pspec``'s placements: each rank keeps its block, with no
    communication; a view of ``t`` (on a one-rank mesh ``t`` itself), or
    a copy of the block with ``copy``."""
    plc = placements(pspec, device_mesh)
    block = _local_shard(t, device_mesh, plc)
    return DTensor.from_local(block.clone() if copy else block, device_mesh,
                              plc, run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute_tree(tree, spec_tree, device_mesh,
                    rules: Rules = BASELINE_RULES):
    """A stacked tree of tensors as DTensors, leaf by leaf with its spec's
    placements."""
    def one(s, t):
        return distribute(t, device_mesh,
                          spec_to_pspec(s.shape, s.axes, device_mesh, rules))
    return _zip_map(one, spec_tree, tree)


def _zip_map(fn, specs, tree):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, specs[k], tree[k]) for k in specs}
    return fn(specs, tree)


def tree_shardings(params: nn.Module, device_mesh,
                   rules: Rules = BASELINE_RULES) -> nn.Module:
    """A family's parameter module distributed over ``device_mesh``: its
    stacked tree placed leaf by leaf, unstacked again by the family's
    module. Each rank copies its blocks, so updating the result in place
    (a train step) leaves ``params`` as it was."""
    from repro_torch.models import api

    def one(s, t):
        return distribute(t, device_mesh, spec_to_pspec(
            s.shape, s.axes, device_mesh, rules), copy=True)
    return type(params)(params.cfg, _zip_map(one, api.init_specs(params.cfg),
                                             params.tree()))


def meta_dtensor(shape, dtype, device_mesh, pspec: Sequence) -> DTensor:
    """A meta DTensor (no storage) of global ``shape`` under ``pspec``: the
    torch form of a ``ShapeDtypeStruct`` with a ``NamedSharding``."""
    return distribute(torch.empty(shape, dtype=dtype, device="meta"),
                      device_mesh, pspec)


def abstract(spec_tree, device_mesh, rules: Rules = BASELINE_RULES):
    """Meta DTensor tree in the stacked layout (the dry run's input)."""
    return Pm.tree_map_specs(
        lambda s: meta_dtensor(s.shape, s.dtype, device_mesh,
                               spec_to_pspec(s.shape, s.axes, device_mesh,
                                             rules)), spec_tree)


def pspec_of(x: DTensor) -> PSpec:
    """The PartitionSpec tuple of a DTensor's placements (the inverse of
    ``placements`` on mesh dims of more than one rank; mesh dims sharding
    one tensor dim are listed in mesh order)."""
    names = x.device_mesh.mesh_dim_names
    out = [[] for _ in range(x.ndim)]
    for md, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            out[pl.dim].append(names[md])
    ps = [None if not e else (e[0] if len(e) == 1 else tuple(e))
          for e in out]
    while ps and ps[-1] is None:
        ps.pop()
    return tuple(ps)
