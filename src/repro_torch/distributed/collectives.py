"""Explicit collectives: the paper's shuffle as an in-mesh primitive and
distributed-optimization tricks (port of ``repro.distributed.collectives``).

- ``expert_all_to_all_dispatch``: the in-mesh analogue of distributed-
  data-shuffle pushdown (§4.2). Tokens are hash-routed to expert shards
  with ONE all-to-all from the producer — Fig 5(b)'s "partition at the
  source, send straight to the target" applied to the TP mesh.

- ``compressed_psum``: int8 error-feedback gradient all-reduce. Gradients
  quantize to int8 with a per-tensor scale; the quantization error feeds
  back into the next step's gradient. Cross-pod traffic drops 4x for f32
  grads.

The reference's ``shard_map`` becomes: a DTensor argument is redistributed
to the ``in_specs`` placements and its local block taken (a plain tensor
is taken as this rank's block already), the body runs on local tensors
with the mesh axis's process group, and a DTensor argument gets a DTensor
back with the ``out_specs`` placements. The collectives are the c10d
functional ones (``torch.distributed._functional_collectives``), in their
autograd forms where a gradient flows.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd


def _local(x: torch.Tensor, mesh, pspec) -> torch.Tensor:
    """The block of ``x`` that ``pspec`` gives this rank (``shard_map``'s
    ``in_specs``)."""
    if not isinstance(x, DTensor):
        return x
    plc = shd.placements(pspec, mesh)
    if tuple(x.placements) != plc:
        x = x.redistribute(mesh, plc)
    return x.to_local()


def _wrap(local: torch.Tensor, like: torch.Tensor, mesh, pspec):
    """``shard_map``'s ``out_specs``: a DTensor when the argument was one,
    else the local block."""
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, mesh, shd.placements(pspec, mesh),
                              run_check=False)


def _n(mesh, axis: str) -> int:
    return shd.mesh_shape(mesh)[axis]


# ---------------------------------------------------------- EP dispatch
def expert_all_to_all_dispatch(x_by_expert: torch.Tensor, mesh,
                               axis: str = "model") -> torch.Tensor:
    """(E, C, d) token buffer, C sharded over ``axis`` at the *producer*
    (each shard scattered its local tokens into all E expert slots) ->
    buffer where shard i holds ONLY its experts' rows from every producer,
    E sharded over ``axis``, i.e. the post-shuffle layout. One all-to-all
    (split the expert dim into n groups, group j to shard j, concatenate
    what arrives along C); no all-gather."""
    E = x_by_expert.shape[0]
    n = _n(mesh, axis)
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} shards")
    local = _local(x_by_expert, mesh, (None, axis, None))
    El, Cl = E // n, local.shape[1]
    out = funcol.all_to_all_single_autograd(
        local.contiguous(), None, None, mesh.get_group(axis))
    # (n producers, E_local, C_local, d) -> (E_local, n * C_local, d)
    out = out.reshape(n, El, Cl, -1).transpose(0, 1).reshape(El, n * Cl, -1)
    return _wrap(out, x_by_expert, mesh, (axis, None, None))


def expert_all_to_all_combine(y_by_expert: torch.Tensor, mesh,
                              axis: str = "model") -> torch.Tensor:
    """Inverse of the dispatch (expert results back to producers): split
    C into n groups, group j to shard j, concatenate along E."""
    n = _n(mesh, axis)
    local = _local(y_by_expert, mesh, (axis, None, None))
    El, C = local.shape[0], local.shape[1]
    if C % n:
        raise ValueError(f"capacity {C} does not split over {n} shards")
    # (E_local, n, C/n, d) -> (n, E_local, C/n, d): chunk j goes to shard j
    send = local.reshape(El, n, C // n, -1).transpose(0, 1).contiguous()
    out = funcol.all_to_all_single_autograd(
        send.reshape(n * El, C // n, -1), None, None, mesh.get_group(axis))
    return _wrap(out, y_by_expert, mesh, (None, axis, None))


# ------------------------------------------------- compressed all-reduce
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grad: torch.Tensor, err: torch.Tensor, mesh,
                    axis: str = "pod") -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over ``axis``.

    grad: this shard's gradient contribution (f32), err: carried
    quantization error from the previous step (same shape); as DTensors,
    their leading dim sharded over ``axis`` (the reference's ``P(axis)``),
    or as this rank's blocks. Returns (reduced gradient estimate, new
    error). Traffic: 1 byte/elem over ``axis`` instead of 4 (plus one
    scalar)."""
    n = _n(mesh, axis)
    if n == 1:
        # degenerate mesh: nothing to reduce, but the carried error MUST
        # still fold into the estimate (dropping it would bias error
        # feedback): approx + new_err == g + e
        return grad + err, torch.zeros_like(err)
    group = mesh.get_group(axis)
    g, e = _local(grad, mesh, (axis,)), _local(err, mesh, (axis,))
    v = g + e
    # agree on a COMMON scale first (one scalar all-reduce) so the integer
    # sum dequantizes exactly; per-element error is then only each shard's
    # own rounding, which the feedback carries forward
    amax = funcol.all_reduce(torch.clamp(v.abs().max(), min=1e-30), "max",
                             group)
    scale = funcol.wait_tensor(amax) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    new_err = v - q.float() * scale
    total = funcol.wait_tensor(funcol.all_reduce(q.to(torch.int32), "sum",
                                                 group))
    approx = total.float() * scale
    return (_wrap(approx, grad, mesh, (axis,)),
            _wrap(new_err, err, mesh, (axis,)))
