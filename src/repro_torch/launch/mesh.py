"""Meshes and the card's roofline constants (port of
``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (not a module-level constant) so
that importing this module never touches a process group: the dry run
starts its fake 256- or 512-rank group first (``launch/dryrun.py``);
everything else sees the ranks that exist.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.sharding import mesh_shape


# ------------------------------------------------------- hardware constants
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """NVIDIA H100 SXM5 80GB at its 700 W power limit, from the data sheet
    (the reference's field names, so records compare). A card set below
    700 W runs slower under load; its measured times are reported beside
    its name and limit."""
    name: str = "h100-sxm5-80gb"
    peak_flops_bf16: float = 989e12      # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12              # HBM3 bytes/s per card
    ici_bw: float = 450e9                # NVLink bytes/s per card, each way
    dcn_bw: float = 50e9                 # one 400 Gb/s NIC per card
    hbm_bytes: int = 80 * 1000 ** 3      # 80 GB


H100 = HardwareSpec()


def _world(n: int, device: Optional[Union[str, torch.device]]) -> str:
    """The device type of a mesh over ``n`` ranks: the process group must
    exist with ``n`` ranks (a ``fake`` one for the dry run, gloo in the
    tests, NCCL on the card)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} ranks over a process group of "
                         f"{dist.get_world_size()}")
    if device is not None:
        return torch.device(device).type
    return "cpu" if dist.get_backend() in ("gloo", "fake") else "cuda"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks `data` x `model`; 2 pods = 512 ranks with `pod`
    for the multi-pod pass. Needs a process group of that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_world(math.prod(shape), None), shape,
                            mesh_dim_names=axes)


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Tuple[str, ...] = ("data", "model"),
                   device: Optional[Union[str, torch.device]] = None
                   ) -> DeviceMesh:
    """Mesh over the ranks that exist: ``(world, 1)`` by default (on one
    card, one NCCL rank: (1, 1)); gloo ranks in the tests."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    return init_device_mesh(_world(math.prod(shape), device), tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_chips(mesh) -> int:
    return int(math.prod(mesh_shape(mesh).values()))


def mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh_shape(mesh).values())
