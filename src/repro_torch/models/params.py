"""Parameter-spec trees (port of ``repro.models.params``).

Model ``init_specs`` functions return nested dicts of ``ParamSpec``: shape,
dtype, logical axis names (one per dim) and an initializer. Layers are
stacked on leading axes as in the reference, so a tree has the reference's
layout leaf for leaf:

- ``materialize(specs, generator, device)``: tensors drawn with the
  reference's distributions (fan-in scaled normal, ones, zeros, mamba2's
  ``A_log`` as the log of a uniform draw on [1, 16]);
- ``from_reference(tree, device)``: the reference's parameters, given as
  numpy arrays, as tensors (bf16 carried over bit for bit);
- ``count`` / ``bytes_of``: sizes without allocating.

Each family's model module (``transformer.Decoder``,
``mamba_model.MambaLM``, ``hybrid.HybridLM``, ``whisper.EncoderDecoder``)
unstacks such a tree into its layers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | ssm_a
    scale: float = 0.02


def p(shape, axes, dtype=torch.bfloat16, init="normal", scale=0.02
      ) -> ParamSpec:
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return ParamSpec(shape, axes, dtype, init, scale)


def tree_map_specs(fn, tree):
    """``fn`` over every leaf of a nested dict (of specs, or of tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ssm_a":  # A_log in [log 1, log 16] as in mamba2
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device) * 15.0 + 1.0
        return torch.log(u).to(spec.dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown initializer {spec.init!r}")
    # fan-in scaled normal for >=2D, plain normal otherwise
    std = spec.scale
    if len(spec.shape) >= 2:
        std = min(spec.scale, 1.0 / math.sqrt(spec.shape[-2]))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(spec.dtype)


def materialize(specs, generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Real tensors for a spec tree, drawn in leaf order from
    ``generator`` (which must live on ``device``)."""
    return tree_map_specs(lambda s: _init_leaf(s, generator, device), specs)


def to_torch(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``. A bf16 array
    (``ml_dtypes.bfloat16``, what ``np.asarray`` gives for a JAX bf16
    array) goes over as its 16-bit pattern, which ``torch.from_numpy``
    would refuse."""
    a = np.asarray(a)
    if not a.flags.writeable:  # a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .view(np.int16)).view(torch.bfloat16
                                                      ).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_reference(tree, device: torch.device) -> Dict[str, Any]:
    """The reference's parameter tree (numpy arrays, stacked layers) as a
    tree of tensors on ``device``, bit for bit."""
    return tree_map_specs(lambda a: to_torch(a, device), tree)


def count(specs) -> int:
    return int(sum(math.prod(s.shape) for s in leaves(specs)))


def bytes_of(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in leaves(specs)))
