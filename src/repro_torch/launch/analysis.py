"""Step analysis: cost, memory, collective schedule, roofline (port of
``repro.launch.analysis``).

The reference reads XLA's compiled artifact (``cost_analysis()``,
``memory_analysis()``, the post-SPMD HLO's collectives). The port reads
torch's own sources while a step runs on its abstract arguments (meta
DTensors, see ``steps.StepBundle.trace``):

- ``Recorder``, a ``TorchDispatchMode`` that lets DTensor dispatch first
  and so sees each rank's local ops: for every c10d functional collective
  the kind, its per-rank result bytes (what the reference's HLO parse
  sums) and the group's rank stride, as ``CollectiveOp``s; for every other
  op its input and output bytes (views move none), the unfused upper
  bound that XLA:CPU's ``bytes accessed`` also is; and the FLOPs of the
  local ops by ``torch.utils.flop_counter``'s formulas (the table
  ``FlopCounterMode`` counts with);
- argument and output bytes per device from the abstract trees
  (``tree_bytes``).

Per-layer loops appear once per layer here (the port's layers are Python
loops, nothing is rolled), but the dry run keeps the reference's shallow
(1- and 2-unit) cost pass and its linear extrapolation over depth:
``f(U) = f1 + (f2 - f1) * (U - 1)`` — exact for depth-homogeneous stacks
(f1 = fixed + unit, f2 = fixed + 2*unit).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import H100, HardwareSpec

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0,
}

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d functional collective -> the reference's HLO kind
_FUNCOL_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_per_device: int
    stride: int
    count: int = 1
    f32: bool = False


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_stride(group_name) -> int:
    """Smallest stride between consecutive global ranks of a collective's
    group (1 = neighbours on the fastest mesh dim; >= ranks/pod = crosses
    pods)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = sorted(dist.get_process_group_ranks(
        _resolve_process_group(group_name)))
    if len(ranks) < 2:
        return 1
    return min(b - a for a, b in zip(ranks, ranks[1:]))


class Recorder(TorchDispatchMode):
    """Per-rank collectives, unfused bytes and FLOPs of the ops run inside
    it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self._ops: Dict[tuple, CollectiveOp] = {}
        self.flops = 0
        self.bytes = 0

    @property
    def collectives(self) -> List[CollectiveOp]:
        return list(self._ops.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor first: record its local ops
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCOL_KIND:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            nbytes = sum(_nbytes(t) for t in outs)
            f32 = any(t.dtype == torch.float32 for t in outs)
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            key = (_FUNCOL_KIND[name], nbytes, _group_stride(group), f32)
            if key in self._ops:
                self._ops[key].count += 1
            else:
                self._ops[key] = CollectiveOp(key[0], nbytes, key[2], f32=f32)
            return out
        if ns == "_c10d_functional" or func.is_view:
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes += sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0])
        self.bytes += sum(_nbytes(t) for t in tree_flatten(out)[0])
        return out


def collective_bytes(ops: List[CollectiveOp], chips_per_pod: int = 256
                     ) -> Dict[str, float]:
    """Per-device collective bytes, split ICI/DCN (NVLink / NIC on the
    card). ``*_bf16eq`` halves fp32 ops, as the reference's does; raw
    numbers are kept alongside."""
    ici = dcn = ici_eq = dcn_eq = 0.0
    by_kind: Dict[str, float] = {}
    for op in ops:
        b = op.bytes_per_device * op.count
        beq = b * (0.5 if op.f32 else 1.0)
        by_kind[op.kind] = by_kind.get(op.kind, 0) + b
        if op.stride >= chips_per_pod:
            dcn += b
            dcn_eq += beq
        else:
            ici += b
            ici_eq += beq
    return {"ici": float(ici), "dcn": float(dcn), "by_kind": by_kind,
            "ici_bf16eq": float(ici_eq), "dcn_bf16eq": float(dcn_eq),
            "total": float(ici + dcn)}


# -------------------------------------------------------------- extraction
def tree_bytes(tree) -> int:
    """Bytes per device of a tree's tensors (a DTensor's local shard); a
    module counts its parameters."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    elif hasattr(tree, "_asdict"):  # OptState
        tree = [tree_bytes(v) for v in tree._asdict().values()]
        return sum(tree)
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.nn.Module) or hasattr(t, "_asdict"):
            total += tree_bytes(t)
        elif isinstance(t, DTensor):
            total += _nbytes(t.to_local())
        elif isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def cost_summary(rec: Recorder) -> Dict[str, float]:
    return {"flops": float(rec.flops), "bytes": float(rec.bytes)}


def memory_summary(args, outputs, donated: bool) -> Dict[str, float]:
    """Argument and output bytes per device; a step that donates its
    state (train: parameters and optimizer state updated in place) aliases
    them. Temporaries are not measured on meta tensors."""
    arg_b, out_b = float(tree_bytes(args)), float(tree_bytes(outputs))
    return {"argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": 0.0, "generated_code_bytes": 0.0,
            "alias_bytes": min(arg_b, out_b) if donated else 0.0}


def extrapolate(f1: float, f2: float, units: int) -> float:
    """fixed + unit*U given samples at U=1 and U=2 (exact for linear)."""
    unit = f2 - f1
    fixed = f1 - unit
    return fixed + unit * units


# ---------------------------------------------------- analytic HBM model
def analytic_memory_bytes(cfg, shape, mesh_shape: Dict[str, int],
                          accum: int, kind: str, params_bytes: int,
                          cache_bytes_dev: float = 0.0,
                          remat: bool = True) -> float:
    """Per-device HBM traffic per step under full fusion. Terms:

    - weights: FSDP re-gathers each layer per microbatch; every device
      reads the model-axis shard of the FULL weight set per pass
      (fwd + bwd + remat-recompute for train; once for prefill; the
      resident TP shard once per token for decode),
    - optimizer: m/v fp32 read+write, param read+write, grad read (train),
    - activations: K boundary tensors of (tokens_dev x d_model) x 2B per
      layer per pass (K~14 covers q/kv/mlp partials at their sharded
      widths, norms, residual r/w),
    - KV cache: decode reads the full per-device cache + writes one slot
      (masked-update writes the cache once more: 2x read-equivalent).
    """
    model_n = mesh_shape.get("model", 1)
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    dp_n = chips // model_n

    L = cfg.num_layers
    d = cfg.d_model
    tokens = shape.global_batch * shape.seq_len

    if kind == "decode":
        w = params_bytes / model_n            # TP-resident, read once/token
        acts = 24 * L * (shape.global_batch / max(1, dp_n)) * d * 2
        return w + 2 * cache_bytes_dev + acts
    passes = (3 if remat else 2) if kind == "train" else 1
    w_gathered = params_bytes / model_n       # per device after FSDP gather
    weights = passes * accum * w_gathered
    if kind == "train":
        weights += 24 * params_bytes / 2 / chips  # opt: 24B/param, sharded
    tokens_dev = tokens / max(1, dp_n)
    acts = passes * 14 * L * tokens_dev * d * 2
    return weights + acts + cache_bytes_dev


# -------------------------------------------------------------- roofline
@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dcn_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float          # 6*N*D (active) — "useful" FLOPs, global
    chips: int
    hw: HardwareSpec = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s + self.dcn_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s,
                   self.collective_s + self.dcn_s)

    @property
    def mfu(self) -> float:
        """MODEL_FLOPS / (chips * peak * step_time) — roofline fraction,
        against the peak of the ``HardwareSpec`` the roofline was made
        with."""
        denom = self.chips * self.hw.peak_flops_bf16 * max(self.step_time_s,
                                                           1e-12)
        return self.model_flops / denom

    @property
    def useful_frac(self) -> float:
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops / max(hlo_global, 1.0)


def roofline(flops_dev: float, bytes_dev: float, coll: Dict[str, float],
             model_flops: float, chips: int, hw: HardwareSpec = H100
             ) -> Roofline:
    return Roofline(
        compute_s=flops_dev / hw.peak_flops_bf16,
        memory_s=bytes_dev / hw.hbm_bw,
        collective_s=coll.get("ici", 0.0) / hw.ici_bw,
        dcn_s=coll.get("dcn", 0.0) / hw.dcn_bw,
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        coll_bytes_per_device=coll.get("total", 0.0),
        model_flops=model_flops,
        chips=chips,
        hw=hw,
    )
