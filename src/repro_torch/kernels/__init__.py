"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Six kernels, one for each TPU kernel of the JAX package:
``predicate_bitmap``, ``fused_scan_agg`` and ``grouped_agg`` carry the
pushed filters and aggregates; ``bitmap_apply``, ``hash_partition`` and
``fused_scan_shuffle`` the §4.2 selection bitmap and shuffle. Two more,
``join_probe`` and ``join_expand``, replace no TPU kernel: they carry the
residual's equi-join, which the JAX package runs on the host (sources in
``csrc/``, built by ``_build`` at first use). Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``.
"""
from repro_torch.kernels import bitmap_apply as _ba
from repro_torch.kernels import fused_scan_agg as _fsa
from repro_torch.kernels import fused_scan_shuffle as _fss
from repro_torch.kernels import grouped_agg as _ga
from repro_torch.kernels import hash_partition as _hp
from repro_torch.kernels import join_expand as _je
from repro_torch.kernels import predicate_bitmap as _pb

WRAPPERS = {"predicate_bitmap": _pb.predicate_bitmap,
            "fused_scan_agg": _fsa.fused_scan_agg,
            "grouped_agg": _ga.grouped_agg,
            "bitmap_apply": _ba.bitmap_apply,
            "hash_partition": _hp.hash_partition,
            "fused_scan_shuffle": _fss.fused_scan_shuffle,
            "join_probe": _je.join_probe,
            "join_expand": _je.join_expand}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}
