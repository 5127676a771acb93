"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Three kernels carry this slice's path: ``predicate_bitmap``,
``fused_scan_agg`` and ``grouped_agg`` (sources in ``csrc/``, built by
``_build`` at first use). Each wrapper counts its launches in a plain
integer attribute, ``<wrapper>.launches``.
"""
from repro_torch.kernels import fused_scan_agg as _fsa
from repro_torch.kernels import grouped_agg as _ga
from repro_torch.kernels import predicate_bitmap as _pb

WRAPPERS = {"predicate_bitmap": _pb.predicate_bitmap,
            "fused_scan_agg": _fsa.fused_scan_agg,
            "grouped_agg": _ga.grouped_agg}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}
