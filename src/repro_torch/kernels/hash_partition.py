"""hash_partition: every row's shuffle target and the rows per target.

Replaces the TPU kernel ``repro/kernels/hash_partition.py::hash_partition``
(its ``pl.pallas_call``, a Knuth hash in uint32 lanes plus a one-hot MXU
histogram per block). The CUDA kernel (``csrc/shuffle.cu``) hashes the
keys' low 32 bits in uint32 arithmetic (a key read at its stored width, a
signed one sign-extended, as numpy's ``astype(np.uint64)`` does) and counts
targets in shared memory, grouping a warp's rows by target with
``__match_any_sync``, then adds each block's counters to the global
histogram. It takes any R (no padding rows to subtract) and a key of any
``KEY_DTYPES`` dtype. It carries the shuffle by-product of
plans whose output is not a filter of stored rows: no predicate, an
aggregate shuffled on a group key, or a derived key.

Bound on the card: bytes — the keys read once and 4R bytes of pids
written, at 3.35 TB/s.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, _launch, ref
from repro_torch.kernels.program import DTYPE_CODES

# a bool or integer key at its stored width (a float key's uint64 is
# numpy's platform-defined cast: only the plain version takes one)
KEY_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.uint16,
              torch.int32, torch.uint32, torch.int64, torch.uint64)
MAX_TARGETS = 8192  # csrc/shuffle.cu: shared-memory counters per block


def check_targets(n_parts: int) -> None:
    if not 1 <= n_parts <= MAX_TARGETS:
        raise ValueError(f"{n_parts} targets: the shuffle kernels take 1 to "
                         f"{MAX_TARGETS}")


def hash_partition(keys: torch.Tensor, n_parts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pids (R,) int32, rows per target (P,) int64)."""
    _launch.check_vector(keys, "keys", KEY_DTYPES, keys.device)
    check_targets(n_parts)
    R, dev = keys.shape[0], keys.device
    if dev.type == "cpu":
        return ref.hash_partition(keys, n_parts)
    _launch.reject_device(dev)
    pids = torch.empty(R, dtype=torch.int32, device=dev)
    hist = torch.zeros(n_parts, dtype=torch.int64, device=dev)
    if R:
        max_blocks, stream = _launch.launch_config(dev)
        lib = _build.library("shuffle")
        _launch.raise_on(lib.hash_partition_launch(
            keys.data_ptr(), DTYPE_CODES[keys.dtype], R, n_parts,
            pids.data_ptr(), hist.data_ptr(), max_blocks, stream),
            "hash_partition")
        hash_partition.launches += 1
    return pids, hist


hash_partition.launches = 0
