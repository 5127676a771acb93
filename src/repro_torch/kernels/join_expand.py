"""join_probe and join_expand: the residual's equi-join, from the right
side's sorted keys to the (left row, right row) pairs.

They replace no TPU kernel: the JAX package's ``hash_join``
(``repro/queryproc/operators.py``) expands its matches with numpy's
``np.repeat`` on the host. ``join_pairs`` runs the whole join: ``join_probe``
(each left key's lower bound in the sorted right keys and its number of
matches), one ``torch.cumsum`` of the counts and one host read of the total
(the join's only wait on the card), then ``join_expand`` (every pair, left
rows in order, each row's matches in right-key order). CPU tensors take the
plain versions, ``plain_probe`` and ``plain_expand``: torch's
``searchsorted`` and ``repeat_interleave`` chain, which the port ran on the
card before these kernels.

Bound on the card: bytes. ``join_probe`` reads the left keys and writes 12
bytes a left row; ``join_expand`` reads the scanned counts, ``lo`` and the
sort order, and writes 16 bytes a pair (``csrc/join_expand.cu`` has the
designs).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, _launch

_I64 = (torch.int64,)


def plain_probe(rv_sorted: torch.Tensor, lk: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo (n_left,) int64, cnt (n_left,) int32): each left key's lower
    bound in ``rv_sorted`` and the right keys equal to it."""
    lo = torch.searchsorted(rv_sorted, lk)
    hi = torch.searchsorted(rv_sorted, lk, right=True)
    return lo, (hi - lo).to(torch.int32)


def plain_expand(lo: torch.Tensor, ends: torch.Tensor, r_order: torch.Tensor,
                 n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l_idx, r_idx) (n_out,) int64: left row i repeated for each of its
    matches, which are ``r_order[lo[i]:lo[i] + cnt[i]]``."""
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    l_idx = torch.repeat_interleave(
        torch.arange(len(lo), device=lo.device), counts, output_size=n_out)
    r_idx = r_order[torch.arange(n_out, device=lo.device)
                    - torch.repeat_interleave(ends - counts - lo, counts,
                                              output_size=n_out)]
    return l_idx, r_idx


def join_probe(rv_sorted: torch.Tensor, lk: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo (n_left,) int64, cnt (n_left,) int32) of int64 left keys ``lk``
    against the sorted int64 right keys ``rv_sorted`` (fewer than 2^31)."""
    dev = lk.device
    _launch.check_vector(lk, "lk", _I64, dev)
    _launch.check_vector(rv_sorted, "rv_sorted", _I64, dev)
    if rv_sorted.shape[0] >= 2 ** 31:
        raise ValueError("join_probe takes fewer than 2^31 right keys")
    if dev.type == "cpu":
        return plain_probe(rv_sorted, lk)
    _launch.reject_device(dev)
    n_left, n_right = lk.shape[0], rv_sorted.shape[0]
    lo = torch.empty(n_left, dtype=torch.int64, device=dev)
    cnt = torch.empty(n_left, dtype=torch.int32, device=dev)
    if n_left and n_right:
        lib = _build.library("join_expand")
        _launch.raise_on(lib.join_probe_launch(
            rv_sorted.data_ptr(), n_right, lk.data_ptr(), n_left,
            lo.data_ptr(), cnt.data_ptr(), _launch.sm_count(dev),
            _launch.stream_of(dev)), "join_probe")
        join_probe.launches += 1
    elif n_left:
        lo.zero_()
        cnt.zero_()
    return lo, cnt


def join_expand(lo: torch.Tensor, ends: torch.Tensor, r_order: torch.Tensor,
                n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l_idx, r_idx) (n_out,) int64 from ``join_probe``'s ``lo``, the
    inclusive int64 scan ``ends`` of its counts (``n_out`` =
    ``ends[-1]``, read on the host) and the right rows in key order."""
    dev = lo.device
    _launch.check_vector(lo, "lo", _I64, dev)
    _launch.check_vector(ends, "ends", _I64, dev, lo.shape[0])
    _launch.check_vector(r_order, "r_order", _I64, dev)
    if n_out < 0:
        raise ValueError(f"n_out is {n_out}")
    if dev.type == "cpu":
        return plain_expand(lo, ends, r_order, n_out)
    _launch.reject_device(dev)
    l_idx = torch.empty(n_out, dtype=torch.int64, device=dev)
    r_idx = torch.empty(n_out, dtype=torch.int64, device=dev)
    if n_out:
        lib = _build.library("join_expand")
        n_left = lo.shape[0]
        per = lib.join_expand_items_per_block()
        parts = torch.empty(-(-(n_left + n_out) // per) + 1,
                            dtype=torch.int64, device=dev)
        _launch.raise_on(lib.join_expand_launch(
            ends.data_ptr(), lo.data_ptr(), r_order.data_ptr(), n_left,
            n_out, parts.data_ptr(), parts.shape[0], l_idx.data_ptr(),
            r_idx.data_ptr(), _launch.stream_of(dev)), "join_expand")
        join_expand.launches += 1
    return l_idx, r_idx


def join_pairs(rv_sorted: torch.Tensor, r_order: torch.Tensor,
               lk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l_idx, r_idx): every (left row, right row) pair whose keys are
    equal, left rows in order, each row's matches in the order of
    ``r_order`` (the right rows sorted by key, ``rv_sorted`` their keys)."""
    if not len(lk) or not len(rv_sorted):
        empty = torch.empty(0, dtype=torch.int64, device=lk.device)
        return empty, empty.clone()
    lo, cnt = join_probe(rv_sorted, lk)
    ends = torch.cumsum(cnt, 0, dtype=torch.int64)
    return join_expand(lo, ends, r_order, int(ends[-1]))


join_probe.launches = 0
join_expand.launches = 0
