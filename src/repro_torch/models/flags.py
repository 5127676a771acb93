"""Execution flags of the model zoo (port of ``repro.models.flags``).

- ``attn_impl`` selects the attention form: ``"grouped"`` (GQA einsums over
  a (KV, G) split of the heads, the default) or ``"flat"`` (K/V repeated to
  the head dim). The two differ only in how they shard across a mesh; on
  one device they compute the same values.
- ``moe_impl`` selects the MoE dispatch: ``"dense"`` (capacity dispatch
  into an (E, C, d) buffer, the default) or ``"ep"`` (expert parallelism,
  ``moe.apply_moe_ep``: inside an ``activation_sharding`` context each
  rank runs only its experts; without a context, without a `model` axis
  or with an expert count that does not divide it, the dense dispatch).
- ``unroll_scans`` had the reference's cost pass unroll ``lax.scan``; the
  port's layer loops are Python loops already, so it changes nothing and
  stays for callers that use its name.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterable, List, Tuple

_ATTN_IMPL = contextvars.ContextVar("repro_torch_attn_impl",
                                    default="grouped")

_MOE_IMPL = contextvars.ContextVar("repro_torch_moe_impl", default="dense")

ATTN_IMPLS = ("grouped", "flat")
MOE_IMPLS = ("dense", "ep")


@contextlib.contextmanager
def unroll_scans(enable: bool = True):
    """No effect: every layer and block loop is a Python loop."""
    yield


def maybe_scan(body: Callable, init: Any, xs: Iterable
               ) -> Tuple[Any, List[Any]]:
    """``lax.scan`` as a Python loop: ``carry, y = body(carry, x)`` for each
    ``x`` of ``xs``; returns the last carry and the list of ``y``."""
    carry, ys = init, []
    for x in xs:
        carry, y = body(carry, x)
        ys.append(y)
    return carry, ys


@contextlib.contextmanager
def moe_impl(kind: str):
    """``"dense"`` or ``"ep"`` (see the module docstring)."""
    if kind not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {kind!r}; expected {MOE_IMPLS}")
    tok = _MOE_IMPL.set(kind)
    try:
        yield
    finally:
        _MOE_IMPL.reset(tok)


def current_moe_impl() -> str:
    return _MOE_IMPL.get()


@contextlib.contextmanager
def attn_impl(kind: str):
    """``"grouped"`` or ``"flat"`` (see the module docstring)."""
    if kind not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {kind!r}; expected {ATTN_IMPLS}")
    tok = _ATTN_IMPL.set(kind)
    try:
        yield
    finally:
        _ATTN_IMPL.reset(tok)


def current_attn_impl() -> str:
    return _ATTN_IMPL.get()
