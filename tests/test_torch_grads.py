"""The port's gradients of ``loss_fn`` against ``jax.grad`` of the JAX
package's, on the CPU, for the generic families (dense, MoE, llama4's
units, the VLM prefix); ``tests/test_torch_grads_recurrent.py`` holds
mamba2, recurrentgemma and whisper with the same checks.

Parameters come from ``repro.models.api.init_params(PRNGKey(0))`` at the
reduced config and are carried over bit for bit; the batch is (2, 32)
tokens from a seeded numpy generator (whisper adds ``frames``, llava
``patches``, drawn in bf16). The reference's gradient is ``jax.jit`` of
``jax.grad(loss_fn)``; the port's is autograd's, leaf by leaf in the
reference's stacked layout.

- fp32 (the parameters and inputs widened exactly on both sides): every
  leaf within 1e-4 of its norm (``FP32_TOL``). Both sides compute the same
  fp32 arithmetic in different orders: the largest difference seen is
  2.3e-5 of a leaf's norm (mamba2's SSD), the other families' ~5e-7.
- bf16: the whole gradient within the models' 2e-2 of its norm
  (``BF16_TOL``; at most 0.0093 seen, mamba2), and each leaf's error
  against the fp32 gradient at most twice the reference's own plus 1e-3
  of the leaf's norm (``BF16_RATIO``; at most 1.62x seen). Both packages
  round their bf16 arithmetic in their own order (XLA rounds at the ends
  of its fusions, eager torch after each op), so on a few small leaves
  each side's bf16 gradient sits 2-4% off the fp32 one (mamba2's 16
  ``A_log`` entries: the port 0.042, the reference 0.026), and the two
  as far from each other; a per-leaf 2e-2 between them would hold bf16
  noise, not the port. What is held per leaf is that the port's bf16
  gradient is about as accurate as the reference's.
- ``remat=True`` and ``remat="dots"`` give the gradients of no remat bit
  for bit: recomputation runs the same ops on the same inputs.
- The MoE families again in fp32 at a capacity factor that drops slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import api as rapi
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api
from repro_torch.models import params as P

FP32_TOL = 1e-4
BF16_TOL = 2e-2
BF16_RATIO = 2.0
GENERIC = [a for a in ARCH_IDS
           if get_config(a, reduced=True).family in ("dense", "moe", "vlm")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, and the tier-1 run puts
    several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, dtype):
    """(the reference's batch, the port's): (2, 32) tokens, whisper's
    frames and llava's patches drawn in bf16, then cast to ``dtype``
    (exact when widening)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    extra = {"audio": ("frames", (cfg.num_audio_frames, cfg.d_model)),
             "vlm": ("patches", (cfg.num_patches, cfg.patch_dim))}
    if cfg.family in extra:
        name, shape = extra[cfg.family]
        x = jnp.asarray(rng.normal(size=(2,) + shape), jnp.bfloat16
                        ).astype(dtype)
        rb[name], tb[name] = x, P.to_torch(np.asarray(x), "cpu")
    return rb, tb


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _configs(arch, overrides):
    """(the reference's reduced config, the port's), with ``overrides``."""
    return (dataclasses.replace(rget_config(arch, reduced=True), **overrides),
            dataclasses.replace(get_config(arch, reduced=True), **overrides))


def reference_grads(arch, dtype, overrides=None):
    rcfg, _ = _configs(arch, overrides or {})
    rp = jax.tree.map(lambda a: a.astype(dtype),
                      rapi.init_params(rcfg, jax.random.PRNGKey(0)))
    rb, _ = _batch(rcfg, dtype)
    g = jax.jit(jax.grad(lambda p, b: rapi.loss_fn(p, rcfg, b)))(rp, rb)
    return rp, dict(_leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                         g)))


def port_grads(arch, rp, dtype, remat=False, overrides=None):
    """The port's gradients on the reference's parameters ``rp`` and the
    batch in ``dtype`` (a JAX dtype), as (path -> float32 array) in the
    stacked layout."""
    _, cfg = _configs(arch, overrides or {})
    model = api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu")
    _, tb = _batch(cfg, dtype)
    model.requires_grad_(True)
    plist = list(model.parameters())
    grads = torch.autograd.grad(api.loss_fn(model, cfg, tb, remat=remat),
                                plist, allow_unused=True)
    # the family's own module stacks them: a copy whose parameters hold
    # the gradients
    shell = type(model)(cfg, model.tree())
    for p, g in zip(shell.parameters(), grads):
        p.data = torch.zeros_like(p) if g is None else g
    return dict(_leaves(P.tree_map_specs(lambda t: t.float().numpy(),
                                         shell.tree())))


def norm(a) -> float:
    return float(np.linalg.norm(a.ravel()))


def check_fp32(arch, overrides=None):
    """Every leaf of the fp32 gradients within ``FP32_TOL`` of its norm;
    returns the reference's."""
    rp32, r32 = reference_grads(arch, jnp.float32, overrides)
    p32 = port_grads(arch, rp32, jnp.float32, overrides=overrides)
    assert sorted(p32) == sorted(r32)
    for k, want in r32.items():
        n = norm(want)
        assert norm(p32[k] - want) <= FP32_TOL * n + 1e-30, (k, n)
    return r32


def check_family(arch):
    r32 = check_fp32(arch)
    rp16, r16 = reference_grads(arch, jnp.bfloat16)
    p16 = port_grads(arch, rp16, jnp.bfloat16)
    assert sorted(p16) == sorted(r32)
    for k, want in r32.items():
        n = norm(want)
        e_port, e_ref = norm(p16[k] - want), norm(r16[k] - want)
        assert e_port <= BF16_RATIO * e_ref + 1e-3 * n, (k, e_port, e_ref)
    flat = lambda g: np.concatenate([g[k].ravel() for k in sorted(g)])  # noqa: E731
    assert norm(flat(p16) - flat(r16)) <= BF16_TOL * norm(flat(r16))
    for remat in (True, "dots"):
        got = port_grads(arch, rp16, jnp.bfloat16, remat)
        assert all(np.array_equal(got[k], p16[k]) for k in p16), remat


@pytest.mark.parametrize("arch", GENERIC)
def test_gradients_match_the_reference(arch):
    check_family(arch)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_moe_gradients_with_dropped_slots_match_the_reference(arch):
    """At a capacity factor of 0.25 each expert keeps 8 of its ~16 routed
    slots (at 1.25, the reduced configs' own, none is dropped on this
    batch): the dispatch's accumulating put and the combine's gather
    differentiate as the reference's scatter and gather do (fp32)."""
    check_fp32(arch, {"capacity_factor": 0.25})


def test_the_generic_cases_cover_seven_families():
    assert len(GENERIC) == 7
