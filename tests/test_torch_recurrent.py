"""The port's SSD, RG-LRU and whisper encoder functions against the JAX
package's, on the CPU, and recurrentgemma's ring quirk.

Parameters are one layer of ``repro.models.api.init_params`` at the
reduced configs, carried over bit for bit. Outputs, states and decode
caches must match within rtol = atol = 2e-2, the model tests' tolerance:
both sides compute the projections in bf16 and the recurrences in fp32,
the RG-LRU's scan in another order of additions than XLA's tree. The
activations are bitwise: ``layers.silu``/``gelu_tanh`` compute as XLA
does ``jax.nn.silu``/``gelu`` in bf16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import api as rapi
from repro.models import rglru as rrglru
from repro.models import ssm as rssm
from repro.models import whisper as rwhisper
from repro_torch.configs import get_config
from repro_torch.models import api, layers, rglru, ssm, whisper
from repro_torch.models import params as P

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, and the tier-1
    run puts several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, key=0):
    return rapi.init_params(rget_config(arch, reduced=True),
                            jax.random.PRNGKey(key))


def _layer(arch, *path):
    """Layer 0 of a stacked parameter sub-tree, on both sides."""
    tree = _ref_params(arch)
    for k in path:
        tree = tree[k]
    ref = jax.tree.map(lambda a: a[0], tree)
    return ref, P.from_reference(jax.tree.map(np.asarray, ref), "cpu")


def _bf16(rng, shape, scale=1.0):
    a = jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)
    return a, P.to_torch(np.asarray(a), "cpu")


def _close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


# ------------------------------------------------------------------ SSD
@pytest.mark.parametrize("T,with_state", [(32, False), (45, False),
                                          (32, True), (64, True), (7, False)])
def test_ssd_forward_matches_the_reference(T, with_state):
    """One chunk (T = Q = 32), a ragged T (45 and 7 pad to chunk
    multiples), two chunks, and a carried ``init_state``: outputs, the
    final state and the decode cache (the pre-conv tails)."""
    rcfg, cfg = rget_config("mamba2-2.7b", True), get_config("mamba2-2.7b",
                                                              True)
    rprm, tprm = _layer("mamba2-2.7b", "layers", "ssm")
    rng = np.random.default_rng(T)
    rx, tx = _bf16(rng, (2, T, cfg.d_model))
    rh = th = None
    if with_state:
        h0 = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state)).astype(np.float32) * 0.1
        rh, th = jnp.asarray(h0), torch.from_numpy(h0)
    ry, rstate = rssm.ssd_forward(rx, rprm, rcfg, init_state=rh)
    ty, tstate = ssm.ssd_forward(tx, tprm, cfg, init_state=th)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == ry.shape
    assert tstate.dtype == torch.float32
    _close(ty, ry)
    _close(tstate, rstate)
    _, rcache = rssm.ssd_forward(rx, rprm, rcfg, init_state=rh,
                                 return_cache=True)
    _, tcache = ssm.ssd_forward(tx, tprm, cfg, init_state=th,
                                return_cache=True)
    assert sorted(tcache) == sorted(rcache)
    for k in ("conv_x", "conv_B", "conv_C"):  # the projections: bitwise
        assert tuple(tcache[k].shape) == rcache[k].shape
        np.testing.assert_array_equal(f32(tcache[k]), f32(rcache[k]))
    _close(tcache["h"], rcache["h"])


def test_ssd_padding_leaves_the_outputs_unchanged():
    """Padded steps have dt = 0, decay 1 and zero input: a 45-step run
    (padded to 64) gives the first 45 outputs of a 64-step run, and a
    13-step run (padded to 32) those of a 32-step one. The state after
    padding is held by the decode test (20 steps, padded to 32)."""
    cfg = get_config("mamba2-2.7b", True)
    _, tprm = _layer("mamba2-2.7b", "layers", "ssm")
    rng = np.random.default_rng(1)
    _, tx = _bf16(rng, (1, 64, cfg.d_model))
    y64, _ = ssm.ssd_forward(tx, tprm, cfg)
    for T in (45, 13):
        yT, _ = ssm.ssd_forward(tx[:, :T], tprm, cfg)
        _close(yT, y64[:, :T])


def test_ssd_decode_step_matches_the_reference():
    rcfg, cfg = rget_config("mamba2-2.7b", True), get_config("mamba2-2.7b",
                                                              True)
    rprm, tprm = _layer("mamba2-2.7b", "layers", "ssm")
    rng = np.random.default_rng(2)
    rx, tx = _bf16(rng, (2, 20, cfg.d_model))
    _, rcache = rssm.ssd_forward(rx, rprm, rcfg, return_cache=True)
    _, tcache = ssm.ssd_forward(tx, tprm, cfg, return_cache=True)
    rs, ts = _bf16(rng, (2, 1, cfg.d_model))
    ry, rnew = rssm.ssd_decode_step(rs, rprm, rcfg, rcache)
    ty, tnew = ssm.ssd_decode_step(ts, tprm, cfg, tcache)
    _close(ty, ry)
    for k in rnew:
        assert tuple(tnew[k].shape) == rnew[k].shape and \
            tnew[k].dtype == tcache[k].dtype
        _close(tnew[k], rnew[k])
    # decode after 20 prefilled steps = step 21 of one forward
    full, _ = ssm.ssd_forward(torch.cat([tx, ts], 1), tprm, cfg)
    _close(ty[:, 0], full[:, -1])


def test_ssm_cache_specs_and_conv_forms():
    """The cache layout, and the two causal convs: the SSD's ends in silu,
    the RG-LRU's does not (both bitwise against the reference's)."""
    rcfg, cfg = rget_config("mamba2-2.7b", True), get_config("mamba2-2.7b",
                                                              True)
    specs = ssm.ssm_cache_specs(cfg, 3, (cfg.num_layers,))
    rspecs = rssm.ssm_cache_specs(rcfg, 3, (rcfg.num_layers,))
    assert {k: (s.shape, s.dtype.itemsize) for k, s in specs.items()} == \
        {k: (s.shape, jnp.dtype(s.dtype).itemsize) for k, s in rspecs.items()}
    rng = np.random.default_rng(3)
    rx, tx = _bf16(rng, (2, 9, 16))
    rw, tw = _bf16(rng, (4, 16), 0.5)
    np.testing.assert_array_equal(f32(ssm._causal_conv(tx, tw)),
                                  f32(rssm._causal_conv(rx, rw)))
    np.testing.assert_array_equal(f32(ssm.shift_sum_conv(tx, tw)),
                                  f32(rrglru._conv(rx, rw)))


def test_ssm_a_draws_log_uniform():
    spec = P.p((1 << 16,), (None,), dtype=torch.float32, init="ssm_a")
    a = P.materialize({"a": spec}, torch.Generator().manual_seed(0),
                      torch.device("cpu"))["a"]
    assert a.dtype == torch.float32
    assert 0.0 <= float(a.min()) < 0.01 and \
        np.log(16.0) - 0.01 < float(a.max()) <= np.log(16.0)
    # E[log U], U ~ uniform(1, 16): (16 ln 16 - 15) / 15
    assert abs(float(a.mean()) - (16 * np.log(16.0) - 15) / 15) < 0.01


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_activations_compute_as_xla_does(dtype, jdtype):
    """bf16: bitwise; fp32: within 1e-6 (XLA's exp and tanh are its own
    approximations)."""
    x = jnp.asarray(np.random.default_rng(4).normal(size=(50_000,)) * 3,
                    jdtype)
    tx = P.to_torch(np.asarray(x), "cpu")
    for mine, theirs in ((layers.silu, jax.nn.silu),
                         (layers.gelu_tanh, jax.nn.gelu)):
        got, want = f32(mine(tx)), f32(jax.jit(theirs)(x))
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("T", [1, 7, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches_the_reference(T, with_state):
    rcfg = rget_config("recurrentgemma-2b", True)
    cfg = get_config("recurrentgemma-2b", True)
    rprm, tprm = _layer("recurrentgemma-2b", "units", "b0", "temporal")
    rng = np.random.default_rng(10 + T)
    rx, tx = _bf16(rng, (2, T, cfg.d_model))
    rh = th = None
    if with_state:
        h0 = rng.normal(size=(2, cfg.lru_width)).astype(np.float32)
        rh, th = jnp.asarray(h0), torch.from_numpy(h0)
    ry, rstate = rrglru.rglru_forward(rx, rprm, rcfg, init_state=rh)
    ty, tstate = rglru.rglru_forward(tx, tprm, cfg, init_state=th)
    assert ty.dtype == torch.bfloat16 and tuple(ty.shape) == ry.shape
    assert tstate.dtype == torch.float32 and tuple(tstate.shape) == \
        rstate.shape
    _close(ty, ry)
    _close(tstate, rstate)


def test_rglru_decode_step_matches_the_reference():
    rcfg = rget_config("recurrentgemma-2b", True)
    cfg = get_config("recurrentgemma-2b", True)
    rprm, tprm = _layer("recurrentgemma-2b", "units", "b0", "temporal")
    rng = np.random.default_rng(20)
    h0 = rng.normal(size=(2, cfg.lru_width)).astype(np.float32)
    rconv, tconv = _bf16(rng, (2, cfg.conv_width - 1, cfg.lru_width))
    rx, tx = _bf16(rng, (2, 1, cfg.d_model))
    ry, rnew = rrglru.rglru_decode_step(rx, rprm, rcfg,
                                        {"h": jnp.asarray(h0), "conv": rconv})
    ty, tnew = rglru.rglru_decode_step(tx, tprm, cfg,
                                       {"h": torch.from_numpy(h0),
                                        "conv": tconv})
    _close(ty, ry)
    _close(tnew["h"], rnew["h"])
    np.testing.assert_array_equal(f32(tnew["conv"]), f32(rnew["conv"]))
    specs = rglru.rglru_cache_specs(cfg, 2)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tnew.items()} == \
        {k: (s.shape, s.dtype) for k, s in specs.items()}


@pytest.mark.parametrize("T", [1, 2, 5, 64, 1000])
def test_linear_scan_is_the_sequential_recurrence(T):
    """The log-depth scan against h_t = a_t h_{t-1} + b_t in fp64."""
    g = torch.Generator().manual_seed(T)
    a = torch.rand((2, T, 8), generator=g)
    b = torch.randn((2, T, 8), generator=g)
    want = torch.zeros((2, 8), dtype=torch.float64)
    seq = []
    for t in range(T):
        want = a[:, t].double() * want + b[:, t].double()
        seq.append(want)
    got = rglru.linear_scan(a, b)
    assert got.dtype == torch.float32 and got.shape == b.shape
    np.testing.assert_allclose(got.double().numpy(),
                               torch.stack(seq, 1).numpy(), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ whisper
def test_whisper_encode_matches_the_reference():
    rcfg, cfg = rget_config("whisper-small", True), get_config("whisper-small",
                                                                True)
    rp = _ref_params("whisper-small")
    mp = api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(30)
    rf, tf = _bf16(rng, (2, cfg.num_audio_frames, cfg.d_model))
    got = whisper.encode(mp, cfg, tf)
    assert got.dtype == torch.bfloat16
    _close(got, rwhisper.encode(rp, rcfg, rf))
    kx, vx = whisper._cross_kv(mp.dec_layers[0], cfg, got)
    rkx, rvx = rwhisper._cross_kv(jax.tree.map(lambda a: a[0],
                                               rp["dec_layers"]), rcfg,
                                  rwhisper.encode(rp, rcfg, rf))
    _close(kx, rkx)
    _close(vx, rvx)


# ------------------------------------------------------------------ hybrid
def test_recurrentgemma_ring_quirk_is_the_references():
    """At S = 40 (above the 32-wide window, not a multiple of it) prefill
    caches ``k[:, 8:40]`` in slots 0..31 while decode addresses the ring
    as ``pos % 32``: the ring is rotated by 8. The port decodes as the
    reference does (its decode logits match the reference's decode), and
    both are off their forward's logits at position 40."""
    arch = "recurrentgemma-2b"
    rcfg, cfg = rget_config(arch, True), get_config(arch, True)
    rp = _ref_params(arch, 2)
    mp = api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu")
    S = 40
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, S + 1)).astype(np.int32)
    rt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    _, rcache = rapi.build_decode_cache(rp, rcfg, {"tokens": rt[:, :S]},
                                        S + 8, blockwise=False)
    _, tcache = api.build_decode_cache(mp, cfg, {"tokens": tt[:, :S]}, S + 8,
                                       blockwise=False)
    # the attention block's ring: positions 8..39 in slots 0..31
    np.testing.assert_allclose(f32(tcache["units"]["b2"]["k"]),
                               f32(rcache["units"]["b2"]["k"]), **TOL)
    rdec, _ = rapi.decode_step(rp, rcfg, rcache, jnp.int32(S), rt[:, S:])
    tdec, _ = api.decode_step(mp, cfg, tcache, S, tt[:, S:])
    _close(tdec, rdec)
    rfull, _, _, _ = rapi.forward(rp, rcfg, {"tokens": rt})
    tfull, _, _, _ = api.forward(mp, cfg, {"tokens": tt})
    _close(tfull, rfull)
    for dec, full in ((tdec, tfull), (rdec, rfull)):
        assert not np.allclose(f32(dec[:, 0]), f32(full[:, -1]), **TOL)


def test_hybrid_structure_and_module_layout():
    """Units unstacked in (u, i) order plus the tail; at full width 8 units
    of (rec, rec, attn) and a (rec, rec) tail."""
    from repro_torch.models import hybrid
    full = get_config("recurrentgemma-2b")
    assert hybrid.structure(full) == (8, ("rec", "rec"))
    cfg = get_config("recurrentgemma-2b", True)
    mp = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(mp, hybrid.HybridLM)
    assert [b.kind for b in mp.units] == ["rec", "rec", "attn"]
    assert [b.kind for b in mp.tail] == ["rec", "rec"]
    assert all(not t.requires_grad for t in mp.parameters())


@pytest.mark.parametrize("key", [0, 1])
def test_bf16_noise_at_depth_is_the_references(key):
    """At 16 SSD layers, bf16 logits sit off an fp32 evaluation of the
    same parameters by as much in the port as in the reference (mean abs
    errors within 1.5x of each other) while the two fp32 evaluations
    agree within 1e-4. Two valid orders of bf16 arithmetic drift apart
    with depth, which is why the full-width prefill and decode checks on
    the card run in fp32."""
    import dataclasses
    cfg = dataclasses.replace(get_config("mamba2-2.7b", True), num_layers=16)
    rcfg = dataclasses.replace(rget_config("mamba2-2.7b", True),
                               num_layers=16)
    rp = rapi.init_params(rcfg, jax.random.PRNGKey(key))
    mp = api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu")
    wide = type(mp)(cfg, P.tree_map_specs(lambda t: t.float(), mp.tree()))
    toks = np.random.default_rng(key).integers(0, cfg.vocab_size,
                                               (1, 64)).astype(np.int32)
    port = f32(api.forward(mp, cfg, {"tokens": torch.from_numpy(toks)})[0])
    port32 = f32(api.forward(wide, cfg,
                             {"tokens": torch.from_numpy(toks)})[0])
    ref = f32(rapi.forward(rp, rcfg, {"tokens": jnp.asarray(toks)})[0])
    ref32 = f32(rapi.forward(jax.tree.map(lambda a: a.astype(jnp.float32),
                                          rp), rcfg,
                             {"tokens": jnp.asarray(toks)})[0])
    assert np.abs(port32 - ref32).max() < 1e-4
    e_port = np.abs(port - port32).mean()
    e_ref = np.abs(ref - ref32).mean()
    assert e_ref > 1e-3  # bf16 noise is there to compare
    assert 1 / 1.5 < e_port / e_ref < 1.5, (e_port, e_ref)
