"""The port's models against the JAX package's, on the CPU.

Parameters are materialized by ``repro.models.api.init_params`` and
carried over with ``repro_torch.models.api.from_reference`` (bf16 and
fp32 bit for bit). Logits, aux losses, losses and decode logits must match
within rtol = atol = 2e-2, the tolerance of ``tests/test_models_smoke.py``:
both sides compute in bf16 with fp32 scores, softmax, norms and recurrent
states, and round their bf16 matmuls in different orders. Covers all ten
architectures at their reduced configs (the generic decoder's dense, MoE
and VLM families, mamba2's SSM, recurrentgemma's hybrid, whisper's
encoder-decoder), and each attention regime at the function level
(``tests/test_torch_recurrent.py`` holds the SSD and RG-LRU functions).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as RARCH_IDS
from repro.configs import get_config as rget_config
from repro.models import api as rapi
from repro.models import attention as rattn
from repro.models import flags as rflags
from repro.models import layers as rlayers
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api, attention, flags, layers, transformer
from repro_torch.models import params as P

TOL = dict(rtol=2e-2, atol=2e-2)
GENERIC = [a for a in ARCH_IDS
           if get_config(a, reduced=True).family in ("dense", "moe", "vlm")]
# the published parameter counts of the three non-generic families
PUBLISHED = {"mamba2-2.7b": 2_702_235_136, "recurrentgemma-2b": 2_894_528_000,
             "whisper-small": 277_940_736}


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
def _ref_params(arch, key):
    return rapi.init_params(rget_config(arch, reduced=True),
                            jax.random.PRNGKey(key))


def _models(arch, key):
    """(reference config, reference params, port config, port params)."""
    rp = _ref_params(arch, key)
    cfg = get_config(arch, reduced=True)
    return (rget_config(arch, reduced=True), rp, cfg,
            api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu"))


def _batches(cfg, B, S, seed):
    """The batch of ``tests/test_models_smoke.py::make_batch`` for both
    sides."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "audio":
        fr = jnp.asarray(rng.normal(size=(B, cfg.num_audio_frames,
                                          cfg.d_model)), jnp.bfloat16)
        rb["frames"], tb["frames"] = fr, P.to_torch(np.asarray(fr), "cpu")
    if cfg.family == "vlm":
        pa = jnp.asarray(rng.normal(size=(B, cfg.num_patches, cfg.patch_dim)),
                         jnp.bfloat16)
        rb["patches"], tb["patches"] = pa, P.to_torch(np.asarray(pa), "cpu")
    return rb, tb


def shapes(tree):
    """Leaf shapes of a nested dict (or tuple) of tensors or arrays."""
    if isinstance(tree, (tuple, list)):
        return tuple(shapes(t) for t in tree)
    return P.tree_map_specs(lambda t: tuple(t.shape), tree)


def leaf_pairs(a, b, path=()):
    """(path, a leaf, b's leaf) over two nested dicts of one layout."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            yield from leaf_pairs(a[k], b[k], path + (k,))
    else:
        yield path, a, b


def n_layers(model) -> int:
    """The layers a port module holds, encoder layers included."""
    return sum(len(m) for m in model.children()
               if isinstance(m, torch.nn.ModuleList))


def test_the_generic_families_cover_seven_architectures():
    assert ARCH_IDS == RARCH_IDS
    assert sorted(GENERIC) == sorted(
        ["olmo-1b", "qwen3-14b", "qwen1.5-4b", "deepseek-67b",
         "qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "llava-next-mistral-7b"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_copies(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == \
            dataclasses.asdict(rget_config(arch, reduced))


@pytest.mark.parametrize("arch,S", [(a, 64) for a in ARCH_IDS]
                         + [("llama4-scout-17b-a16e", 128),
                            ("mamba2-2.7b", 45), ("recurrentgemma-2b", 40)])
def test_forward_and_loss_match_the_reference(arch, S):
    """S=128 runs llama4's local layers through ``local_chunk_attention``
    (S above its 64-wide chunk); at 64 they fall back to causal.
    recurrentgemma's attention blocks take ``local_window_attention`` at
    64 (twice its 32-wide window) and the masked form at 40; mamba2 pads
    45 steps to two 32-step chunks."""
    rcfg, rp, cfg, mp = _models(arch, 0)
    rb, tb = _batches(cfg, 2, S, 0)
    rl, ra, rm, _ = rapi.forward(rp, rcfg, rb)
    tl, ta, tm, cache = api.forward(mp, cfg, tb)
    assert cache is None and tl.dtype == torch.float32
    assert tuple(tl.shape) == rl.shape
    np.testing.assert_allclose(f32(tl), f32(rl), **TOL)
    np.testing.assert_allclose(f32(ta), f32(ra), **TOL)
    np.testing.assert_array_equal(f32(tm), f32(rm))
    np.testing.assert_allclose(float(api.loss_fn(mp, cfg, tb)),
                               float(rapi.loss_fn(rp, rcfg, rb)), **TOL)
    loss = float(api.loss_fn(mp, cfg, tb))
    assert 0.5 * np.log(cfg.vocab_size) < loss < 3.0 * np.log(cfg.vocab_size)


@pytest.mark.parametrize("arch,S", [(a, 32) for a in ARCH_IDS]
                         + [("llama4-scout-17b-a16e", 128),
                            ("mamba2-2.7b", 45), ("recurrentgemma-2b", 64)])
def test_prefill_decode_consistency(arch, S):
    """``tests/test_models_smoke.py``'s check on the port (decode_step at
    position S reproduces forward's logits there), and the port's decode
    logits against the reference's. S=128 decodes llama4's local layers
    from a ring cache that holds the last chunk; recurrentgemma at 64
    decodes from a ring its prefill filled through
    ``local_window_attention`` (64 is a multiple of the window, so the
    ring is aligned); mamba2 at 45 from a state that went through the
    chunk padding."""
    rcfg, rp, cfg, mp = _models(arch, 2)
    rb, tb = _batches(cfg, 2, S + 1, 0)
    full, _, _, _ = api.forward(mp, cfg, tb)
    pos = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    tprefix = dict(tb, tokens=tb["tokens"][:, :S])
    rprefix = dict(rb, tokens=rb["tokens"][:, :S])
    last, cache = api.build_decode_cache(mp, cfg, tprefix, pos + 8,
                                         blockwise=False)
    np.testing.assert_allclose(f32(last), f32(full[:, -2]), **TOL)
    dec, new_cache = api.decode_step(mp, cfg, cache, pos,
                                     tb["tokens"][:, S:S + 1])
    np.testing.assert_allclose(f32(dec[:, 0]), f32(full[:, -1]), **TOL)
    assert shapes(new_cache) == shapes(cache)

    rlast, rcache = rapi.build_decode_cache(rp, rcfg, rprefix, pos + 8,
                                            blockwise=False)
    rdec, _ = rapi.decode_step(rp, rcfg, rcache, jnp.int32(pos),
                               rb["tokens"][:, S:S + 1])
    np.testing.assert_allclose(f32(last), f32(rlast), **TOL)
    np.testing.assert_allclose(f32(dec), f32(rdec), **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_decode_cache_shapes(arch):
    """Every leaf's shape equal to the reference's and to ``cache_specs``,
    its values within the tolerance; linear caches zero past the prompt
    (an SSM's state has no positions, whisper's cross-attention cache
    holds every frame, recurrentgemma's rings are padded to the window)."""
    rcfg, rp, cfg, mp = _models(arch, 0)
    S, max_len = 16, 40
    rb, tb = _batches(cfg, 2, S, 1)
    _, cache = api.build_decode_cache(mp, cfg, tb, max_len)
    _, rcache = rapi.build_decode_cache(rp, rcfg, rb, max_len)
    assert shapes(cache) == shapes(rcache)
    pre = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    specs = api.cache_specs(cfg, 2, max_len)
    assert shapes(cache) == P.tree_map_specs(lambda s: s.shape, specs)
    for path, v, want in leaf_pairs(cache, rcache):
        np.testing.assert_allclose(f32(v), f32(want), **TOL)
        spec = specs
        for k in path:
            spec = spec[k]
        assert v.dtype == spec.dtype, path
        if path[-1] in ("k", "v") and not cfg.attn_unit:
            # written prefix, zero padding after it
            assert not v[..., pre:, :, :].any(), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_the_reference(arch):
    for reduced in (False, True):
        cfg = get_config(arch, reduced)
        rcfg = rget_config(arch, reduced)
        for active in (False, True):
            assert api.count_params(cfg, active) == \
                rapi.count_params(rcfg, active)
        assert cfg.param_count() == rcfg.param_count()
    assert get_config("olmo-1b").param_count() == 1_176_764_416
    if arch in PUBLISHED:
        assert api.count_params(get_config(arch)) == PUBLISHED[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_carry_over_round_trip(arch):
    """Reference tree -> the port's layers -> the reference's stacked
    layout again, every leaf's bits and dtype equal (bf16, and the fp32
    of mamba2's ``A_log``/``D``/``dt_bias`` and the RG-LRU's ``lam``)."""
    rp = _ref_params(arch, 0)
    cfg = get_config(arch, reduced=True)
    mp = api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu")
    assert n_layers(mp) == cfg.num_layers + cfg.num_encoder_layers
    back = mp.tree()
    ref_leaves = jax.tree_util.tree_leaves_with_path(rp)
    assert len(ref_leaves) == len(P.leaves(back))
    for path, leaf in ref_leaves:
        got = back
        for k in path:
            got = got[k.key]
        want = np.asarray(leaf)
        assert want.dtype.name in ("bfloat16", "float32")
        assert got.dtype == (torch.bfloat16 if want.dtype.name == "bfloat16"
                             else torch.float32)
        assert tuple(got.shape) == want.shape
        bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        np.testing.assert_array_equal(
            got.contiguous().view(bits).numpy(),
            want.view(np.int16 if bits == torch.int16 else np.int32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_distributions(arch):
    cfg = get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(3)
    mp = api.init_params(cfg, gen, device="cpu")
    tree = mp.tree()
    specs = api.init_specs(cfg)
    assert sum(t.numel() for t in P.leaves(tree)) == api.count_params(cfg)
    assert P.bytes_of(specs) == sum(t.numel() * t.element_size()
                                    for t in P.leaves(tree))

    def check(spec, t):
        assert tuple(t.shape) == spec.shape and t.dtype == spec.dtype
        if spec.init == "zeros":
            assert not t.any()
        elif spec.init == "ones":
            assert bool((t == 1).all())
        elif spec.init == "ssm_a":  # log of a uniform draw on [1, 16]
            assert t.dtype == torch.float32
            assert 0.0 <= float(t.min()) and float(t.max()) <= np.log(16.0)
            assert len(set(t.flatten().tolist())) == t.numel()
        elif t.numel() >= 4096:
            std = min(spec.scale, 1 / np.sqrt(spec.shape[-2])) \
                if len(spec.shape) >= 2 else spec.scale
            assert abs(float(t.float().std()) / std - 1) < 0.1
    for s, t in zip(P.leaves(specs), P.leaves(tree)):
        check(s, t)


@pytest.mark.parametrize("causal_skip", [False, True])
def test_blockwise_attention_at_2048(causal_skip):
    """The blocked schedule at S = 2048 (two 1024-row query blocks) against
    the materialized form and against the reference's."""
    cfg = get_config("llama4-scout-17b-a16e", reduced=True)  # H=4, KV=2
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 2048, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    rq, rk, rv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (P.to_torch(np.asarray(a), "cpu") for a in (rq, rk, rv))
    got = attention.blockwise_attention(tq, tk, tv, cfg,
                                        causal_skip=causal_skip)
    np.testing.assert_allclose(f32(got),
                               f32(attention.attention(tq, tk, tv, cfg)),
                               **TOL)
    rcfg = rget_config("llama4-scout-17b-a16e", reduced=True)
    np.testing.assert_allclose(
        f32(got), f32(rattn.blockwise_attention(rq, rk, rv, rcfg,
                                                causal_skip=causal_skip)),
        **TOL)
    # below two query blocks: the materialized form
    assert torch.equal(
        attention.blockwise_attention(tq[:, :1024], tk[:, :1024],
                                      tv[:, :1024], cfg),
        attention.attention(tq[:, :1024], tk[:, :1024], tv[:, :1024], cfg))


def test_flat_attention_matches_grouped():
    cfg = get_config("llava-next-mistral-7b", reduced=True)  # H=4, KV=2
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 24, 4, 16))).bfloat16()
    k, v = (torch.from_numpy(rng.normal(size=(2, 24, 2, 16))).bfloat16()
            for _ in range(2))
    grouped = attention.attention(q, k, v, cfg)
    with flags.attn_impl("flat"):
        flat = attention.attention(q, k, v, cfg)
    np.testing.assert_allclose(f32(flat), f32(grouped), **TOL)
    rcfg = rget_config("llava-next-mistral-7b", reduced=True)
    rq, rk, rv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    with rflags.attn_impl("flat"):
        np.testing.assert_allclose(f32(flat), f32(rattn.attention(
            rq, rk, rv, rcfg)), **TOL)


@pytest.mark.parametrize("kind,width", [("local_window", 8),
                                        ("local_chunk", 8), ("causal", 0)])
def test_attention_regimes_match_the_reference(kind, width):
    """``local_window_attention``, ``local_chunk_attention``, ``_mask`` and
    ``decode_attention`` over a ring cache (never-written slots carry
    negative positions) against the reference's."""
    cfg = get_config("qwen3-14b", reduced=True)
    rcfg = rget_config("qwen3-14b", reduced=True)
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 2, 32, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    arrs = [jnp.asarray(rng.normal(size=(B, S, n, hd)), jnp.bfloat16)
            for n in (H, KV, KV)]
    t = [P.to_torch(np.asarray(a), "cpu") for a in arrs]
    if kind == "local_window":
        got = attention.local_window_attention(*t, cfg, width)
        want = rattn.local_window_attention(*arrs, rcfg, width)
    elif kind == "local_chunk":
        got = attention.local_chunk_attention(*t, cfg, width)
        want = rattn.local_chunk_attention(*arrs, rcfg, width)
    else:
        got = attention.attention(*t, cfg)
        want = rattn.attention(*arrs, rcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    qp, kp = np.arange(S), np.arange(-4, S - 4)
    assert np.array_equal(
        attention._mask(torch.from_numpy(qp), torch.from_numpy(kp), kind,
                        width).numpy(),
        np.asarray(rattn._mask(jnp.asarray(qp), jnp.asarray(kp), kind, width)))
    pos = 21
    kv_pos = np.where(np.arange(S) <= pos, np.arange(S), -1) if kind == \
        "causal" else pos - ((pos - np.arange(S)) % S)
    got = attention.decode_attention(t[0][:, :1], t[1], t[2], pos, kind,
                                     width, torch.from_numpy(kv_pos))
    want = rattn.decode_attention(arrs[0][:, :1], arrs[1], arrs[2], pos, kind,
                                  width, jnp.asarray(kv_pos))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("norm_type,mlp_act", [("layernorm", "gelu"),
                                               ("rmsnorm", "swiglu"),
                                               ("layernorm_nonparam",
                                                "swiglu")])
def test_layers_match_the_reference(norm_type, mlp_act):
    """Norms (with and without parameters), RoPE, both MLP forms (the
    gelu one in its tanh form) and the embedding's fp32 logits."""
    cfg = dataclasses.replace(get_config("olmo-1b", reduced=True),
                              norm_type=norm_type, mlp_act=mlp_act,
                              tie_embeddings=False)
    rcfg = dataclasses.replace(rget_config("olmo-1b", reduced=True),
                               norm_type=norm_type, mlp_act=mlp_act,
                               tie_embeddings=False)
    rng = np.random.default_rng(8)
    specs = {"norm": rlayers.norm_specs(rcfg), "mlp": rlayers.mlp_specs(rcfg),
             "embed": rlayers.embed_specs(rcfg)}
    from repro.models.params import materialize
    rp = materialize(specs, jax.random.PRNGKey(9))
    rp["norm"] = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(size=a.shape) * 0.1, a.dtype), rp["norm"])  # not all ones
    tp = P.from_reference(jax.tree.map(np.asarray, rp), "cpu")
    port_specs = {"norm": layers.norm_specs(cfg),
                  "mlp": layers.mlp_specs(cfg),
                  "embed": layers.embed_specs(cfg)}
    assert P.tree_map_specs(lambda t: tuple(t.shape), tp) == \
        P.tree_map_specs(lambda s: s.shape, port_specs)
    x = jnp.asarray(rng.normal(size=(2, 8, cfg.d_model)) * 3 + 1, jnp.bfloat16)
    tx = P.to_torch(np.asarray(x), "cpu")
    h = rlayers.apply_norm(x, rp["norm"], rcfg)
    np.testing.assert_allclose(
        f32(layers.apply_norm(tx, tp["norm"], cfg)), f32(h), **TOL)
    # the MLP's input in the model: a normed hidden state
    th = P.to_torch(np.asarray(h), "cpu")
    np.testing.assert_allclose(f32(layers.apply_mlp(th, tp["mlp"], cfg)),
                               f32(rlayers.apply_mlp(h, rp["mlp"], rcfg)),
                               **TOL)
    np.testing.assert_allclose(f32(layers.lm_logits(tp["embed"], tx)),
                               f32(rlayers.lm_logits(rp["embed"], x)), **TOL)
    hx = x.reshape(2, 8, 4, 16)
    pos = np.arange(100, 108)
    np.testing.assert_allclose(
        f32(layers.apply_rope(P.to_torch(np.asarray(hx), "cpu"),
                              torch.from_numpy(pos), 1e6)),
        f32(rlayers.apply_rope(hx, jnp.asarray(pos), 1e6)), **TOL)
    np.testing.assert_array_equal(
        layers.rope_freqs(16, 5e5).numpy(),
        np.asarray(rlayers.rope_freqs(16, 5e5)))


def test_moe_flags():
    # "ep" selects the expert-parallel dispatch; outside an
    # activation_sharding context it falls back to the dense one
    with flags.moe_impl("ep"):
        assert flags.current_moe_impl() == "ep"
    assert flags.current_moe_impl() == "dense"
    with pytest.raises(ValueError, match="moe_impl"):
        with flags.moe_impl("shard_map"):
            pass
    with flags.moe_impl("dense"), flags.unroll_scans():
        assert flags.current_attn_impl() == "grouped"
    assert [y for _, y in [flags.maybe_scan(
        lambda c, x: (c + x, c), 0, [1, 2, 3])]] == [[0, 1, 3]]


def test_decoder_blocks_carry_the_attention_kinds():
    cfg = get_config("llama4-scout-17b-a16e", reduced=True)
    mp = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(b.kind, b.width, b.rope) for b in mp.blocks] == \
        [("local_chunk", 64, True)] * 3 + [("causal", 0, False)]
    assert isinstance(mp, transformer.Decoder)
    assert all(not p.requires_grad for p in mp.parameters())


def test_without_a_gpu_init_params_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        api.init_params(get_config("olmo-1b", reduced=True))
