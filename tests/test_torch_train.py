"""The port's training package (``repro_torch.train``) against the JAX
package's ``repro.train``, on the CPU.

- ``optimizer.apply``: one step on the same carried-over parameters,
  gradients and ``OptState``: fp32 parameters, ``m`` and ``v`` within 1e-6
  relative, with an atol of 1e-6 of the leaf's largest magnitude (the two
  sides sum ``grad_norm`` in other orders, so the clip factor can differ
  in its last bit, and an entry whose update cancels to near 0 loses that
  bit's relative precision: 2.5e-6 relative on one of 16,384 entries
  seen); bf16 parameters equal or one ulp apart (one fp32 difference can
  round the update the other way), ``step`` equal, ``lr`` and
  ``grad_norm`` within 1e-6 relative. ``schedule`` within 1e-6 at warm-up, cosine and end
  steps. The decay mask of every leaf of all ten families equals the
  reference's ``_decayed(path) and ndim >= 2`` on its stacked tree.
- ``checkpoint``: mirrors of ``tests/test_substrate.py``'s checkpoint
  tests on the port's modules, and both directions of the file format:
  what the reference writes restores in the port and what the port writes
  restores in the reference, every leaf's key, dtype and bits equal.
- ``loop``: mirrors of ``tests/test_substrate.py``'s resume and
  loss-decrease tests on the port's pipeline (the reference's 5e-2 on the
  resumed loss), and ``train`` against the reference's ``train`` from the
  same parameters on the same batches: every logged loss within 2e-2 (the
  models' bf16 tolerance; the updates compound bf16 rounding step by
  step); a trained module serving without a graph; the step a SIGTERM's
  save is filed under (a deliberate difference from the reference);
  ``chip_smoke.py``'s train phase at a small size.
"""
import dataclasses
import os
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data import pipeline as rpipe
from repro.models import api as rapi
from repro.models import params as RP
from repro.train import checkpoint as rckpt
from repro.train import loop as rloop
from repro.train import optimizer as ropt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                       synth_corpus)
from repro_torch.models import api
from repro_torch.models import params as P
from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager, PreemptionGuard
from repro_torch.train.loop import TrainConfig, train

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, and the tier-1
    run puts several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(t) -> np.ndarray:
    """A tensor's or array's raw bits (bf16 through its 16-bit pattern)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().reshape(-1)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(f"i{t.element_size()}")
    a = np.asarray(t)
    return a.reshape(-1).view(f"i{a.dtype.itemsize}")


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _ref_state(arch, dtype, seed):
    """The reference's parameters in ``dtype``, random gradients and an
    ``OptState`` three steps in (m, v drawn; v positive)."""
    rcfg = rget_config(arch, reduced=True)
    rp = jax.tree.map(lambda a: a.astype(dtype),
                      rapi.init_params(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    draw = lambda s: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(rng.normal(size=a.shape) * s, jnp.float32), rp)
    grads = draw(0.05)
    m = draw(1e-3)
    v = jax.tree.map(lambda a: a * a + 1e-8, draw(1e-3))
    return rcfg, rp, grads, ropt.OptState(m, v, jnp.asarray(3, jnp.int32))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-2.7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_apply_step_matches_the_reference(arch, dtype):
    rcfg, rp, rg, rstate = _ref_state(arch, jnp.dtype(dtype), 1)
    cfg = get_config(arch, reduced=True)
    acfg = opt_lib.AdamWConfig(**OPT)
    want_p, want_opt, want = ropt.apply(ropt.AdamWConfig(**OPT), rp, rstate,
                                        rg)

    family = lambda tree: api.from_reference(cfg, _np(tree), "cpu")  # noqa: E731
    params = family(rp)
    state = opt_lib.OptState(family(rstate.m), family(rstate.v),
                             torch.tensor(3, dtype=torch.int32))
    params, state, got = opt_lib.apply(acfg, params, state, family(rg))

    assert int(state.step) == int(want_opt.step) == 4
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert float(got["grad_norm"]) > acfg.grad_clip  # the clip is exercised

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())
    for mod, ref in ((state.m, want_opt.m), (state.v, want_opt.v)):
        for a, b in zip(P.leaves(mod.tree()), jax.tree.leaves(ref)):
            close(a, b)
    for a, b in zip(P.leaves(params.tree()), jax.tree.leaves(want_p)):
        assert _dtype_name(a) == str(b.dtype)
        if dtype == "float32":
            close(a, b)
        else:
            ulps = np.abs(_bits(a).astype(np.int32)
                          - _bits(b).astype(np.int32))
            assert ulps.max() <= 1


def test_schedule_matches_the_reference():
    for kw in (OPT, dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
               dict(lr=3e-3, warmup_steps=1, total_steps=1)):
        rc, pc = ropt.AdamWConfig(**kw), opt_lib.AdamWConfig(**kw)
        W, T = kw["warmup_steps"], kw["total_steps"]
        for s in sorted({0, 1, W - 1, W, (W + T) // 2, T - 1, T, T + 5}):
            if s < 0:
                continue
            want = float(ropt.schedule(rc, jnp.asarray(s, jnp.int32)))
            got = opt_lib.schedule(pc, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)


def _reference_mask(rcfg):
    """{stacked path: the reference's decision} over the spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        rapi.init_specs(rcfg), is_leaf=lambda x: isinstance(x, RP.ParamSpec))
    return {"/".join(k.key for k in path):
            ropt._decayed(path) and len(spec.shape) >= 2
            for path, spec in flat[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_matches_the_reference_on_every_leaf(arch):
    cfg = get_config(arch, reduced=True)
    model = api.init_params(cfg, device="cpu")
    # the per-parameter decisions, stacked by the family's own module
    shell = type(model)(cfg, model.tree())
    for p, decay in zip(shell.parameters(), opt_lib.decay_mask(model)):
        p.data = torch.full(p.shape, decay)
    got = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got["/".join(path + (k,))] = v
    walk(shell.tree(), ())
    want = _reference_mask(rget_config(arch, reduced=True))
    assert sorted(got) == sorted(want)
    for k, flags in got.items():
        assert bool(flags.all()) == bool(flags.any()) == want[k], k
    assert any(want.values())


def test_init_matches_the_reference_layout():
    cfg = get_config("olmo-1b", reduced=True)
    model = api.init_params(cfg, device="cpu")
    state = opt_lib.init(model)
    rp = rapi.init_params(rget_config("olmo-1b", True),
                          jax.random.PRNGKey(0))
    keys = ckpt._flatten((model, state))
    rkeys = rckpt._flatten((rp, ropt.init(rp)))
    assert list(keys) == list(rkeys) and len(keys) == 25
    assert "0/layers/attn/wq" in keys and "1/m/layers/ffn/w_up" in keys
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for t in P.leaves(state.m.tree()) + P.leaves(state.v.tree()):
        assert t.dtype == torch.float32 and not t.any()
    specs = opt_lib.init_specs(api.init_specs(cfg))
    assert specs.step.dtype == torch.int32 and specs.step.shape == ()
    assert all(s.dtype == torch.float32 for s in P.leaves(specs.m))


# ----------------------------------------------------------- checkpoints
def _tiny_state(seed=0):
    cfg = get_config("olmo-1b", reduced=True)
    model = api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    state = opt_lib.init(model)
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # moments that are not all zeros
        for t in [*state.m.parameters(), *state.v.parameters()]:
            t.copy_(torch.from_numpy(rng.random(t.shape, np.float32)))
        state.step.fill_(seed + 7)
    return cfg, (model, state)


def _same_state(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert np.array_equal(_bits(fa[k]), _bits(fb[k])), k


def test_checkpoint_roundtrip_and_keep_k():
    _, state = _tiny_state(0)
    _, template = _tiny_state(1)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, state)
        assert mgr.all_steps() == [2, 3]  # keep-k pruning
        restored, step = mgr.restore(template)
        assert step == 3
        assert restored[0] is template[0]  # copied into the template
        _same_state(restored, state)        # bf16 survives the npz
        assert template[0].embed["embedding"].dtype == torch.bfloat16


def test_checkpoint_async_and_atomic():
    _, state = _tiny_state()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        mgr.save_async(5, state)
        mgr.wait()
        assert mgr.latest_step() == 5
        assert not list(Path(d).glob(".step_*"))  # no tmp debris
        m = mgr.manifest(5)
        assert len(m["keys"]) == 25 and "1/step" in m["keys"]
        assert set(m["bf16_keys"]) == {k for k in m["keys"]
                                       if k.startswith("0/")}


def test_checkpoint_restores_onto_a_given_device():
    _, state = _tiny_state(0)
    _, template = _tiny_state(1)
    before = {k: v.clone() for k, v in ckpt._flatten(template).items()}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, state)
        restored, _ = mgr.restore(template, device="cpu")
    assert restored[0] is not template[0]
    assert all(t.device.type == "cpu" for t in
               ckpt._flatten(restored).values())
    _same_state(restored, state)
    for k, v in ckpt._flatten(template).items():  # the template is intact
        assert torch.equal(v, before[k]), k


def test_preemption_guard():
    calls = []
    with PreemptionGuard(lambda: calls.append(1)) as g:
        os.kill(os.getpid(), 15)  # SIGTERM
        for _ in range(100):
            if g.fired:
                break
            time.sleep(0.01)
    assert g.fired and calls == [1]


def _ref_tiny_state():
    rcfg = rget_config("olmo-1b", reduced=True)
    rp = rapi.init_params(rcfg, jax.random.PRNGKey(3))
    st = ropt.init(rp)
    rng = np.random.default_rng(3)
    st = ropt.OptState(
        jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32),
                     st.m), st.v, jnp.asarray(11, jnp.int32))
    return rp, st


def test_a_reference_checkpoint_restores_in_the_port():
    rstate = _ref_tiny_state()
    _, template = _tiny_state(0)
    with tempfile.TemporaryDirectory() as d:
        rckpt.CheckpointManager(d).save(4, rstate)
        restored, step = CheckpointManager(d).restore(template)
    assert step == 4
    want = rckpt._flatten(jax.tree.map(np.asarray, rstate))
    got = ckpt._flatten(restored)
    assert list(got) == list(want)
    for k in want:
        assert _dtype_name(got[k]) == str(want[k].dtype), k
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


def test_a_port_checkpoint_restores_in_the_reference():
    _, state = _tiny_state(2)
    rtemplate = _ref_tiny_state()
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(6, state)
        rmgr = rckpt.CheckpointManager(d)
        restored, step = rmgr.restore(rtemplate)
        manifest = rmgr.manifest(6)
    assert step == 6
    want = ckpt._flatten(state)
    got = rckpt._flatten(jax.tree.map(np.asarray, restored))
    assert sorted(got) == sorted(want) == manifest["keys"]
    for k in want:
        assert str(got[k].dtype) == _dtype_name(want[k]), k
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


# ------------------------------------------------------------ train loop
def _corpus_and_query(**q):
    cfg = get_config("olmo-1b", reduced=True)
    corpus = synth_corpus(num_partitions=2, docs_per_part=64, doc_len=128,
                          vocab=cfg.vocab_size)
    return cfg, corpus, CorpusQuery(**q)


def test_train_resume_exact():
    cfg, corpus, q = _corpus_and_query(min_quality=0.2, seq_len=64,
                                       global_batch=4, accum=2, dp_ranks=1)
    opt = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    data = lambda: iter(PushdownDataPipeline(corpus, q, seed=3,  # noqa: E731
                                             device="cpu"))
    with tempfile.TemporaryDirectory() as d:
        full = train(cfg, data(), TrainConfig(steps=8, ckpt_every=100,
                                              log_every=1, opt=opt),
                     device="cpu")
        train(cfg, data(), TrainConfig(steps=4, ckpt_every=4, ckpt_dir=d,
                                       log_every=1, opt=opt), device="cpu")
        assert CheckpointManager(d).manifest(4)["extra"]["final"]
        resumed = train(cfg, data(), TrainConfig(steps=8, ckpt_every=100,
                                                 ckpt_dir=d, log_every=1,
                                                 opt=opt), device="cpu")
    assert resumed["final_step"] == full["final_step"] == 8
    assert [h["step"] for h in resumed["history"]] == [5, 6, 7, 8]
    a, b = full["history"][-1]["loss"], resumed["history"][-1]["loss"]
    assert abs(a - b) < 5e-2, (a, b)
    # the same bits on the CPU: one process, one order of arithmetic
    _same_state((full["params"], full["opt"]),
                (resumed["params"], resumed["opt"]))


def test_loss_decreases():
    cfg = get_config("olmo-1b", reduced=True)
    corpus = synth_corpus(num_partitions=2, docs_per_part=32, doc_len=128,
                          vocab=cfg.vocab_size, seed=1)
    q = CorpusQuery(min_quality=0.0, seq_len=64, global_batch=4, accum=1,
                    dp_ranks=1)
    out = train(cfg, iter(PushdownDataPipeline(corpus, q, device="cpu")),
                TrainConfig(steps=30, ckpt_dir=None, log_every=5,
                            opt=opt_lib.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                    total_steps=30)),
                device="cpu")
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    assert last < first  # tiny model memorizes a tiny corpus


def test_train_matches_the_reference_from_the_same_start(monkeypatch):
    """``train`` on both sides from the reference's ``PRNGKey(0)``
    parameters, on the same pipeline batches: every logged loss, the
    ``lr`` and the step counts."""
    cfg, corpus, q = _corpus_and_query(min_quality=0.2, seq_len=64,
                                       global_batch=4, accum=2, dp_ranks=1)
    rcfg = rget_config("olmo-1b", reduced=True)
    rcorpus = rpipe.synth_corpus(num_partitions=2, docs_per_part=64,
                                 doc_len=128, vocab=rcfg.vocab_size)
    rq = rpipe.CorpusQuery(**dataclasses.asdict(q))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    want = rloop.train(rcfg, iter(rpipe.PushdownDataPipeline(rcorpus, rq,
                                                             seed=3)),
                       rloop.TrainConfig(steps=8, ckpt_every=100, log_every=1,
                                         opt=ropt.AdamWConfig(**kw)))
    start = _np(rapi.init_params(rcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(loop, "init_params", lambda c, g, dev:
                        api.from_reference(c, start, dev))
    got = train(cfg, iter(PushdownDataPipeline(corpus, q, seed=3,
                                               device="cpu")),
                TrainConfig(steps=8, ckpt_every=100, log_every=1,
                            opt=opt_lib.AdamWConfig(**kw)), device="cpu")
    assert got["final_step"] == want["final_step"] == 8
    assert len(got["history"]) == len(want["history"]) == 8
    for g, w in zip(got["history"], want["history"]):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) < 2e-2, (g, w)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    assert got["history"][-1]["loss"] < got["history"][0]["loss"]


def test_a_trained_module_serves_without_a_graph():
    cfg, corpus, q = _corpus_and_query(min_quality=0.2, seq_len=64,
                                       global_batch=4, accum=2, dp_ranks=1)
    out = train(cfg, iter(PushdownDataPipeline(corpus, q, device="cpu")),
                TrainConfig(steps=2, log_every=1,
                            opt=opt_lib.AdamWConfig(**OPT)), device="cpu")
    model = out["params"]
    assert not any(p.requires_grad for p in model.parameters())
    prompt = np.arange(1, 20, dtype=np.int32)
    eng = ServingEngine(cfg, model, ServeConfig(max_len=64))
    with torch.inference_mode():
        first = eng.generate([prompt], max_new=4)
    # serving turns no gradient on, inside or outside inference_mode
    model.requires_grad_(True)
    assert eng.generate([prompt], max_new=4) == first
    last, cache = api.prefill(model, cfg, {"tokens": torch.from_numpy(
        prompt)[None]})
    assert last.grad_fn is None and not last.requires_grad
    logits, _ = api.decode_step(model, cfg, api.build_decode_cache(
        model, cfg, {"tokens": torch.from_numpy(prompt)[None]}, 32)[1],
        len(prompt), torch.tensor([[3]], dtype=torch.int32))
    assert logits.grad_fn is None


def _smoke():
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_train_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s train phase at a small size on the CPU: the
    card run's query over 8 partitions of 256 documents of 64 tokens,
    olmo-1b's reduced config (its resume check cut to 1 layer) and a
    (1, 32) gradient check."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "GRAD_SHAPE", (1, 32))
    corpus = dict(smoke.PIPE_CORPUS, num_partitions=8, docs_per_part=256,
                  doc_len=64, vocab=256)
    query = dict(smoke.TRAIN_QUERY, seq_len=64)
    launches = smoke.train_phase(get_config(smoke.TRAIN_ARCH, reduced=True),
                                 corpus, query, "cpu", lambda: None,
                                 resume_layers=1)
    assert launches == dict.fromkeys(launches, 0)  # plain versions only


def test_preemption_saves_the_step_it_holds():
    """A SIGTERM after step 2 of a fresh run: the port's guard saves the
    state under step 2, the step it holds; the reference's saves it under
    ``start_step`` (0), so its directory also lists a step 0 that holds
    step 2's state (a deliberate difference, ROADMAP queue 3)."""
    cfg, corpus, q = _corpus_and_query(min_quality=0.2, seq_len=64,
                                       global_batch=4, accum=1, dp_ranks=1)
    rcfg = rget_config("olmo-1b", reduced=True)
    rcorpus = rpipe.synth_corpus(num_partitions=2, docs_per_part=64,
                                 doc_len=128, vocab=rcfg.vocab_size)
    rq = rpipe.CorpusQuery(**dataclasses.asdict(q))

    def kill_at_2(step, _):
        if step == 2:
            os.kill(os.getpid(), 15)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as rd:
        out = train(cfg, iter(PushdownDataPipeline(corpus, q, device="cpu")),
                    TrainConfig(steps=6, ckpt_every=100, ckpt_dir=d,
                                log_every=1, opt=opt_lib.AdamWConfig(**OPT)),
                    hooks=kill_at_2, device="cpu")
        rout = rloop.train(rcfg, iter(rpipe.PushdownDataPipeline(rcorpus,
                                                                 rq)),
                           rloop.TrainConfig(steps=6, ckpt_every=100,
                                             ckpt_dir=rd, log_every=1,
                                             opt=ropt.AdamWConfig(**OPT)),
                           hooks=kill_at_2)
        assert out["final_step"] == rout["final_step"] == 2
        assert CheckpointManager(d).all_steps() == [2]
        assert rckpt.CheckpointManager(rd).all_steps() == [0, 2]


def test_the_gradient_checks_tolerance_covers_the_fp32_rounding(monkeypatch):
    """The rounding bound behind ``chip_smoke.grad_check``'s tolerance, on
    a 2-layer, 512-wide olmo (vocab 8192) over (1, 128) tokens: at
    theta +- h d, with h = ``GRAD_STEP`` |theta|, the fp32 loss is within
    ``GRAD_ULPS`` ulps of an fp64 evaluation of the same parameters, and
    the fp64 central difference is within ``GRAD_REL`` of ``<grad, d>``
    (truncation and the fp32 gradient's rounding). The fp64 evaluation
    keeps every ``.float()`` of the model (norms, scores, logits, loss)
    in fp64."""
    import math
    smoke = _smoke()
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2,
                              d_model=512, num_heads=8, num_kv_heads=8,
                              d_ff=2048, vocab_size=8192)
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wide = type(model)(cfg, P.tree_map_specs(lambda t: t.float(),
                                             model.tree()))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 128),
                                     generator=g, dtype=torch.int32)}
    params = list(wide.parameters())
    wide.requires_grad_(True)
    loss = api.loss_fn(wide, cfg, batch)
    grads = torch.autograd.grad(loss, params)
    wide.requires_grad_(False)
    dot = lambda a, b: sum(float((x.double() * y.double()).sum())  # noqa: E731
                           for x, y in zip(a, b))
    d = [torch.randn(p.shape, generator=g) for p in params]
    nd = math.sqrt(dot(d, d))
    d = [x / nd for x in d]
    gd = dot(grads, d)
    h = smoke.GRAD_STEP * math.sqrt(dot(params, params))
    ulp = smoke.ulp32(float(loss.detach()))
    base = [p.clone() for p in params]
    as_float = torch.Tensor.float

    def at(sign, dtype):
        with torch.no_grad():
            for p, b, x in zip(params, base, d):
                p.copy_(b + sign * h * x)
        if dtype == torch.float32:
            return float(api.loss_fn(wide, cfg, batch))
        wide64 = type(model)(cfg, P.tree_map_specs(lambda t: t.double(),
                                                   wide.tree()))
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "float", lambda t, *a, **k: t if
                      t.dtype == torch.float64 else as_float(t, *a, **k))
            return float(api.loss_fn(wide64, cfg, batch))
    l32 = {s: at(s, torch.float32) for s in (1, -1)}
    l64 = {s: at(s, torch.float64) for s in (1, -1)}
    for s in (1, -1):
        assert abs(l32[s] - l64[s]) <= smoke.GRAD_ULPS * ulp, (s, l32, l64)
    fd64 = (l64[1] - l64[-1]) / (2 * h)
    assert abs(fd64 - gd) <= smoke.GRAD_REL * abs(gd), (fd64, gd)
    fd32 = (l32[1] - l32[-1]) / (2 * h)
    tol = 2 * smoke.GRAD_ULPS * ulp / (2 * h) + smoke.GRAD_REL * abs(gd)
    assert abs(fd32 - gd) <= tol
