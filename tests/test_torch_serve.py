"""The port's serving engine, on the CPU: the five checks of
``tests/test_serve.py`` on the generic families and the two recurrent ones
it serves (mamba2, recurrentgemma: generate shapes, per-request budgets,
the prefix budget, chunked-prefill equivalence and decode against
forward), and each prefill branch's logits and cache against the JAX
package's engine on carried-over parameters (rtol = atol = 2e-2, the model
tests' tolerance). Whisper is not served, as the reference's engine does
not serve it (its test skips audio).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import api as rapi
from repro.serve import engine as rengine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api
from repro_torch.serve.engine import (AdmissionPolicy, Request, ServeConfig,
                                      ServingEngine)

TOL = dict(rtol=2e-2, atol=2e-2)
GENERIC = [a for a in ARCH_IDS
           if get_config(a, reduced=True).family in ("dense", "moe", "vlm")]
SERVED = GENERIC + ["mamba2-2.7b", "recurrentgemma-2b"]


def sorted_leaves(tree):
    """A nested dict's leaves in key order, as ``jax.tree_util`` lists
    them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, and the tier-1
    run puts several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch, seed):
    return api.init_params(get_config(arch, reduced=True),
                           torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_generate_shapes(arch):
    cfg = get_config(arch, reduced=True)
    eng = ServingEngine(cfg, _params(arch, 0),
                        ServeConfig(max_batch=2, max_len=48))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(4, 12))
               .astype(np.int32) for _ in range(3)]
    outs = eng.generate(prompts, max_new=4)
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    assert all(isinstance(t, int) and 0 <= t < cfg.vocab_size
               for o in outs for t in o)


def test_per_request_max_new_honored():
    """serve() stops each slot at its own budget."""
    cfg = get_config("olmo-1b", reduced=True)
    eng = ServingEngine(cfg, _params("olmo-1b", 0),
                        ServeConfig(max_batch=4, max_len=64))
    rng = np.random.default_rng(2)
    budgets = [1, 3, 6, 0]
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, 6)
                    .astype(np.int32), max_new=m)
            for i, m in enumerate(budgets)]
    out = eng.serve(reqs)
    assert out is reqs
    assert [len(r.out_tokens) for r in reqs] == budgets
    assert all(r.done for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)


def test_prefix_budget_matches_shared_generate():
    """A slot capped at k tokens sees exactly the first k tokens of the
    uncapped greedy stream."""
    cfg = get_config("olmo-1b", reduced=True)
    params = _params("olmo-1b", 3)
    scfg = ServeConfig(max_batch=2, max_len=64)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
    full = ServingEngine(cfg, params, scfg).generate([prompt], max_new=6)[0]
    short = ServingEngine(cfg, params, scfg).generate([prompt], max_new=3)[0]
    assert short == full[:3]


@pytest.mark.parametrize("arch", SERVED)
def test_chunked_prefill_equivalent_and_wired(arch):
    """The chunked branch runs when the policy says so and gives the
    batched prefill's greedy tokens; a small wave stays batched even with
    a long prompt."""
    cfg = get_config(arch, reduced=True)
    params = _params(arch, 4)
    rng = np.random.default_rng(4)
    # 3 live slots > max_batch//2 = 2 -> policy says chunk; P=20 > chunk=8
    prompts = [rng.integers(1, cfg.vocab_size, 20).astype(np.int32)
               for _ in range(3)]
    mono = ServingEngine(cfg, params, ServeConfig(max_batch=4, max_len=64,
                                                  prefill_chunk=64))
    outs_mono = mono.generate(prompts, max_new=4)
    assert mono.chunked_prefills == 0          # P <= chunk: batched path
    chunked = ServingEngine(cfg, params, ServeConfig(max_batch=4, max_len=64,
                                                     prefill_chunk=8))
    outs_chunked = chunked.generate(prompts, max_new=4)
    assert chunked.chunked_prefills == 1       # the wave went chunked
    assert outs_chunked == outs_mono
    small = ServingEngine(cfg, params, ServeConfig(max_batch=4, max_len=64,
                                                   prefill_chunk=8))
    small.generate(prompts[:1], max_new=2)
    assert small.chunked_prefills == 0
    assert AdmissionPolicy(ServeConfig(max_batch=4)).chunked(3)
    assert not AdmissionPolicy(ServeConfig(max_batch=4)).chunked(2)


def test_decode_matches_forward():
    """Greedy decode step by step equals the argmax of a full forward pass
    at the same positions (linear cache)."""
    cfg = get_config("olmo-1b", reduced=True)
    params = _params("olmo-1b", 1)
    rng = np.random.default_rng(1)
    P = 8
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, P))
                              .astype(np.int32))
    logits, _, _, _ = api.forward(params, cfg, {"tokens": prompt})
    want_next = int(torch.argmax(logits[0, -1]))
    last, cache = api.build_decode_cache(params, cfg, {"tokens": prompt},
                                         max_len=32)
    got_next = int(torch.argmax(last[0]))
    assert got_next == want_next
    tok = torch.tensor([[got_next]], dtype=torch.int32)
    step_logits, _ = api.decode_step(params, cfg, cache, P, tok)
    full_logits, _, _, _ = api.forward(
        params, cfg, {"tokens": torch.cat([prompt, tok], dim=1)})
    np.testing.assert_allclose(step_logits.reshape(-1).numpy(),
                               full_logits[0, -1].numpy(), atol=2e-2)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("prefill_chunk", [8, 64])
def test_prefill_logits_match_the_reference_engine(arch, prefill_chunk):
    """Each prefill branch (chunk 8: chunked; 64: batched) on ragged
    left-padded prompts, against the JAX package's engine on the same
    parameters."""
    rcfg = rget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    rp = rapi.init_params(rcfg, jax.random.PRNGKey(5))
    params = api.from_reference(cfg, jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(5)
    B, P = 3, 20
    toks = np.zeros((B, P), np.int32)
    for b, n in enumerate((20, 13, 7)):
        toks[b, P - n:] = rng.integers(1, cfg.vocab_size, n)
    scfg = dict(max_batch=4, max_len=64, prefill_chunk=prefill_chunk)
    ref = rengine.ServingEngine(rcfg, rp, rengine.ServeConfig(**scfg))
    eng = ServingEngine(cfg, params, ServeConfig(**scfg))
    rlast, rcache = ref._prefill(toks, live_slots=B)
    last, cache = eng._prefill(torch.from_numpy(toks), live_slots=B)
    assert eng.chunked_prefills == ref.chunked_prefills == \
        (prefill_chunk < P)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast, np.float32),
                               **TOL)
    flat, rflat = sorted_leaves(cache), jax.tree_util.tree_leaves(rcache)
    assert [tuple(v.shape) for v in flat] == [a.shape for a in rflat]
    for v, want in zip(flat, rflat):
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(want, np.float32), **TOL)


def test_the_engine_runs_where_its_parameters_live():
    params = _params("olmo-1b", 0)
    eng = ServingEngine(get_config("olmo-1b", reduced=True), params,
                        ServeConfig())
    assert eng.device == torch.device("cpu")


def test_chip_smoke_pipeline_and_serve_phases_run_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s pipeline and serve phases at a small size on the
    CPU: 8 partitions of 256 documents of 64 tokens with the card run's
    query, olmo-1b's reduced config, and an engine of the card run's
    shape at a quarter of its lengths (two chunked waves, one batched);
    then the family sub-phases on the reduced mamba2, recurrentgemma and
    whisper configs (mamba2's prefill of 45 tokens pads to two chunks,
    recurrentgemma's of 64 takes ``local_window_attention``) and all ten
    reduced configs against the CPU."""
    import importlib.util
    import time
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    corpus = dict(smoke.PIPE_CORPUS, num_partitions=8, docs_per_part=256,
                  doc_len=64, vocab=256)
    query = dict(smoke.PIPE_QUERY, seq_len=64)
    launches, record, first = smoke.pipeline_phase(corpus, query, "cpu",
                                                   host_ms, lambda: None)
    assert launches == dict.fromkeys(launches, 0)
    assert record["bound_by"] == "bytes" and record["bound_ms"] > 0
    assert [tuple(b.shape) for b in first] == [(4, 8, 64)] * 2
    monkeypatch.setattr(smoke, "SERVE", dict(max_batch=4, max_len=128,
                                             prefill_chunk=16))
    monkeypatch.setattr(smoke, "SERVE_PROMPT", (24, 64))
    monkeypatch.setattr(smoke, "SERVE_MAX_NEW", 8)
    monkeypatch.setattr(smoke, "FAMILIES", {
        "mamba2-2.7b": dict(loss=(2, 45), prefill=45),
        "recurrentgemma-2b": dict(loss=(1, 64), prefill=64),
        "whisper-small": dict(loss=(2, 16), prefill=15)})
    smoke.serve_phase(get_config(smoke.SERVE_ARCH, reduced=True), first,
                      "cpu", lambda: None, reduced=True)
