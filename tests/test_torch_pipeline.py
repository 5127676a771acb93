"""The port's pushdown data pipeline against the JAX package's, on the CPU.

``repro_torch.data.pipeline`` must give ``repro.data.pipeline``'s batches
bit for bit (its filter and shuffle run through the port's
``fused_scan_shuffle`` plain version here), the same ``stats()`` and the
same per-partition decisions (``last_sim``), in every mode. Mirrors
``tests/test_substrate.py``'s pipeline tests on the port.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.cost import StorageResources as RResources
from repro.data import pipeline as rpipe
from repro.queryproc.operators import hash_partition_ids
from repro_torch.configs import get_config
from repro_torch.core.cost import StorageResources
from repro_torch.core.simulator import MODES
from repro_torch.data.pipeline import (CorpusQuery, PushdownDataPipeline,
                                       synth_corpus)

BATCHES = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, and the tier-1
    run puts several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(query, mode="adaptive", power=1.0, seed=0, n_parts=6, docs=64,
          doc_len=48, corpus_seed=0):
    """(reference pipeline, port pipeline) over the same synthetic corpus."""
    rcorpus = rpipe.synth_corpus(num_partitions=n_parts, docs_per_part=docs,
                                 doc_len=doc_len, vocab=256, hosts=2,
                                 seed=corpus_seed)
    corpus = synth_corpus(num_partitions=n_parts, docs_per_part=docs,
                          doc_len=doc_len, vocab=256, hosts=2,
                          seed=corpus_seed)
    rq = rpipe.CorpusQuery(**dataclasses.asdict(query))
    ref = rpipe.PushdownDataPipeline(rcorpus, rq,
                                     RResources(storage_power=power),
                                     mode=mode, seed=seed)
    port = PushdownDataPipeline(corpus, query,
                                StorageResources(storage_power=power),
                                mode=mode, seed=seed, device="cpu")
    return ref, port


def _assert_same_stream(ref, port, n=BATCHES):
    for _ in range(n):
        want, got = next(ref)["tokens"], next(port)["tokens"]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert port.stats() == ref.stats()
    assert port.last_sim.decisions() == ref.last_sim.decisions()
    assert port.last_sim.per_request == ref.last_sim.per_request


def test_synth_corpus_matches_the_reference():
    for a, b in zip(rpipe.synth_corpus(4, 32, 16, 100, 3, seed=5),
                    synth_corpus(4, 32, 16, 100, 3, seed=5)):
        assert (a.part_id, a.host) == (b.part_id, b.host)
        for f in ("tokens", "quality", "domain", "doc_id"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dp_ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("domains", [None, (0, 2, 3, 5)])
def test_batches_match_the_reference(seed, dp_ranks, domains):
    q = CorpusQuery(min_quality=0.3, domains=domains, seq_len=16,
                    global_batch=8 * dp_ranks, accum=2, dp_ranks=dp_ranks)
    # enough batches to cross into the second epoch
    ref, port = _pair(q, seed=seed)
    _assert_same_stream(ref, port, n=BATCHES + 2 * dp_ranks)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("power", [1.0, 0.1])
def test_every_mode_matches_the_reference(mode, power):
    """The decision changes the statistics, never the batch."""
    q = CorpusQuery(min_quality=0.25, domains=(0, 1, 2, 3, 4, 5), seq_len=16,
                    global_batch=16, accum=2, dp_ranks=2)
    ref, port = _pair(q, mode=mode, power=power, n_parts=16, docs=128,
                      doc_len=64)
    _assert_same_stream(ref, port)
    st = port.stats()
    assert st["admitted"] + st["pushed_back"] == 16
    eager = PushdownDataPipeline(port.corpus, q, mode="eager", device="cpu")
    again = PushdownDataPipeline(port.corpus, q,
                                 StorageResources(storage_power=power),
                                 mode=mode, device="cpu")
    for _ in range(3):
        assert torch.equal(next(again)["tokens"], next(eager)["tokens"])


def test_a_threshold_on_a_stored_quality_value():
    """``quality >= min_quality`` compares a float32 column with a Python
    float in float32 (numpy's rules, NEP 50). A threshold equal to a stored
    value keeps that row; one that rounds down to a stored value in
    float32 keeps it too, though the row is below it in float64."""
    corpus = synth_corpus(num_partitions=3, docs_per_part=64, doc_len=8,
                          vocab=256)
    stored = float(corpus[1].quality[5])
    above = float(np.nextafter(np.float64(stored), np.inf))
    assert np.float32(above) == np.float32(stored) and above > stored
    for thr in (stored, above):
        q = CorpusQuery(min_quality=thr, seq_len=8, global_batch=2,
                        dp_ranks=1)
        ref, port = _pair(q, n_parts=3, docs=64, doc_len=8)
        _assert_same_stream(ref, port, n=4)
        _, counts = port._run_query(1)
        assert counts == [int((corpus[1].quality >= np.float32(thr)).sum())]
        assert (corpus[1].quality == np.float32(stored)).sum() >= 1


def test_determinism_and_shapes():
    cfg = get_config("olmo-1b", reduced=True)
    corpus = synth_corpus(num_partitions=4, docs_per_part=64, doc_len=128,
                          vocab=cfg.vocab_size)
    q = CorpusQuery(min_quality=0.4, seq_len=64, global_batch=8, accum=2,
                    dp_ranks=2)
    a = next(PushdownDataPipeline(corpus, q, seed=7, device="cpu"))
    b = next(PushdownDataPipeline(corpus, q, seed=7, device="cpu"))
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 4, 64)  # (accum, mb, S)


def test_filters_quality():
    corpus = synth_corpus(num_partitions=2, docs_per_part=128, doc_len=64)
    q = CorpusQuery(min_quality=0.9, seq_len=32, global_batch=4, dp_ranks=1)
    pipe = PushdownDataPipeline(corpus, q, device="cpu")
    assert pipe.stats() == {}
    next(pipe)
    kept_docs = sum(int((p.quality >= 0.9).sum()) for p in corpus)
    assert kept_docs < 40  # the filter is actually selective
    assert pipe.stats()["admitted"] + pipe.stats()["pushed_back"] == 2


def test_rank_alignment():
    """Shuffle-to-rank: a document's tokens land on its hash rank."""
    corpus = synth_corpus(num_partitions=2, docs_per_part=64, doc_len=32)
    q = CorpusQuery(min_quality=0.0, seq_len=32, global_batch=4, accum=1,
                    dp_ranks=2)
    rows = next(PushdownDataPipeline(corpus, q, device="cpu"))["tokens"]
    rows = rows.reshape(-1, 32).numpy()  # rows 0-1 rank 0, 2-3 rank 1
    for i, row in enumerate(rows):  # each row is one whole document
        (p, d), = [(p, d) for p, part in enumerate(corpus)
                   for d in range(64) if np.array_equal(part.tokens[d], row)]
        assert hash_partition_ids(corpus[p].doc_id[d:d + 1], 2)[0] == i // 2


def test_without_a_gpu_the_pipeline_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PushdownDataPipeline(synth_corpus(1, 8, 4), CorpusQuery())
