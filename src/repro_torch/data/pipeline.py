"""Training-data pipeline with adaptive computation pushdown (port of
``repro.data.pipeline``).

The paper's engine, pointed at an ML corpus instead of TPC-H: the trainer
declares a corpus query (quality/domain filters, the token columns it
needs, shuffle-to-DP-rank). Each corpus partition becomes one pushdown
request; the same Arbitrator (Algorithm 1, ``core.simulator.simulate``)
decides per partition whether the storage host runs the query or pushes
raw data back. Either side runs the same operators, so the decision
changes the statistics, never the batch.

On the device the filter and the shuffle are one ``fused_scan_shuffle``
launch per partition: the predicate's packed words, every document's
Knuth-hash rank (of its ``doc_id``) and the kept documents per rank. The
kept rows come from the words, and one gather of the token rows in rank
order follows. Corpora and epoch orders come from numpy's generators,
so they equal the reference's bit for bit; batches are device tensors of
shape (accum, mb, S), mb rank-aligned.

Everything is deterministic in (seed, step): a restart resumes the stream
exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cost import RequestCost, StorageResources
from repro_torch.core.simulator import (MODE_ADAPTIVE, SimRequest, SimResult,
                                        simulate)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import unpack_bitmap
from repro_torch.queryproc.expressions import Col, Expr


@dataclasses.dataclass(frozen=True)
class CorpusQuery:
    """What the trainer asks of the corpus (the pushable plan)."""
    min_quality: float = 0.3
    domains: Optional[Tuple[int, ...]] = None
    seq_len: int = 1024
    global_batch: int = 8
    accum: int = 1
    dp_ranks: int = 1

    def predicate(self) -> Expr:
        p: Expr = Col("quality") >= self.min_quality
        if self.domains is not None:
            p = p & Col("domain").isin(self.domains)
        return p


@dataclasses.dataclass
class CorpusPartition:
    part_id: int
    host: int
    tokens: np.ndarray    # (docs, doc_len) int32
    quality: np.ndarray   # (docs,) f32
    domain: np.ndarray    # (docs,) int32
    doc_id: np.ndarray    # (docs,) int64 (stable global ids)


def synth_corpus(num_partitions: int = 8, docs_per_part: int = 256,
                 doc_len: int = 512, vocab: int = 32000, hosts: int = 2,
                 seed: int = 0) -> List[CorpusPartition]:
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(num_partitions):
        parts.append(CorpusPartition(
            part_id=p, host=p % hosts,
            tokens=rng.integers(1, vocab, (docs_per_part, doc_len),
                                dtype=np.int32),
            quality=rng.random(docs_per_part).astype(np.float32),
            domain=rng.integers(0, 8, docs_per_part, dtype=np.int32),
            doc_id=(np.arange(docs_per_part, dtype=np.int64)
                    + p * docs_per_part)))
    return parts


@dataclasses.dataclass
class _DevicePartition:
    tokens: torch.Tensor
    cols: Dict[str, torch.Tensor]   # quality, domain
    doc_id: torch.Tensor


class PushdownDataPipeline:
    """Iterator of rank-aligned microbatched token batches, on ``device``
    (the GPU unless given ``device="cpu"``)."""

    def __init__(self, corpus: List[CorpusPartition], query: CorpusQuery,
                 res: StorageResources = StorageResources(),
                 mode: str = MODE_ADAPTIVE, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.corpus = corpus
        self.query = query
        self.res = res
        self.mode = mode
        self.seed = seed
        self.last_sim: Optional[SimResult] = None
        self._parts = [_DevicePartition(
            torch.from_numpy(p.tokens).to(self.device),
            {"quality": torch.from_numpy(p.quality).to(self.device),
             "domain": torch.from_numpy(p.domain).to(self.device)},
            torch.from_numpy(p.doc_id).to(self.device)) for p in corpus]
        self._stream = self._build_stream()

    # ------------------------------------------------ the pushdown query
    def _partition_cost(self, part: CorpusPartition) -> RequestCost:
        raw = part.tokens.nbytes + part.quality.nbytes + part.domain.nbytes
        sel = float(np.clip(1.0 - self.query.min_quality, 0.01, 1.0))
        if self.query.domains is not None:
            sel *= len(self.query.domains) / 8.0
        return RequestCost(s_in=raw, s_out=int(raw * sel) + 64,
                           compute_in=raw)

    def _run_query(self, pi: int) -> Tuple[torch.Tensor, List[int]]:
        """The corpus query on one partition: (the kept documents' token
        rows grouped by rank, in partition order within a rank; the kept
        documents per rank, read to the host)."""
        part = self._parts[pi]
        words, pids, hist = kops.fused_scan_shuffle(
            part.cols, self.query.predicate(), part.doc_id,
            self.query.dp_ranks)
        keep = torch.nonzero(unpack_bitmap(words, len(pids))).flatten()
        order = torch.sort(pids[keep], stable=True).indices
        return part.tokens.index_select(0, keep[order]), hist.tolist()

    def _build_stream(self) -> Iterator[Dict[str, torch.Tensor]]:
        q = self.query
        # arbitrate all partition requests once per epoch (they re-arrive
        # every epoch; decisions adapt to storage_power)
        reqs = [SimRequest(p.part_id, p.host, "corpus",
                           self._partition_cost(p)) for p in self.corpus]
        self.last_sim = simulate(reqs, self.res, self.mode)

        per_rank: List[List[torch.Tensor]] = [[] for _ in range(q.dp_ranks)]
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(len(self.corpus))
        while True:
            for pi in order:
                toks, counts = self._run_query(int(pi))
                for r, rt in enumerate(torch.split(toks, counts)):
                    if len(rt):
                        per_rank[r].append(rt.reshape(-1))
                yield from self._drain(per_rank)
            order = rng.permutation(len(self.corpus))

    def _drain(self, per_rank) -> Iterator[Dict[str, torch.Tensor]]:
        """Pack per-rank token streams into (accum, mb, S) batches."""
        q = self.query
        mb = q.global_batch // q.accum
        rows_per_rank = max(1, mb // q.dp_ranks)
        need = q.seq_len * rows_per_rank * q.accum
        while all(sum(map(len, s)) >= need for s in per_rank):
            rank_rows = []
            for r in range(q.dp_ranks):
                buf = torch.cat(per_rank[r]) if len(per_rank[r]) > 1 \
                    else per_rank[r][0]
                take, rest = buf[:need], buf[need:]
                per_rank[r] = [rest] if len(rest) else []
                rank_rows.append(take.reshape(q.accum, rows_per_rank,
                                              q.seq_len))
            # (accum, mb, S): microbatch dim = concat over ranks
            yield {"tokens": torch.cat(rank_rows, dim=1)}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return next(self._stream)

    # ------------------------------------------------------------ metrics
    def stats(self) -> Dict[str, float]:
        sim = self.last_sim
        if sim is None:
            return {}
        return {"admitted": float(sim.admitted()),
                "pushed_back": float(sum(sim.pushed_back_by_query.values())),
                "ingest_makespan_s": sim.makespan,
                "ingest_net_bytes": sim.net_bytes}
