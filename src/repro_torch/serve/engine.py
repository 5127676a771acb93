"""Batched serving engine: prefill + decode over waves of slots (port of
``repro.serve.engine``).

Requests are served in waves of ``max_batch`` slots: a wave's prompts are
left-padded to a common length, prefilled into a decode cache laid out by
``models.api.build_decode_cache``, and every decode step advances all live
slots by one greedy token until each has its ``max_new`` tokens.

The serving analogue of the paper's arbitration also lives here: a cheap
admission rule decides per wave whether its prefill runs as one batched
step (the "pushdown": throughput-optimal, occupies the device) or is
chunked, the first ``prefill_chunk`` positions batched and the rest fed
one position at a time through the decode step (the "pushback":
latency-protective when many decode slots are about to go live). See
``AdmissionPolicy``. Both give the same next-token logits for causal
models: the chunk boundary changes how the KV cache fills, not what it
holds.

The model runs wherever its parameters live (``models.api.init_params``
puts them on the GPU unless given ``device="cpu"``), under ``no_grad``: a
module that trains (``train.loop``) serves without building a graph.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    max_len: int = 256
    prefill_chunk: int = 64      # chunked-prefill unit for the busy path
    greedy: bool = True


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int32
    max_new: int = 16            # per-request output budget: the slot stops
    #                              accumulating, and flips ``done``, at
    #                              exactly this many tokens
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class AdmissionPolicy:
    """Decode-busy arbitration (the serving-side Algorithm-1 analogue):
    batched prefill when few decode slots are going live, chunked when
    many, since a monolithic prefill holds the device for its whole prompt
    just when a big wave of live slots needs per-step latency."""

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg

    def chunked(self, live_slots: int) -> bool:
        return live_slots > self.cfg.max_batch // 2


class ServingEngine:
    def __init__(self, model_cfg: ModelConfig, params, scfg: ServeConfig):
        self.cfg = model_cfg
        self.params = params
        self.scfg = scfg
        self.policy = AdmissionPolicy(scfg)
        self.chunked_prefills = 0    # waves served via the chunked branch
        self.device = params.device

    def _decode(self, cache, pos: int, tok: torch.Tensor):
        return api.decode_step(self.params, self.cfg, cache, pos, tok)

    # ------------------------------------------------------------ serving
    def generate(self, prompts: List[np.ndarray], max_new: int = 16
                 ) -> List[List[int]]:
        """Serve a list of prompts with a shared output budget. Sugar for
        :meth:`serve` over uniform ``Request``s."""
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new=max_new)
                for i, p in enumerate(prompts)]
        self.serve(reqs)
        return [r.out_tokens for r in reqs]

    @torch.no_grad()
    def serve(self, requests: List[Request]) -> List[Request]:
        """Serve requests in waves of ``max_batch`` slots, honoring each
        request's own ``max_new``; the wave ends when every slot is done.
        Ragged prompts are right-aligned by left-padding with 0 (no
        padding mask, as in the reference)."""
        B = self.scfg.max_batch
        for i in range(0, len(requests), B):
            self._serve_wave(requests[i:i + B])
        return requests

    # ------------------------------------------------------------ prefill
    def _prefill(self, toks: torch.Tensor, live_slots: int):
        """Batched or chunked prefill, per the admission policy. Returns
        ``(last_logits (B, V), cache)``."""
        B, P = toks.shape
        chunk = self.scfg.prefill_chunk
        use_chunked = self.policy.chunked(live_slots) and P > chunk
        first = toks if not use_chunked else toks[:, :chunk]
        last, cache = api.build_decode_cache(
            self.params, self.cfg, {"tokens": first}, self.scfg.max_len)
        if not use_chunked:
            return last, cache
        self.chunked_prefills += 1
        for pos in range(chunk, P):
            logits, cache = self._decode(cache, pos, toks[:, pos:pos + 1])
            last = logits[:, -1, :]
        return last, cache

    def _serve_wave(self, wave: List[Request]) -> None:
        B = len(wave)
        P = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, P), np.int32)
        for b, r in enumerate(wave):
            toks[b, P - len(r.prompt):] = r.prompt  # left-pad: align ends
        last_logits, cache = self._prefill(
            torch.from_numpy(toks).to(self.device), live_slots=B)
        # argmax takes the first maximum, as jnp.argmax does
        tok = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]

        def emit(b: int, t: int) -> None:
            r = wave[b]
            if not r.done:
                r.out_tokens.append(t)
                if len(r.out_tokens) >= r.max_new:
                    r.done = True

        first = tok[:, 0].tolist()
        for b, r in enumerate(wave):
            if r.max_new <= 0:
                r.done = True
            else:
                emit(b, first[b])
        pos = P
        while not all(r.done for r in wave):
            logits, cache = self._decode(cache, pos, tok)
            tok = torch.argmax(logits[:, -1, :], dim=-1).to(
                torch.int32)[:, None]
            for b, t in enumerate(tok[:, 0].tolist()):
                emit(b, t)
            pos += 1
