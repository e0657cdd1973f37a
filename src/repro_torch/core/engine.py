"""Batched serving engine front end — the PyTorch counterpart of
``repro.core.engine``. Two modes over one API:

``mode="continuous"`` (default) — delegates to the continuous-batching
subsystem (``repro_torch.serving``): block-granular scheduling, slot
backfill on EOS early exit, streaming chunks.

``mode="batch"`` — the synchronous path: requests are grouped by
(prompt_len, gen_len) shape bucket and the largest group is decoded to
completion. Kept as the baseline continuous serving is compared with.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.decoder import (DecodeConfig, DiffusionDecoder,
                                      round_up_blocks)
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: str
    max_tokens: int = 64
    prompt_tokens: Optional[np.ndarray] = None   # encoded once at submit


@dataclasses.dataclass
class Completion:
    uid: int
    text: str
    tokens: np.ndarray
    latency_s: float
    nfe: int


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, dcfg: DecodeConfig,
                 max_batch: int = 32, mode: str = "continuous", device=None):
        if mode not in ("batch", "continuous"):
            raise ValueError(f"unknown serving mode {mode!r}")
        self.cfg = cfg
        self.dcfg = dcfg
        self.mode = mode
        self.device = resolve_device(device)
        self.tok = ByteTokenizer(cfg.vocab_size)
        self.max_batch = max_batch
        self._decoders: Dict[int, DiffusionDecoder] = {}
        self._params = params
        self._queue: List[Request] = []
        self._uid = 0
        self.stats = defaultdict(float)
        # per-batch GenerateResults, for callers that read the decode
        # counters (NFE, steps per block, block telemetry); batch mode
        self.results: list = []
        self._continuous = None
        if mode == "continuous":
            from repro_torch.serving import ContinuousEngine
            self._continuous = ContinuousEngine(
                cfg, params, dcfg, max_slots=max_batch, tokenizer=self.tok,
                device=self.device)
            self.stats = self._continuous.stats   # one shared counter dict

    def submit(self, prompt: str, max_tokens: int = 64) -> int:
        if self._continuous is not None:
            return self._continuous.submit(prompt, max_tokens)
        self._uid += 1
        self._queue.append(Request(self._uid, prompt, max_tokens,
                                   self.tok.encode(prompt)))
        return self._uid

    def _decoder(self, gen_len: int) -> DiffusionDecoder:
        if gen_len not in self._decoders:
            d = dataclasses.replace(self.dcfg, gen_len=gen_len)
            self._decoders[gen_len] = DiffusionDecoder(
                self.cfg, self._params, d, device=self.device)
        return self._decoders[gen_len]

    def step(self) -> List[Completion]:
        """Serve one scheduling round. Continuous mode: one block for
        every live gang. Batch mode: group queued requests by
        (prompt_len, gen_len) and decode the largest group to
        completion."""
        if self._continuous is not None:
            return [Completion(c.uid, c.text, c.tokens, c.latency_s, c.nfe)
                    for c in self._continuous.step()]
        if not self._queue:
            return []
        groups = defaultdict(list)
        for r in self._queue:
            gl = round_up_blocks(r.max_tokens, self.dcfg.block_size)
            groups[(len(r.prompt_tokens), gl)].append(r)
        key = max(groups, key=lambda k: len(groups[k]))
        batch = groups[key][: self.max_batch]
        taken = {id(r) for r in batch}
        self._queue = [r for r in self._queue if id(r) not in taken]
        prompts = np.stack([r.prompt_tokens for r in batch])
        t0 = time.perf_counter()
        res = self._decoder(key[1]).generate(prompts.astype(np.int32))
        dt = time.perf_counter() - t0
        self.results.append(res)
        self.stats["batches"] += 1
        self.stats["requests"] += len(batch)
        self.stats["tokens"] += res.tokens_generated
        self.stats["time_s"] += dt
        return [Completion(r.uid, self.tok.decode(res.tokens[i]),
                           res.tokens[i], dt, res.nfe)
                for i, r in enumerate(batch)]

    def run_to_completion(self) -> List[Completion]:
        if self._continuous is not None:
            return [Completion(c.uid, c.text, c.tokens, c.latency_s, c.nfe)
                    for c in self._continuous.run_to_completion()]
        out: List[Completion] = []
        while self._queue:
            out.extend(self.step())
        return out

    @property
    def throughput(self) -> float:
        return self.stats["tokens"] / max(self.stats["time_s"], 1e-9)
