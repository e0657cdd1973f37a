"""Continuous-batching serving engine (the PyTorch counterpart of
``repro.serving.engine``): the user-facing front end over
``BlockScheduler`` + ``PrefixKVPool`` + ``StreamRouter`` + metrics.

    eng = ContinuousEngine(cfg, params, dcfg, max_slots=8)
    eng.prewarm([(prompt_len, gen_len)])   # on the card: capture first
    uid = eng.submit("Q:12+34=? A:", max_tokens=32)
    for chunk in eng.stream():          # per-block streaming
        print(chunk.uid, chunk.text, end="")
    print(eng.metrics.snapshot())

or drive it like the synchronous engine:

    eng.submit(...); completions = eng.run_to_completion()

Runs on CUDA unless ``device`` names another device. On the card every
block is a CUDA-graph replay, and a graph is captured at the first use
of its (B, T, Sq, block start): about 1.6 s per block at llada-8b full
depth, during which every gang waits. ``prewarm`` captures every shape
admission and compaction can reach before requests arrive.

With ``DecodeConfig(prefix_cache=True)`` the engine reuses prompt KV
across requests through its scheduler's ``PrefixKVCache``
(``expected_prefix_hit``, the ``prefix_cache_*`` metrics).

Not ported yet: ``prefill_only`` and host budgets (ROADMAP A10; the
scheduler's stealing and handoff raise too), executor placement (A11),
the shadow auditor and the profiler window (A9:
``attach_auditor`` raises; ``audit_tick``/``drain_audits`` do nothing
while no auditor exists).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Iterator, List, Optional, Union

import numpy as np

from repro_torch.core.decoder import DecodeConfig
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs.telemetry import TelemetryAggregator
from repro_torch.obs.trace import span
from repro_torch.serving.metrics import RequestMetrics, ServeMetrics
from repro_torch.serving.pool import PrefixKVPool
from repro_torch.serving.scheduler import BlockScheduler, _not_ported
from repro_torch.serving.stream import RequestStream, StreamRouter
from repro_torch.serving.types import (BlockChunk, Completion,
                                       round_up_blocks)


class ContinuousEngine:
    def __init__(self, cfg: ModelConfig, params, dcfg: DecodeConfig, *,
                 max_slots: int = 8, max_gang: Optional[int] = None,
                 pool: Optional[PrefixKVPool] = None,
                 max_waiting: Optional[int] = None,
                 tokenizer=None, mesh=None, pad_pow2: bool = False,
                 batch_multiple: Optional[int] = None,
                 executor=None, prefix_cache=None, tracer=None,
                 host_budget=None, prefill_only: bool = False,
                 device=None):
        if host_budget is not None:
            _not_ported("per-engine host budgets", "A10")
        self.cfg = cfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.tok = tokenizer or ByteTokenizer(cfg.vocab_size)
        self.pool = pool if pool is not None \
            else PrefixKVPool(cfg, device=self.device)
        self.metrics = ServeMetrics(max_slots=max(max_slots, 1))
        # per-(method, block index) decode dynamics — always on: the
        # numbers ride the block's existing host sync, and the
        # aggregator add is a dict update per block
        self.telemetry = TelemetryAggregator()
        self.tracer = tracer
        self.obs_pid = 0
        self.scheduler = BlockScheduler(
            cfg, params, dcfg, max_slots=max_slots, max_gang=max_gang,
            pool=self.pool, max_waiting=max_waiting, tokenizer=self.tok,
            mesh=mesh, pad_pow2=pad_pow2, executor=executor,
            batch_multiple=batch_multiple, prefix_cache=prefix_cache,
            prefill_only=prefill_only, tracer=tracer,
            telemetry=self.telemetry,
            block_hist=self.metrics.hist_block_wall, device=self.device)
        self.metrics.max_slots = self.scheduler.max_slots
        # the cross-request prefix KV store (None unless dcfg.prefix_cache)
        self.prefix_cache = self.scheduler.prefix_cache
        self.router = StreamRouter()
        self.stats = defaultdict(float)    # ServingEngine's keys

    # ------------------------------------------------------ submission

    def submit(self, prompt: Union[str, np.ndarray],
               max_tokens: int = 64, trace_id: str = "") -> int:
        toks = self.tok.encode(prompt) if isinstance(prompt, str) \
            else np.asarray(prompt, np.int32)
        gen_len = round_up_blocks(max_tokens, self.dcfg.block_size)
        t_ns = time.perf_counter_ns()
        try:
            req = self.scheduler.submit(toks, gen_len, max_tokens,
                                        trace_id=trace_id)
        except RuntimeError:
            self.metrics.admission_rejects += 1
            raise
        if self.tracer is not None and trace_id:
            # "request" opens just before the scheduler's "queue" span
            # (explicit earlier timestamp) and closes in _record — the
            # one terminal point every path (EOS, length, cancel)
            # funnels through
            self.tracer.async_begin(trace_id, "request", pid=self.obs_pid,
                                    t_ns=t_ns, uid=req.uid,
                                    max_tokens=max_tokens)
        return req.uid

    def expected_prefix_hit(self, prompt: Union[str, np.ndarray]) -> int:
        """Longest prefix (tokens) of ``prompt`` resident in this engine's
        cross-request cache; 0 when caching is off. A pure read over the
        store."""
        if self.prefix_cache is None:
            return 0
        toks = self.tok.encode(prompt) if isinstance(prompt, str) \
            else np.asarray(prompt, np.int32)
        return self.prefix_cache.match_len(toks)

    # ------------------------------------------------------ pre-warm

    def prewarm(self, buckets, batch_sizes=None) -> dict:
        """Capture every (prompt_len, gen_len) × gang-batch × block graph
        this engine can reach under load, *before* admission opens, so
        no request waits for a capture (about 1.6 s a block at llada-8b
        full depth on the H100). ``buckets`` is an iterable of
        ``(prompt_len, gen_len)`` shape buckets; ``batch_sizes``
        defaults to every padded gang size admission or compaction can
        produce (1..max_gang through ``_pad_batch``, plus a resumed
        single row, padded the same way). Marks the capture ledger warm;
        any capture after this is counted in ``post_warm_compiles``."""
        sched = self.scheduler
        if batch_sizes:
            sizes = sorted(set(batch_sizes))
        else:
            sizes = sorted({sched._pad_batch(n)
                            for n in range(1, sched.max_gang + 1)}
                           | {sched._pad_batch(1)})
        t0 = time.perf_counter()
        before = sched.graph_cache_size()
        for (P, gen_len) in buckets:
            decoder = sched.decoder_for(gen_len)
            for B in sizes:
                with span(self.tracer, "prewarm", pid=self.obs_pid,
                          batch=B, prompt_len=P, gen_len=gen_len):
                    self._prewarm_one(decoder, P, gen_len, B)
        graphs = sched.graph_cache_size() - before
        wall = time.perf_counter() - t0
        sched.compile_watch.mark_warm()
        self.metrics.prewarmed = 1
        self.metrics.compile_misses = sched.compile_watch.misses
        self.metrics.compile_seconds = sched.compile_watch.seconds
        return {"buckets": [list(b) for b in buckets],
                "batch_sizes": sizes, "graphs": graphs,
                "seconds": round(wall, 2)}

    def _prewarm_one(self, decoder, P: int, gen_len: int, B: int) -> None:
        sched = self.scheduler
        watch = sched.compile_watch
        prompts = np.full((B, P), 1, np.int32)
        cache = None
        if decoder.cache_carries_state:
            cache = self.pool.acquire(B, P + gen_len)
        state = watch.watched(
            lambda: decoder.prefill(prompts, cache=cache),
            sched.graph_cache_size, "prewarm_prefill",
            tracer=self.tracer, pid=self.obs_pid)
        while state.block_idx < state.n_blocks:
            watch.watched(
                lambda: decoder.decode_block(state),
                sched.graph_cache_size, "prewarm_block",
                tracer=self.tracer, pid=self.obs_pid)
            # random or chatty params may emit EOS on dummy prompts;
            # clearing done (a runtime input — the same graph) keeps
            # every later block's graph getting captured too
            state.done[:] = False
        sched._release(decoder, state)

    # ------------------------------------------------------ control

    def preempt(self, uid: int) -> None:
        self.scheduler.preempt(uid)

    def cancel(self, uid: int) -> Optional[Completion]:
        """Terminate a request and free its slot (≠ ``preempt``, which
        parks the state for resumption). Waiting/paused requests finish
        here and now — the partial ``Completion`` is returned and a
        terminal chunk is published so any stream consumer shuts down.
        Active rows are released at the next block boundary and their
        ``Completion`` (``cancelled=True``) comes out of that ``step``;
        this returns ``None`` for them."""
        comp = self.scheduler.cancel(uid)
        if comp is not None:
            self._record(comp)
            self.router.publish([BlockChunk(
                uid, 0, np.zeros(0, np.int32), "", True, False)])
        return comp

    def on_chunk(self, uid: Optional[int], fn) -> None:
        """Register a per-block callback (``uid=None`` = all requests)."""
        self.router.subscribe(uid, fn)

    def open_stream(self, uid: int) -> RequestStream:
        return RequestStream(self.router, uid)

    # ------------------------------------------------------ stepping

    def step(self) -> List[Completion]:
        """One scheduler tick: every live gang advances one block."""
        t0 = time.perf_counter()
        chunks, completions = self.scheduler.tick()
        dt = time.perf_counter() - t0
        # occupancy uses the row count whose decode this tick paid for
        # (sampled pre-harvest), not the post-compaction remainder
        self.metrics.sample_tick(self.scheduler.last_decoded_rows, dt)
        self.router.publish(chunks)
        for comp in completions:
            self._record(comp)
        if chunks or completions:
            self.stats["batches"] += 1
        self.stats["time_s"] += dt
        self.metrics.queue_depth = len(self.scheduler.waiting)
        self.metrics.gang_merges = self.scheduler.merges
        self.metrics.prefill_busy_s = self.scheduler.prefill_wall_s
        self.metrics.decode_busy_s = self.scheduler.decode_wall_s
        watch = self.scheduler.compile_watch
        self.metrics.compile_misses = watch.misses
        self.metrics.compile_hits = watch.hits
        self.metrics.compile_seconds = watch.seconds
        self.metrics.post_warm_compiles = watch.post_warm
        if self.prefix_cache is not None:
            st = self.prefix_cache.stats()
            self.metrics.prefix_cache_bytes = st["bytes"]
            self.metrics.prefix_cache_evictions = st["evictions"]
            self.metrics.prefix_cache_nodes = st["nodes"]
        return completions

    def _record(self, comp: Completion) -> None:
        self.metrics.add_request(RequestMetrics(
            uid=comp.uid, queue_s=comp.queue_s, ttfb_s=comp.ttfb_s,
            latency_s=comp.latency_s, n_tokens=comp.n_tokens,
            nfe=comp.nfe, n_blocks=comp.n_blocks,
            host_syncs=comp.host_syncs, logit_syncs=comp.logit_syncs,
            cache_hit_tokens=comp.cache_hit_tokens))
        if comp.cache_hit_tokens > 0:
            self.metrics.prefix_cache_hits += 1
            self.metrics.prefix_cache_hit_tokens += comp.cache_hit_tokens
        if comp.cancelled:
            self.metrics.cancelled += 1
        if self.tracer is not None and comp.trace_id:
            self.tracer.async_end(comp.trace_id, "request",
                                  pid=self.obs_pid, uid=comp.uid,
                                  cancelled=comp.cancelled)
        self.stats["requests"] += 1
        self.stats["tokens"] += comp.n_tokens
        if not comp.cancelled:
            # goodput: tokens from completions a client actually kept
            self.stats["good_tokens"] += comp.n_tokens

    # ------------------------------------------------------ audit (A9)

    def attach_auditor(self, auditor) -> None:
        _not_ported("the shadow auditor", "A9")

    def audit_tick(self) -> bool:
        """No auditor exists before ROADMAP A9: nothing runs."""
        return False

    def drain_audits(self) -> None:
        """No auditor exists before ROADMAP A9: nothing to drain."""

    # ------------------------------------------------------ driving

    def run_to_completion(self) -> List[Completion]:
        out: List[Completion] = []
        while not self.scheduler.idle:
            out.extend(self.step())
        return out

    def stream(self) -> Iterator[BlockChunk]:
        """Tick until every submitted request finishes, yielding chunks
        as blocks commit. Chunks per request arrive in block order."""
        pending: List[BlockChunk] = []
        self.router.subscribe(None, pending.append)
        try:
            while not self.scheduler.idle:
                self.step()
                while pending:
                    yield pending.pop(0)
        finally:
            self.router.unsubscribe(None, pending.append)

    def generate_stream(self, prompt, max_tokens: int = 64) \
            -> Iterator[BlockChunk]:
        """Submit one request and yield only its chunks."""
        uid = self.submit(prompt, max_tokens)
        for chunk in self.stream():
            if chunk.uid == uid:
                yield chunk
                if chunk.finished:
                    return

    # ------------------------------------------------------ reporting

    @property
    def throughput(self) -> float:
        return self.stats["tokens"] / max(self.stats["time_s"], 1e-9)

    def graph_cache_size(self) -> int:
        return self.scheduler.graph_cache_size()
