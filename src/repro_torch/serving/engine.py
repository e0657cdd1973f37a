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

Observability: ``set_tracer`` claims the engine's trace track (the
``EngineLoop`` calls it), ``attach_auditor`` takes a
``repro_torch.obs.audit.ShadowAuditor`` whose counters ``step`` and
``audit_tick`` mirror into ``metrics``, and ``profiler`` (a
``repro_torch.obs.profiler.BlockProfiler``) is ticked with the blocks
each ``step`` decoded.

Fleets (``repro_torch.server.EngineRouter``): ``steal_waiting`` /
``steal_paused`` / ``adopt_paused`` move work between sibling engines at
block boundaries, and a ``prefill_only`` engine primes prompts into a
shared ``PrefixKVCache`` and hands the requests to a decode engine
(``take_handoffs`` / ``adopt_handoff``). ``host_budget`` (a
``repro_torch.launch.host.HostBudget``) is recorded in ``metrics`` and
on the engine's trace track.

Streams: on the card each engine owns one CUDA stream (``cuda_stream``),
and its device work (``prewarm``, ``step``, ``audit_tick``: prefill,
prime, block replays, captures) runs on it from whichever thread calls
them, so the engines of a fleet on one card queue their work apart. The
weights, made before any engine, are shared and only read; nothing else
on the device crosses engines (a stolen row is host arrays, a handoff is
a request plus the store's host-staged chunk KV). On the CPU
``cuda_stream`` is None.

Placement across ranks: with an ``executor`` (``serving.DecodeExecutor``)
the engine decodes on the executor's device and mesh, and holds one pool
bound to it; every rank of the mesh runs the same engine on the same
requests (SPMD), and rank 0 alone does the I/O. Served over HTTP, rank 0
drives it through a ``serving.replica.EngineProxy`` and every rank of
the mesh replays the calls that change it (``serving.replica.follow``).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.decoder import DecodeConfig, DecodeState
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs.telemetry import TelemetryAggregator
from repro_torch.obs.trace import span
from repro_torch.serving.metrics import RequestMetrics, ServeMetrics
from repro_torch.serving.pool import PrefixKVPool
from repro_torch.serving.scheduler import BlockScheduler
from repro_torch.serving.stream import RequestStream, StreamRouter
from repro_torch.serving.types import (BlockChunk, Completion, ServeRequest,
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
        self.cfg = cfg
        self.dcfg = dcfg
        if executor is not None:
            device = executor.device
        self.device = resolve_device(device)
        # prefill-pool member (disaggregated serving): primes prompt KV
        # into the shared store and hands rows to the decode pool instead
        # of decoding blocks (BlockScheduler.prefill_only)
        self.prefill_only = prefill_only
        # the per-engine host budget (repro_torch.launch.host applies it
        # process-wide; the engine carries it for /metrics and the trace)
        self.host_budget = host_budget
        self.cuda_stream = None
        if self.device.type == "cuda":
            self.cuda_stream = torch.cuda.Stream(self.device)
            # work queued before the engine (the weights) comes first
            self.cuda_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        self.tok = tokenizer or ByteTokenizer(cfg.vocab_size)
        # one pool per executor: buffers are placed on the executor's
        # mesh and must never migrate (see PrefixKVPool)
        self.pool = pool if pool is not None \
            else PrefixKVPool(cfg, device=self.device, executor=executor)
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
        # torch.profiler window over the first N decoded blocks
        # (repro_torch.obs.profiler.BlockProfiler); ticked from step()
        self.profiler = None
        self._prof_blocks_seen = 0
        # shadow auditor (repro_torch.obs.audit): attached by the owning
        # loop or front end; its counters mirror into metrics each step
        self.auditor = None
        if host_budget is not None:
            self.metrics.host_threads = host_budget.intra_op

    def on_stream(self):
        """Context that makes this engine's stream the calling thread's
        current one (nothing on the CPU)."""
        if self.cuda_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.cuda_stream)

    def set_tracer(self, tracer, label: str) -> None:
        """Attach (or re-attach) a tracer and claim a named track for
        this engine — called by the owning EngineLoop/front end, which
        knows the engine's index in the fleet."""
        self.tracer = tracer
        self.obs_pid = tracer.process(label)
        self.scheduler.tracer = tracer
        self.scheduler.pid = self.obs_pid
        if self.host_budget is not None:
            # the effective budget on the engine's track, so a trace
            # always records what it ran under
            tracer.instant("host_budget", pid=self.obs_pid,
                           intra_op=self.host_budget.intra_op,
                           cores=self.host_budget.cores,
                           engines=self.host_budget.engines,
                           source=self.host_budget.source)

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
        with self.on_stream():
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
        if self.prefill_only:
            # a prefill-pool engine never decodes a block: it warms the
            # pool acquire and the prefill only, and captures no graph
            sched._release(decoder, state)
            return
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

    # ------------------------------------------------------ stealing

    def steal_waiting(self) -> Optional[ServeRequest]:
        """Give up the newest waiting request to an idle sibling (see
        ``BlockScheduler.steal_waiting``); closes this engine's "request"
        span: the thief's re-submission opens a fresh one on its own
        track with the same trace id."""
        req = self.scheduler.steal_waiting()
        if req is not None:
            self._close_stolen_span(req)
            self.metrics.steals_out += 1
        return req

    def steal_paused(self):
        """Give up one parked row of host arrays as ``(req, state)`` (or
        None); the same span discipline as ``steal_waiting``."""
        out = self.scheduler.steal_paused()
        if out is not None:
            self._close_stolen_span(out[0])
            self.metrics.steals_out += 1
        return out

    def return_waiting(self, req: ServeRequest) -> None:
        """Take back a request ``steal_waiting`` gave up that no sibling
        could adopt (the owning loop had no ticket for it)."""
        self.scheduler.waiting.append(req)

    def return_paused(self, req: ServeRequest, state: DecodeState) -> None:
        """Take back a parked row ``steal_paused`` gave up, as
        ``return_waiting``."""
        self.scheduler.paused.append(
            (req, state, self.scheduler.decoder_for(req.gen_len)))

    def _close_stolen_span(self, req: ServeRequest) -> None:
        if self.tracer is not None and req.trace_id:
            self.tracer.async_end(req.trace_id, "request",
                                  pid=self.obs_pid, uid=req.uid,
                                  stolen=True)

    def adopt_paused(self, req: ServeRequest, state: DecodeState) -> int:
        """Adopt a stolen mid-decode row: reopens the request's span pair
        on this engine's track and parks it for the normal resume path.
        Returns the fresh uid."""
        self.metrics.steals_in += 1
        t_ns = time.perf_counter_ns()
        uid = self.scheduler.adopt_paused(req, state)
        if self.tracer is not None and req.trace_id:
            # "request" reopens just before the scheduler's "queue" span
            # (an explicit earlier timestamp keeps the nesting sound)
            self.tracer.async_begin(req.trace_id, "request",
                                    pid=self.obs_pid, t_ns=t_ns,
                                    uid=uid, stolen=True)
        return uid

    # ------------------------------------------------------ handoff

    def take_handoffs(self) -> List[ServeRequest]:
        """Drain the rows the last prefill-only step primed (their chunk
        KV already in the shared store). Closes each request's "request"
        span on this engine's track tagged ``handoff=True``; the
        decode-pool adopter reopens it, as for stealing."""
        out = self.scheduler.take_handoffs()
        for req in out:
            self.metrics.handoffs_out += 1
            if self.tracer is not None and req.trace_id:
                self.tracer.async_end(req.trace_id, "request",
                                      pid=self.obs_pid, uid=req.uid,
                                      handoff=True)
        return out

    def adopt_handoff(self, req: ServeRequest,
                      wait_s: Optional[float] = None) -> int:
        """Adopt a request primed on a prefill-pool engine onto this
        engine's waiting queue (its prompt KV comes out of the shared
        store at admission). ``wait_s`` is the extraction-to-adoption gap
        the owning loop measured. Returns the fresh uid."""
        self.metrics.handoffs_in += 1
        if wait_s is not None:
            self.metrics.handoff_wait_s += wait_s
            self.metrics.hist_handoff.observe(wait_s)
        t_ns = time.perf_counter_ns()
        uid = self.scheduler.adopt_handoff(req)
        if self.tracer is not None and req.trace_id:
            self.tracer.async_begin(req.trace_id, "request",
                                    pid=self.obs_pid, t_ns=t_ns,
                                    uid=uid, handoff=True)
        return uid

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
        with self.on_stream():
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
        if self.profiler is not None:
            blocks = self.telemetry.blocks
            self.profiler.tick(blocks - self._prof_blocks_seen)
            self._prof_blocks_seen = blocks
        self._mirror_audit()
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
            # (the repro_torch.obs.series rate decomposition tok_s vs
            # goodput_tok_s reads these two counters)
            self.stats["good_tokens"] += comp.n_tokens
        if self.auditor is not None:
            self.auditor.on_completion(comp)

    # ------------------------------------------------------ audit

    def attach_auditor(self, auditor) -> None:
        """Attach a :class:`repro_torch.obs.audit.ShadowAuditor`. Decode
        thread only from then on — the auditor's counters share the
        metrics mirror's single-writer contract."""
        self.auditor = auditor

    def audit_tick(self) -> bool:
        """Advance the audit lane by at most one decoder call (no-op
        without an auditor or when paying traffic is active — the
        auditor itself defers to the scheduler's admission signals).
        Returns True when audit work ran."""
        if self.auditor is None:
            return False
        with self.on_stream():
            ran = self.auditor.tick()
        if ran:
            # audits finish between scheduler steps — mirror here too,
            # or counters go stale once the engine idles
            self._mirror_audit()
        return ran

    def _mirror_audit(self) -> None:
        if self.auditor is None:
            return
        a = self.auditor
        self.metrics.audits_sampled = a.sampled
        self.metrics.audits_completed = a.completed
        self.metrics.audit_dropped = a.dropped
        self.metrics.audit_divergences = a.divergences_total()
        self.metrics.audit_backlog = a.backlog
        self.metrics.audit_regret = a.regret

    @property
    def audit_pending(self) -> bool:
        return self.auditor is not None and self.auditor.pending

    def drain_audits(self) -> None:
        """Run the audit backlog to empty (offline/test convenience;
        the serving loop instead interleaves single ``audit_tick``
        calls between scheduler ticks)."""
        while self.audit_pending:
            if not self.audit_tick():
                break

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
