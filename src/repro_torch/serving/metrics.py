"""Serving metrics: per-request latency records and fleet aggregates
(copy of ``repro.serving.metrics``).

Thread-safety contract: ``ServeMetrics`` is written by exactly one
decode thread (``add_request``/``sample_tick``/counter ``+=``) and read
by the asyncio thread serving ``/metrics`` and ``/health``
(``snapshot``). The mutating entry points and ``snapshot`` share a
lock, so a snapshot never sees a request list mid-append or totals that
mix two completions; the lone-writer counter assignments
(``queue_depth = ...`` etc.) stay bare — a torn read of a single int is
impossible under the GIL and the lock covers every compound update."""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List

import numpy as np

from repro_torch.obs.metrics import (Histogram, LATENCY_BUCKETS_S,
                               NFE_BUCKETS)


def percentile(values, q: float) -> float:
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclasses.dataclass
class RequestMetrics:
    uid: int
    queue_s: float        # submit -> admitted
    ttfb_s: float         # submit -> first block committed
    latency_s: float      # submit -> finished
    n_tokens: int
    nfe: int
    n_blocks: int
    host_syncs: int = 0   # device->host sync points while the row was live
    logit_syncs: int = 0  # ... of which were full (B, K, V) logit copies
    cache_hit_tokens: int = 0  # prompt KV tokens reused from repro.cache


@dataclasses.dataclass
class ServeMetrics:
    """Aggregated over one engine lifetime. The engine samples slot
    occupancy every scheduler tick and registers each completion."""
    max_slots: int = 0
    requests: List[RequestMetrics] = dataclasses.field(default_factory=list)
    ticks: int = 0
    busy_time_s: float = 0.0           # wall time with >= 1 live row
    wall_time_s: float = 0.0
    occupancy_weighted: float = 0.0    # sum(live/max_slots * tick_dt)
    total_nfe: int = 0
    total_host_syncs: int = 0          # fused loop: ~1 per decoded block
    total_logit_syncs: int = 0         # host loop: 1 per step (fixed-sched)
    # request-lifecycle counters, exported by the HTTP /metrics endpoint
    queue_depth: int = 0               # gauge: queued, not yet in a slot
    admission_rejects: int = 0         # bounded-queue rejections (HTTP 429)
    cancelled: int = 0                 # explicit / disconnect / deadline
    deadline_misses: int = 0           # cancels whose cause was timeout_s
    gang_merges: int = 0               # cross-gang straggler merges
    # cross-request prefix cache (repro.cache): request-level hit
    # counters accumulate per completion; bytes/evictions/nodes are
    # gauges mirrored from the store each engine step
    prefix_cache_hits: int = 0         # completed requests with a warm
                                       # prefill (cache_hit_tokens > 0)
    prefix_cache_hit_tokens: int = 0   # prompt tokens served from cache
    prefix_cache_evictions: int = 0    # chunks evicted (LRU, byte budget)
    prefix_cache_bytes: int = 0        # resident chunk KV bytes
    prefix_cache_nodes: int = 0        # resident chunks
    # block-boundary work stealing (EngineRouter): requests this engine
    # gave up to an idle sibling / adopted from a loaded one
    steals_out: int = 0
    steals_in: int = 0
    # disaggregated prefill/decode pools: busy-seconds split by phase
    # (mirrored from the scheduler each engine step — prefill passes vs
    # decode_block walls) and the prefill→decode handoff flow through
    # the shared radix store
    prefill_busy_s: float = 0.0
    decode_busy_s: float = 0.0
    handoffs_out: int = 0              # rows this engine primed and gave up
    handoffs_in: int = 0               # rows adopted from the prefill pool
    handoff_wait_s: float = 0.0        # extraction -> decode-pool adoption
    # capture ledger (repro_torch.obs.CompileWatch, mirrored each
    # engine step; the JAX package's names kept): block graphs captured
    # vs calls served by captured graphs, wall attributed to capturing
    # calls, and — after startup pre-warm — captures that should not
    # happen
    compile_misses: int = 0
    compile_hits: int = 0
    compile_seconds: float = 0.0
    post_warm_compiles: int = 0
    prewarmed: int = 0                 # 1 once Engine.prewarm() finished
    # effective host budget (repro.launch.host): XLA:CPU intra-op pool
    # threads this engine's dispatches may use (0 = unbudgeted)
    host_threads: int = 0
    # shadow auditor (repro.obs.audit, mirrored each engine step):
    # completions sampled for re-decode, audits finished, jobs dropped
    # at the bounded backlog, bit-level divergences found, and the
    # current backlog depth (gauge)
    audits_sampled: int = 0
    audits_completed: int = 0
    audit_dropped: int = 0
    audit_divergences: int = 0
    audit_backlog: int = 0
    audit_regret: int = 0              # early-exited rows the oracle
                                       # would have continued differently
    # decode thread writes / asyncio metrics reader snapshots
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    # bucketed distributions for Prometheus exposition (each histogram
    # carries its own lock; observed on the decode thread)
    hist_ttfb: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "repro_ttfb_seconds", "Submit to first committed block",
            LATENCY_BUCKETS_S), repr=False, compare=False)
    hist_queue: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "repro_queue_wait_seconds", "Submit to gang admission",
            LATENCY_BUCKETS_S), repr=False, compare=False)
    hist_block_wall: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "repro_block_wall_seconds", "Wall time of one decode_block",
            LATENCY_BUCKETS_S), repr=False, compare=False)
    hist_nfe_per_token: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "repro_nfe_per_token", "Model evaluations per emitted token",
            NFE_BUCKETS), repr=False, compare=False)
    hist_handoff: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "repro_handoff_wait_seconds",
            "Prefill-pool extraction to decode-pool adoption",
            LATENCY_BUCKETS_S), repr=False, compare=False)

    def sample_tick(self, live_rows: int, tick_dt: float) -> None:
        with self._lock:
            self.ticks += 1
            self.wall_time_s += tick_dt
            if live_rows:
                self.busy_time_s += tick_dt
            if self.max_slots:
                self.occupancy_weighted += \
                    (live_rows / self.max_slots) * tick_dt

    def add_request(self, rm: RequestMetrics) -> None:
        with self._lock:
            self.requests.append(rm)
            self.total_nfe += rm.nfe
            self.total_host_syncs += rm.host_syncs
            self.total_logit_syncs += rm.logit_syncs
        self.hist_ttfb.observe(rm.ttfb_s)
        self.hist_queue.observe(rm.queue_s)
        self.hist_nfe_per_token.observe(rm.nfe / max(rm.n_tokens, 1))

    @property
    def histograms(self) -> List[Histogram]:
        return [self.hist_ttfb, self.hist_queue, self.hist_block_wall,
                self.hist_nfe_per_token, self.hist_handoff]

    # ------------------------------------------------------ aggregates

    @property
    def total_tokens(self) -> int:
        with self._lock:
            return sum(r.n_tokens for r in self.requests)

    @property
    def throughput(self) -> float:
        """Generated tokens per second of scheduler wall time."""
        with self._lock:
            tokens = sum(r.n_tokens for r in self.requests)
            return tokens / max(self.wall_time_s, 1e-9)

    @property
    def mean_occupancy(self) -> float:
        with self._lock:
            return self.occupancy_weighted / max(self.wall_time_s, 1e-9)

    @property
    def total_blocks(self) -> int:
        with self._lock:
            return sum(r.n_blocks for r in self.requests)

    def snapshot(self) -> Dict:
        with self._lock:
            requests = list(self.requests)
            wall = self.wall_time_s
            occ = self.occupancy_weighted
            total_nfe = self.total_nfe
            total_syncs = self.total_host_syncs
        lat = [r.latency_s for r in requests]
        ttfb = [r.ttfb_s for r in requests]
        tokens = sum(r.n_tokens for r in requests)
        blocks = sum(r.n_blocks for r in requests)
        return {
            "requests": len(requests),
            "tokens": tokens,
            "wall_time_s": wall,
            "throughput_tok_s": tokens / max(wall, 1e-9),
            "mean_occupancy": occ / max(wall, 1e-9),
            "total_nfe": total_nfe,
            "nfe_per_request": (total_nfe / len(requests)
                                if requests else 0.0),
            # decode-loop residency: the fused device loop syncs ~once
            # per block; the legacy host loop once (or more) per step
            "total_host_syncs": total_syncs,
            "host_syncs_per_block": (total_syncs / blocks
                                     if blocks else 0.0),
            "device_steps_per_block": (total_nfe / blocks
                                       if blocks else 0.0),
            "logit_host_copies": self.total_logit_syncs,
            "queue_depth": self.queue_depth,
            "admission_rejects": self.admission_rejects,
            "cancelled": self.cancelled,
            "deadline_misses": self.deadline_misses,
            "gang_merges": self.gang_merges,
            "prefix_cache_hits": self.prefix_cache_hits,
            "prefix_cache_hit_tokens": self.prefix_cache_hit_tokens,
            "prefix_cache_evictions": self.prefix_cache_evictions,
            "prefix_cache_bytes": self.prefix_cache_bytes,
            "prefix_cache_nodes": self.prefix_cache_nodes,
            "busy_time_s": self.busy_time_s,
            "prefill_busy_s": self.prefill_busy_s,
            "decode_busy_s": self.decode_busy_s,
            "handoffs_out": self.handoffs_out,
            "handoffs_in": self.handoffs_in,
            "handoff_wait_s": self.handoff_wait_s,
            "queue_wait_s": sum(r.queue_s for r in requests),
            "steals_out": self.steals_out,
            "steals_in": self.steals_in,
            "compile_misses": self.compile_misses,
            "compile_hits": self.compile_hits,
            "compile_seconds": self.compile_seconds,
            "post_warm_compiles": self.post_warm_compiles,
            "prewarmed": self.prewarmed,
            "host_threads": self.host_threads,
            "audits_sampled": self.audits_sampled,
            "audits_completed": self.audits_completed,
            "audit_dropped": self.audit_dropped,
            "audit_divergences": self.audit_divergences,
            "audit_backlog": self.audit_backlog,
            "audit_regret": self.audit_regret,
            "latency_p50_s": percentile(lat, 50),
            "latency_p99_s": percentile(lat, 99),
            "ttfb_p50_s": percentile(ttfb, 50),
            "ttfb_p99_s": percentile(ttfb, 99),
        }
