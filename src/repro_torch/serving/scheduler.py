"""Continuous batching at diffusion-block granularity (the PyTorch
counterpart of ``repro.serving.scheduler``).

The unit of work is one *block* of one *gang* — a batch of requests
sharing a shape bucket ``(prompt_len, gen_len)`` that advance in
lockstep through ``DiffusionDecoder.decode_block``. Every scheduler
tick advances each live gang by one block, then harvests: finished rows
(EOS early exit or last block) emit their final chunk immediately, and
the gang is *compacted* — live rows are gathered into a smaller batch,
and freed slots are backfilled from the waiting queue at the same tick.

Graphs and buffers (the graph binding rule, ``core/decoder.py``): on
the card each (B, T, Sq, block start) is one captured CUDA graph, so
every gang batch size is a set of graphs; ``ContinuousEngine.prewarm``
captures them before admission opens, and ``compile_watch`` counts any
capture after that. Every method runs on the decoder's bound KV buffer
of its (B, T), except the states whose cache carries across blocks
(``DiffusionDecoder.cache_carries_state``: dkv, and the prefix cache's
prompt region), which own a buffer (the pool's) that the block is
copied through; compaction and merges gather KV only for them.

Exactness: compaction and merges move a row into a gang of another
shape, which keeps its bits only where ``DiffusionDecoder.
batch_invariant`` holds: on the CPU and on the card for every method
except dkv, whose step-level KV freezing drifts at ulp level when the
batch changes (on the card the model's products run through a GEMM
whose sum order does not depend on the row count, ``kernels/gemm.py``).
dkv gangs therefore keep their admitted batch until every row finishes
(matching the synchronous engine), while the other methods shrink and
backfill freely.

Preemption is block-level: ``preempt(uid)`` extracts the row's
``DecodeState`` at the next block boundary, parks it without a KV
buffer (dkv: with its gathered rows), and re-admits it ahead of the
waiting queue when a slot frees — resuming at the exact block it left
off.

Cancellation is distinct from preemption: ``cancel(uid)`` gives the
slot up for good and terminates the request with a *partial*
``Completion`` (whatever was committed so far, EOS/max_tokens
trimmed). A waiting or paused request is cancelled immediately; an
active row is released at the next block boundary — before the next
tick's decode, so a cancelled request never pays for another block.

Prefix cache (``repro_torch.cache``): with ``DecodeConfig.prefix_cache``
the scheduler owns a ``PrefixKVCache`` bound to its device (or checks
the one it is given), groups admission by (shape bucket, hit depth) so a
gang's prefill computes from a common depth, re-primes a resumed state's
prompt KV from the store, and reports each request's hit tokens.

Fleets (several engines, ``repro_torch.server.EngineRouter``): an idle
sibling steals waiting requests and parked rows at block boundaries
(``steal_waiting`` / ``steal_paused`` / ``adopt_paused``); a parked
state holds only host arrays (dkv rows, which carry their gathered KV,
never leave). A ``prefill_only`` scheduler primes gangs into the shared
prefix store and hands the requests, not their states, to a decode
engine (``take_handoffs`` / ``adopt_handoff``).

Placement across ranks (``executor``, a ``serving.DecodeExecutor``):
gang sizes round up to the executor's data extent (``batch_multiple``),
so a gang's rows split evenly over the data axes; the pool must be
bound to the same executor, and the prefix store to its placement (a
shared store to its mesh shape, ``shape_key``). Every rank of the mesh
runs the same scheduler on the same requests and so makes the same
decisions.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import (DecodeConfig, DecodeState,
                                      DiffusionDecoder, eos_truncate)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs.compile import CompileWatch
from repro_torch.obs.trace import span
from repro_torch.serving.pool import PrefixKVPool
from repro_torch.serving.types import BlockChunk, Completion, ServeRequest


def _pow2_ge(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pow2_le(n: int) -> int:
    assert n >= 1
    return 1 << (n.bit_length() - 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Gang:
    """A batch of requests decoding in lockstep, one block per tick.
    ``requests[i] is None`` marks a padding or vacated lane."""

    def __init__(self, decoder: DiffusionDecoder, state: DecodeState,
                 requests: List[Optional[ServeRequest]]):
        self.decoder = decoder
        self.state = state
        self.requests = requests
        # rows whose final chunk has been emitted (padding lanes never emit)
        self.emitted = [r is None for r in requests]
        # state.nfe high-water mark already attributed to requests. A
        # fresh gang starts at 0 so the dkv prefill pass (counted into
        # state.nfe by prefill()) reaches the first harvest's delta;
        # compacted/resumed states restart their counters at 0 too.
        self.nfe_seen = 0
        self.syncs_seen = 0          # state.host_syncs high-water mark
        self.logit_syncs_seen = 0    # state.logit_syncs high-water mark
        # (B, K) commit-time confidences of the block drained this tick
        # (set by _drain_block_stats, consumed by _harvest same-tick)
        self.last_commit_conf = None

    @property
    def batch(self) -> int:
        return self.state.batch

    def live_rows(self) -> List[int]:
        """Rows still producing output."""
        return [i for i, r in enumerate(self.requests)
                if r is not None and not self.emitted[i]]

    def open_rows(self) -> List[int]:
        """Rows that still need future blocks (drive compaction)."""
        return [i for i, r in enumerate(self.requests)
                if r is not None and not self.state.row_finished(i)]


class BlockScheduler:
    def __init__(self, cfg: ModelConfig, params, dcfg: DecodeConfig, *,
                 max_slots: int = 8, max_gang: Optional[int] = None,
                 pool: Optional[PrefixKVPool] = None,
                 max_waiting: Optional[int] = None,
                 tokenizer=None, mesh=None, pad_pow2: bool = False,
                 executor=None, batch_multiple: Optional[int] = None,
                 merge_gangs: bool = True, prefix_cache=None,
                 prefill_only: bool = False, tracer=None, telemetry=None,
                 block_hist=None, device=None):
        if mesh is not None and (executor is None
                                 or mesh is not executor.mesh):
            raise ValueError("a mesh places the params through a "
                             "DecodeExecutor: pass executor= (its mesh)")
        self.cfg = cfg
        self.params = params
        self.dcfg = dcfg
        self.executor = executor
        if executor is not None:
            device = executor.device
        self.device = resolve_device(device)
        # Disaggregated serving: a prefill-only scheduler admits and
        # prefills gangs exactly like a co-located one (hit-homogeneous
        # grouping included) but never decodes a block: each primed gang
        # is dismantled into ``handoff_ready`` the same tick, its chunk
        # KV already published to the (shared) prefix store, and the
        # owning EngineLoop migrates the requests to a decode-pool engine
        # (``take_handoffs`` / ``adopt_handoff``).
        self.prefill_only = prefill_only
        self.handoff_ready: List[ServeRequest] = []
        self.primed_rows = 0           # rows a prefill-only tick primed
        self.handoff_hit_tokens = 0    # adopted rows' hits at admission
        # busy-seconds split by phase (prefill = prefill passes, decode =
        # decode_block walls)
        self.prefill_wall_s = 0.0
        self.decode_wall_s = 0.0
        # Gang batches are rounded up to this multiple (pad rows
        # replicate row 0, exactly like pad_pow2 padding): the mesh's
        # data extent by default, so a gang's rows split over the data
        # axes (never silent padding; see DecodeExecutor)
        self.batch_multiple = batch_multiple or (
            executor.data_extent if executor is not None else 1)
        self.max_slots = max(max_slots, self.batch_multiple)
        self.max_gang = min(max_gang or self.max_slots, self.max_slots)
        # pad_pow2 snaps gang sizes to a power-of-two ladder: fewest
        # captured batch shapes (log2(max_slots) sizes), at the price of
        # pad rows that burn compute. The default uses exact sizes: at
        # most max_slots distinct batch shapes, and every freed row
        # immediately stops costing FLOPs.
        self.pad_pow2 = pad_pow2
        if pool is None:
            pool = PrefixKVPool(cfg, device=self.device, executor=executor)
        elif pool.executor is not executor:
            # a shared pool across meshes would hand buffers placed on
            # one mesh to decoders driving another: refuse up front
            raise ValueError(
                "PrefixKVPool must be bound to the scheduler's executor "
                f"(pool.executor={pool.executor!r}, "
                f"scheduler executor={executor!r})")
        self.pool = pool
        # the cross-request prefix KV store: like the pool, bound to the
        # device it serves (chunk KV bits differ between the CPU and the
        # card). vanilla has no KV cache, so a store could never be
        # filled or read: it runs storeless
        placement = (executor.placement if executor is not None
                     else device_placement(self.device))
        use_store = dcfg.prefix_cache and dcfg.method != "vanilla"
        if prefix_cache is not None and not use_store:
            raise ValueError(
                "a PrefixKVCache store needs DecodeConfig.prefix_cache "
                "and a non-vanilla method "
                f"(prefix_cache={dcfg.prefix_cache}, "
                f"method={dcfg.method!r})")
        if use_store and prefix_cache is None:
            prefix_cache = PrefixKVCache(chunk_tokens=dcfg.cache_chunk,
                                         placement=placement)
        if prefix_cache is not None:
            # a shared store (disaggregated pools) is keyed by the mesh
            # shape: its chunk KV is host-staged and the same for every
            # executor of that shape on that kind of device
            shape_key = (executor.shape_key if executor is not None
                         else placement)
            if not (tuple(prefix_cache.placement) == placement
                    or (prefix_cache.shared and tuple(prefix_cache.placement)
                        == tuple(shape_key))):
                raise ValueError(
                    "PrefixKVCache must be bound to the scheduler's device "
                    f"or executor placement (store={prefix_cache.placement},"
                    f" scheduler={placement}, shared needs {shape_key})")
            if prefix_cache.chunk_tokens != dcfg.cache_chunk:
                raise ValueError(
                    f"PrefixKVCache chunk {prefix_cache.chunk_tokens} != "
                    f"DecodeConfig.cache_chunk {dcfg.cache_chunk}")
        self.prefix_cache = prefix_cache
        self.max_waiting = max_waiting
        self.tok = tokenizer
        self.merge_gangs = merge_gangs
        self.waiting: Deque[ServeRequest] = deque()
        self.paused: Deque[Tuple[ServeRequest, DecodeState,
                                 DiffusionDecoder]] = deque()
        self.gangs: List[Gang] = []
        self._decoders: Dict[int, DiffusionDecoder] = {}
        self._preempt: set = set()
        self._cancel: set = set()
        self._uid = 0
        self.last_decoded_rows = 0
        self.merges = 0            # cross-gang straggler merges performed
        # observability (repro_torch.obs) — all optional. ``tracer``
        # records queue/decode/block spans on the request's async track
        # plus prefill/decode_block spans on this engine's thread track
        # (``pid`` names the track); ``telemetry`` accumulates the
        # per-block BlockStats the decoder harvests; ``block_hist``
        # observes per-block wall time.
        self.tracer = tracer
        self.telemetry = telemetry
        self.block_hist = block_hist
        self.pid = 0
        # innermost open async span per traced uid ("queue" | "decode"
        # | "paused") — the bookkeeping that keeps span trees balanced
        # through cancel/preempt paths
        self._span_state: Dict[int, str] = {}
        # capture ledger: every call site that can build a block program
        # runs through it, so new graphs are attributed to the call that
        # captured them (and flagged after the startup pre-warm)
        self.compile_watch = CompileWatch()

    # ------------------------------------------------------ bookkeeping

    def _decoder(self, gen_len: int) -> DiffusionDecoder:
        if gen_len not in self._decoders:
            d = dataclasses.replace(self.dcfg, gen_len=gen_len)
            self._decoders[gen_len] = DiffusionDecoder(
                self.cfg, self.params, d, device=self.device,
                executor=self.executor, prompt_cache=self.prefix_cache)
        return self._decoders[gen_len]

    def decoder_for(self, gen_len: int) -> DiffusionDecoder:
        """Public accessor for the per-``gen_len`` decoder (the engine's
        pre-warm drives it directly, outside the admission path)."""
        return self._decoder(gen_len)

    def _reshapes_exactly(self, decoder: DiffusionDecoder) -> bool:
        """Whether a row keeps its bits when it moves to another gang
        (compaction, merge, pow2 padding): always where the decoder is
        batch-invariant; at one gang size (``batch_multiple`` >=
        ``max_gang``) for every state the block refresh rebuilds, since
        the batch then never changes."""
        return decoder.batch_invariant or (
            self.batch_multiple >= self.max_gang
            and not decoder.cache_carries_state)

    def _pad_batch(self, n: int) -> int:
        """Gang-size policy: optional pow2 ladder, then round up to
        ``batch_multiple``."""
        padded = _pow2_ge(n) if self.pad_pow2 else n
        return _round_up(padded, self.batch_multiple)

    def _release(self, decoder: DiffusionDecoder, st: DecodeState) -> None:
        """Return a gang's KV buffer to the pool when the state owns one
        (dkv, prefix cache); a bound buffer belongs to the decoder and
        stays there."""
        if decoder.cache_carries_state and st.cache is not None:
            self.pool.release(st.batch, st.total_len, st.cache)
        st.cache = None

    @property
    def slots_used(self) -> int:
        return sum(g.batch for g in self.gangs)

    @property
    def live_rows(self) -> int:
        return sum(len(g.live_rows()) for g in self.gangs)

    @property
    def idle(self) -> bool:
        return not (self.waiting or self.paused or self.gangs
                    or self.handoff_ready)

    def debug_state(self) -> dict:
        """JSON-safe snapshot of scheduler occupancy for operator
        inspection (``/debug/vars``, flight dumps). ``list()`` snapshots
        keep iteration safe against a decode thread mutating; fields can
        be one tick stale. The keys are the JAX scheduler's, with
        ``graph_cache_size`` (captured block graphs) where it has
        ``jit_cache_size``."""
        gangs = list(self.gangs)
        return {
            "waiting": len(self.waiting),
            "paused": len(self.paused),
            "prefill_only": self.prefill_only,
            "handoff_ready": len(self.handoff_ready),
            "prefill_wall_s": round(self.prefill_wall_s, 6),
            "decode_wall_s": round(self.decode_wall_s, 6),
            "slots_used": self.slots_used,
            "max_slots": self.max_slots,
            "live_rows": self.live_rows,
            "merges": self.merges,
            "pending_preempts": len(self._preempt),
            "pending_cancels": len(self._cancel),
            "graph_cache_size": self.graph_cache_size(),
            "compile": self.compile_watch.counters(),
            "gangs": [{
                "batch": g.batch,
                "live_rows": len(g.live_rows()),
                "block_idx": g.state.block_idx,
                "n_blocks": g.state.n_blocks,
                "prompt_len": g.state.prompt_len,
                "method": g.decoder.dcfg.method,
                "uids": [r.uid for r in list(g.requests)
                         if r is not None],
            } for g in gangs],
        }

    def graph_cache_size(self) -> int:
        """Block programs (on the card, captured CUDA graphs) across
        every decoder — the quantity whose growth the CompileWatch
        ledger attributes to call sites. With an executor, its count
        (the graphs of every decoder driving it, ``jit_cache_size``'s
        place in the JAX scheduler)."""
        if self.executor is not None:
            return self.executor.graph_cache_size()
        return sum(d.graph_cache_size() for d in self._decoders.values())

    # ------------------------------------------------------ submission

    def submit(self, prompt_tokens: np.ndarray, gen_len: int,
               max_tokens: int, trace_id: str = "") -> ServeRequest:
        """Admission control: reject (raise) beyond ``max_waiting``."""
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            raise RuntimeError(
                f"admission rejected: waiting queue at max_waiting="
                f"{self.max_waiting}")
        self._uid += 1
        req = ServeRequest(self._uid, np.asarray(prompt_tokens, np.int32),
                           gen_len, max_tokens, time.perf_counter(),
                           trace_id=trace_id)
        if self.tracer is not None and trace_id:
            self.tracer.async_begin(trace_id, "queue", pid=self.pid,
                                    uid=req.uid)
            self._span_state[req.uid] = "queue"
        if self.prefix_cache is not None:
            # expected hit length: reported in the Completion and the
            # basis of hit-aware admission grouping (_group_key)
            req.expected_hit_tokens = self.prefix_cache.match_len(
                req.prompt_tokens)
        self.waiting.append(req)
        return req

    def preempt(self, uid: int) -> None:
        """Vacate the request's slot at the next block boundary; the
        request resumes from the same block once a slot frees. (For the
        non-batch-invariant dkv baseline the remaining rows keep their
        lanes, so only the preempted request itself is perturbed.)
        Unknown/finished uids are ignored — a stale flag must never
        outlive its request, or it would fire on a future uid."""
        active = any(r is not None and r.uid == uid
                     for g in self.gangs for r in g.requests)
        if active:
            self._preempt.add(uid)

    def cancel(self, uid: int) -> Optional[Completion]:
        """Terminate a request wherever it lives, freeing its resources
        for good (contrast ``preempt``, which parks the state to
        resume). Waiting/paused requests are cancelled *now* and their
        partial ``Completion`` is returned. Active rows are flagged and
        released at the next block boundary — the partial ``Completion``
        comes out of the next ``tick()`` (return value ``None`` here).
        Unknown or already-finished uids return ``None`` and set no
        flag, so a stale cancel can never fire on a future uid."""
        now = time.perf_counter()
        for r in self.waiting:
            if r.uid == uid:
                self.waiting.remove(r)
                return self._make_completion(
                    r, np.zeros(0, np.int32), now, cancelled=True)
        for item in self.paused:
            req, state, decoder = item
            if req.uid == uid:
                self.paused.remove(item)
                K = decoder.dcfg.block_size
                gen = state.x[0, state.prompt_len:
                              state.prompt_len + state.block_idx * K].copy()
                return self._make_completion(req, gen, now, cancelled=True)
        for r in self.handoff_ready:
            # primed but not yet migrated to the decode pool: conclude
            # here, now; the EngineLoop's dispatch skips done tickets, so
            # the cancel fires exactly once
            if r.uid == uid:
                self.handoff_ready.remove(r)
                return self._make_completion(
                    r, np.zeros(0, np.int32), now, cancelled=True)
        active = any(r is not None and r.uid == uid and not g.emitted[i]
                     for g in self.gangs
                     for i, r in enumerate(g.requests))
        if active:
            self._preempt.discard(uid)   # cancel wins over preempt
            self._cancel.add(uid)
        return None

    def _apply_cancels(self):
        """Release cancel-flagged rows at the block boundary: vacate the
        lane before this tick's decode (a cancelled request never pays
        for another block), emit the partial ``Completion`` plus a
        terminal ``BlockChunk`` so streams shut down, then compact so
        freed slots are backfillable this same tick. dkv gangs keep
        their lanes (non-batch-invariant) with ``done`` masking the dead
        row, exactly like preemption."""
        chunks: List[BlockChunk] = []
        completions: List[Completion] = []
        if not self._cancel:
            return chunks, completions
        now = time.perf_counter()
        for gang in self.gangs:
            st = gang.state
            K = gang.decoder.dcfg.block_size
            P = st.prompt_len
            for i in gang.live_rows():
                req = gang.requests[i]
                if req.uid not in self._cancel:
                    continue
                self._cancel.discard(req.uid)
                gen = st.x[i, P:P + st.block_idx * K].copy()
                completions.append(
                    self._make_completion(req, gen, now, cancelled=True))
                chunks.append(BlockChunk(req.uid, st.block_idx,
                                         np.zeros(0, np.int32), "",
                                         True, False))
                gang.requests[i] = None
                gang.emitted[i] = True
                st.done[i] = True
        self._cancel.clear()   # flags never outlive their sweep
        self._compact()
        return chunks, completions

    # ------------------------------------------------------ span hooks

    def _trace_admit(self, req: ServeRequest) -> None:
        """Request entered a gang: close "queue" (first admission only
        — a resumed request's queue span closed long ago) and open
        "decode"."""
        if self.tracer is None or not req.trace_id:
            return
        if self._span_state.get(req.uid) == "queue":
            self.tracer.async_end(req.trace_id, "queue", pid=self.pid)
        self.tracer.async_begin(req.trace_id, "decode", pid=self.pid,
                                uid=req.uid)
        self._span_state[req.uid] = "decode"

    def _trace_finish(self, req: ServeRequest) -> None:
        """Request reached its terminal Completion: close whichever
        span is still open (decode for active/preempt-cancelled rows,
        queue for cancelled-while-waiting; a paused request has
        nothing open — its decode span closed at extraction)."""
        if self.tracer is None or not req.trace_id:
            return
        open_span = self._span_state.pop(req.uid, None)
        if open_span in ("queue", "decode"):
            self.tracer.async_end(req.trace_id, open_span, pid=self.pid)

    # ------------------------------------------------------ stealing

    def steal_waiting(self) -> Optional[ServeRequest]:
        """Give up the *newest* waiting request to an idle sibling engine
        (``EngineRouter`` block-boundary work stealing). Newest first: the
        head of the queue is next in line for this engine's own backfill,
        the tail would wait longest here. Closes the request's "queue"
        span on this engine's track; the thief opens a fresh one when it
        re-admits."""
        if not self.waiting:
            return None
        req = self.waiting.pop()
        if self.tracer is not None and req.trace_id \
                and self._span_state.pop(req.uid, None) == "queue":
            self.tracer.async_end(req.trace_id, "queue", pid=self.pid,
                                  stolen=True)
        return req

    def steal_paused(self) -> Optional[Tuple[ServeRequest, DecodeState]]:
        """Give up one parked (preempted) row, newest first. Only states
        of host arrays leave: a dkv state carries its gathered KV on this
        engine (and dkv is not batch-invariant), so dkv rows always
        resume where they paused. Every other parked state holds no KV
        (``take_rows(alloc_cache=False)``)."""
        for item in reversed(self.paused):
            req, state, decoder = item
            if decoder.dcfg.method == "dkv" or state.cache is not None:
                continue
            self.paused.remove(item)
            self._span_state.pop(req.uid, None)
            if self.tracer is not None and req.trace_id:
                self.tracer.instant("steal_out", pid=self.pid, uid=req.uid)
            return req, state
        return None

    def adopt_paused(self, req: ServeRequest, state: DecodeState) -> int:
        """Adopt a mid-decode row stolen from a sibling engine: the
        request gets a fresh uid in this scheduler's namespace (the
        victim's uid could collide with a live one here) and parks on the
        paused deque at the block it left off. The normal resume path
        (padding to ``batch_multiple``; with the prefix cache, a pool
        buffer and a re-prime from this engine's own store) picks it up at
        the next ``_admit``, so a stolen row decodes exactly like a row
        preempted and resumed on one engine."""
        self._uid += 1
        req.uid = self._uid
        req.stolen += 1
        if self.tracer is not None and req.trace_id:
            self.tracer.async_begin(req.trace_id, "queue", pid=self.pid,
                                    uid=req.uid, stolen=True)
            self._span_state[req.uid] = "queue"
        self.paused.append((req, state, self._decoder(req.gen_len)))
        return req.uid

    # ------------------------------------------------------ handoff

    def take_handoffs(self) -> List[ServeRequest]:
        """Drain the requests a prefill-only tick primed; the owning
        EngineLoop migrates each to a decode-pool engine."""
        out, self.handoff_ready = self.handoff_ready, []
        return out

    def adopt_handoff(self, req: ServeRequest) -> int:
        """Adopt a request primed on a prefill-pool engine: a fresh uid
        in this scheduler's namespace, back onto the waiting queue with
        every lifecycle counter intact (``submit_time`` and the prefill
        pass's nfe/syncs carry over, so the Completion reports end-to-end
        latency). The normal admission prefills it again, but the prefill
        engine already published every aligned chunk to the *shared*
        store, so this pass assembles the prompt KV from it and computes
        only the unaligned remainder; cached and cold prefill are
        bit-identical by construction, so the handed-off output equals
        the single-engine one. Bypasses ``max_waiting`` like
        ``adopt_paused``: the row was admitted once already."""
        self._uid += 1
        req.uid = self._uid
        req.handoffs += 1
        if self.tracer is not None and req.trace_id:
            self.tracer.async_begin(req.trace_id, "queue", pid=self.pid,
                                    uid=req.uid, handoff=True)
            self._span_state[req.uid] = "queue"
        if self.prefix_cache is not None:
            req.expected_hit_tokens = self.prefix_cache.match_len(
                req.prompt_tokens)
        self.waiting.append(req)
        return req.uid

    def _extract_handoffs(self) -> None:
        """Dismantle every primed gang into ``handoff_ready``: the chunk
        KV is in the shared store now (``prefill`` published it), so the
        gang's buffer goes back to the pool and only the *requests*
        travel; no DecodeState and no device tensor crosses engines. The
        prefill pass's nfe/sync deltas are attributed to each row first
        (as ``_harvest`` does)."""
        for gang in self.gangs:
            st = gang.state
            dnfe = st.nfe - gang.nfe_seen
            dsync = st.host_syncs - gang.syncs_seen
            dlogit = st.logit_syncs - gang.logit_syncs_seen
            for req in gang.requests:
                if req is None:
                    continue
                req.nfe += dnfe
                req.host_syncs += dsync
                req.logit_syncs += dlogit
                self._trace_handoff(req)
                self.handoff_ready.append(req)
                self.primed_rows += 1
            self._release(gang.decoder, st)
        self.gangs = []

    def _trace_handoff(self, req: ServeRequest) -> None:
        """Row leaves this engine for the decode pool: close whichever
        span is open on this track (decode, normally) tagged
        ``handoff=True``; the decode engine opens a fresh "queue" span at
        adoption, as for stealing."""
        if self.tracer is None or not req.trace_id:
            return
        open_span = self._span_state.pop(req.uid, None)
        if open_span in ("queue", "decode"):
            self.tracer.async_end(req.trace_id, open_span, pid=self.pid,
                                  handoff=True)
        self.tracer.instant("handoff_out", pid=self.pid, uid=req.uid)

    # ------------------------------------------------------ merge

    def _merge_stragglers(self) -> None:
        """Cross-gang merge: gangs that sit at the same (shape bucket,
        block index) — typically stragglers left ragged by early exits,
        cancels, or split admissions — are fused into one gang before
        the next ``decode_block``, so N part-full block calls become
        one. Only for gangs whose rows move exactly
        (``_reshapes_exactly``); dkv gangs are never touched. Merged rows
        restart their gang-level counters exactly like compaction
        (``take_rows``) does."""
        if not self.merge_gangs or len(self.gangs) < 2:
            return
        groups: Dict[tuple, List[Gang]] = {}
        for g in self.gangs:
            st = g.state
            if not self._reshapes_exactly(g.decoder) or st.finished:
                continue
            if any(r is not None and r.uid in self._preempt
                   for r in g.requests):
                continue    # let preemption extract its row first
            key = (st.prompt_len, st.total_len, st.block_idx)
            groups.setdefault(key, []).append(g)
        for gs in groups.values():
            if len(gs) < 2:
                continue
            gs.sort(key=lambda g: len(g.open_rows()))
            bin_gangs: List[Gang] = []
            bin_rows = bin_slots = 0
            for g in gs:
                r = len(g.open_rows())
                # a merge may never grow the slot footprint: the padded
                # merged batch must fit inside the slots the source
                # gangs release, and stay within the gang-size cap
                fits = (bin_rows + r <= self.max_gang
                        and self._pad_batch(bin_rows + r)
                        <= bin_slots + g.batch)
                if bin_gangs and not fits:
                    if len(bin_gangs) >= 2:
                        self._merge_bin(bin_gangs)
                    bin_gangs, bin_rows, bin_slots = [], 0, 0
                bin_gangs.append(g)
                bin_rows += r
                bin_slots += g.batch
            if len(bin_gangs) >= 2:
                self._merge_bin(bin_gangs)

    def _merge_bin(self, gangs: List[Gang]) -> None:
        """Merge non-dkv gangs (``merge_rows``): the merged state takes
        the bound buffer of its (B, T), or, prefix-cached, a buffer of its
        own gathered from the sources, whose buffers then return to the
        pool."""
        decoder = gangs[0].decoder
        parts: List[Tuple[DecodeState, List[int]]] = []
        reqs: List[Optional[ServeRequest]] = []
        for g in gangs:
            rows = g.open_rows()
            parts.append((g.state, rows))
            reqs.extend(g.requests[i] for i in rows)
        new_b = self._pad_batch(len(reqs))
        if new_b > len(reqs):   # pad lanes replicate the first open row
            parts.append((parts[0][0],
                          [parts[0][1][0]] * (new_b - len(reqs))))
            reqs.extend([None] * (new_b - len(reqs)))
        state = decoder.merge_rows(parts)
        for g in gangs:
            # a prefix-cached source's buffer was read by the merge's
            # gather: release it only now
            self._release(decoder, g.state)
            self.gangs.remove(g)
        self.gangs.append(Gang(decoder, state, reqs))
        self.merges += 1

    # ------------------------------------------------------ tick

    def tick(self) -> Tuple[List[BlockChunk], List[Completion]]:
        """One scheduler round: release cancelled rows → merge
        stragglers → admit → advance every gang one block → harvest
        chunks/completions → compact + backfill."""
        chunks, completions = self._apply_cancels()
        if self.prefill_only:
            # prefill pool: admit (prefill publishes chunk KV to the
            # shared store), dismantle into handoff_ready, then admit
            # again so slots freed by the extraction fill this tick
            self._admit()
            self._extract_handoffs()
            self._admit()
            self._extract_handoffs()
            self.last_decoded_rows = 0
            return chunks, completions
        self._merge_stragglers()
        self._admit()
        # rows whose decode this tick actually pays for — sampled before
        # the decode loop so occupancy isn't attributed post-compaction
        self.last_decoded_rows = self.live_rows
        for gang in self.gangs:
            size0 = self.graph_cache_size()
            t0_ns = time.perf_counter_ns()
            gang.decoder.decode_block(gang.state)
            t1_ns = time.perf_counter_ns()
            self.decode_wall_s += (t1_ns - t0_ns) / 1e9
            self.compile_watch.observe(
                self.graph_cache_size() - size0, (t1_ns - t0_ns) / 1e9,
                "decode_block", tracer=self.tracer, pid=self.pid,
                t0_ns=t0_ns, t1_ns=t1_ns)
            self._drain_block_stats(gang, t0_ns, t1_ns)
            c, comp = self._harvest(gang, gang.state.nfe - gang.nfe_seen,
                                    gang.state.host_syncs - gang.syncs_seen,
                                    gang.state.logit_syncs
                                    - gang.logit_syncs_seen,
                                    t0_ns=t0_ns, t1_ns=t1_ns)
            gang.nfe_seen = gang.state.nfe
            gang.syncs_seen = gang.state.host_syncs
            gang.logit_syncs_seen = gang.state.logit_syncs
            chunks.extend(c)
            completions.extend(comp)
        self._compact()
        # backfill freed slots within the same tick so the next tick
        # decodes at full occupancy
        self._admit()
        return chunks, completions

    def _drain_block_stats(self, gang: Gang, t0_ns: int,
                           t1_ns: int) -> None:
        """Route the BlockStats the decoder just appended: into the
        telemetry aggregator, the block-wall histogram, and a
        thread-track trace span for this engine's timeline. Drained
        every tick so compaction (which builds fresh states) never
        loses or double-counts a block."""
        stats = gang.state.block_stats
        gang.last_commit_conf = None
        if not stats:
            return
        gang.state.block_stats = []
        gang.last_commit_conf = stats[-1].commit_conf
        if self.telemetry is not None:
            self.telemetry.extend(stats)
        if self.block_hist is not None:
            for bs in stats:
                self.block_hist.observe(bs.wall_s)
        if self.tracer is not None:
            last = stats[-1]
            self.tracer.complete(
                "decode_block", t0_ns, t1_ns, pid=self.pid,
                method=last.method, block=last.block_idx,
                batch=last.batch, steps=last.steps,
                committed=last.tokens_committed)

    # ------------------------------------------------------ admission

    def _admit(self) -> None:
        free = self.max_slots - self.slots_used
        # resumed (preempted) states go first, at their original block.
        # A parked state holds no KV and adopts the bound buffer at its
        # next block, or, prefix-cached, gets a pool buffer and its prompt
        # KV re-primed (its own chunks are usually still in the store, so
        # this is O(tail)); a dkv one carries its gathered rows. A resumed
        # row is padded to ``batch_multiple`` like any gang.
        while self.paused and free > 0:
            req, state, decoder = self.paused[0]
            padded = self._pad_batch(state.batch)
            if padded > free:
                break
            self.paused.popleft()
            if padded > state.batch:
                state = decoder.take_rows(
                    state, [0] * padded, alloc_cache=False)
            if state.cache is None and decoder.cache_carries_state:
                def _resume(state=state, decoder=decoder):
                    state.cache = self.pool.acquire(state.batch,
                                                    state.total_len)
                    decoder.prime_prompt_kv(state)
                t0 = time.perf_counter()
                self.compile_watch.watched(
                    _resume, self.graph_cache_size, "resume",
                    tracer=self.tracer, pid=self.pid)
                self.prefill_wall_s += time.perf_counter() - t0
            if req.admit_time < 0:   # resume keeps the first admission
                req.admit_time = time.perf_counter()
            self._trace_admit(req)
            self.gangs.append(Gang(decoder, state,
                                   [req] + [None] * (padded - 1)))
            free -= state.batch
        if free <= 0 or not self.waiting:
            return
        # bucket the queue once per _admit (not per admitted gang — a
        # large backlog is exactly the continuous-batching regime)
        groups: Dict[tuple, List[ServeRequest]] = {}
        for r in self.waiting:
            groups.setdefault(self._group_key(r), []).append(r)
        admitted_ids = set()
        while free > 0:
            # Largest shape group first (mirrors the synchronous
            # engine), but never fragment a group across gangs just to
            # fill freed slots: each block call has a large fixed cost
            # (weight traffic), so splitting one would-be batch into two
            # gangs costs more than briefly idling the slots. A group is
            # admitted when its full target batch fits. (pad_pow2 mode
            # instead caps the gang at the pow2 ladder below max_slots —
            # a padded target larger than max_slots could never fit and
            # would livelock the queue.)
            admitted = False
            for bucket, group in sorted(groups.items(),
                                        key=lambda kv: -len(kv[1])):
                if not group:
                    continue
                decoder = self._decoder(bucket[1])
                n, padded = self._gang_target(len(group), free, decoder)
                if n == 0 or padded > free:
                    continue
                batch_reqs = group[:n]
                del group[:n]
                admitted_ids.update(id(r) for r in batch_reqs)
                self.gangs.append(
                    self._form_gang(decoder, bucket, batch_reqs, padded))
                admitted = True
                free = self.max_slots - self.slots_used
                break
            if not admitted:
                break
        if admitted_ids:
            self.waiting = deque(r for r in self.waiting
                                 if id(r) not in admitted_ids)

    def _group_key(self, r: ServeRequest) -> tuple:
        """Admission group: shape bucket, plus (with the prefix cache on)
        the *current* cached-hit depth in chunks, so gangs form
        hit-homogeneous (a gang's prefill computes from the minimum hit
        across its rows; a cold row in a warm gang would make every row
        pay the cold row's prompt). Queried here, not frozen at submit:
        the cache warms while requests queue."""
        if self.prefix_cache is None:
            return r.bucket
        hit = self.prefix_cache.match_len(r.prompt_tokens)
        return r.bucket + (hit // self.dcfg.cache_chunk,)

    def _gang_target(self, group_len: int, free: int,
                     decoder: DiffusionDecoder):
        """Pick (rows to admit, padded gang batch) for one shape group.
        pow2 snapping only applies to compactable methods
        (``_reshapes_exactly``) — dkv pad rows would decode until the whole gang
        finishes — while ``batch_multiple`` rounding applies to every
        method. The shrink loop keeps the padded target inside
        ``max_slots`` so a rounding multiple that doesn't divide
        ``max_slots`` can never livelock the queue."""
        pow2 = self.pad_pow2 and self._reshapes_exactly(decoder)
        n = min(group_len,
                _pow2_le(min(free, self.max_gang)) if pow2
                else self.max_gang)
        while n > 0:
            padded = _round_up(_pow2_ge(n) if pow2 else n,
                               self.batch_multiple)
            if padded <= self.max_slots:
                return n, padded
            n -= 1
        return 0, 0

    def _form_gang(self, decoder: DiffusionDecoder, bucket, batch_reqs,
                   padded: int) -> Gang:
        P, gen_len = bucket[:2]   # the group key may carry a hit depth
        n = len(batch_reqs)
        prompts = np.stack(
            [r.prompt_tokens for r in batch_reqs]
            + [batch_reqs[0].prompt_tokens] * (padded - n)).astype(np.int32)

        def _build():
            # only a state whose cache carries across blocks owns a
            # buffer; the others run on the decoder's bound one (pool
            # docstring)
            cache = None
            if decoder.cache_carries_state:
                cache = self.pool.acquire(padded, P + gen_len)
            with span(self.tracer, "prefill", pid=self.pid, batch=padded,
                      prompt_len=P):
                return decoder.prefill(prompts, cache=cache)

        t0 = time.perf_counter()
        state = self.compile_watch.watched(
            _build, self.graph_cache_size, "prefill",
            tracer=self.tracer, pid=self.pid)
        now = time.perf_counter()
        self.prefill_wall_s += now - t0
        for i, r in enumerate(batch_reqs):
            if r.admit_time < 0:
                # a handed-off row keeps its first (prefill-pool)
                # admission stamp, like a resumed row: queue_s measures
                # the time to first admission, not the handoff wait
                r.admit_time = now
            if state.prefix_hit_tokens is not None and r.handoffs == 0:
                # a handed-off row's decode-pool prefill hits the store
                # by construction; keep the prefill engine's number, the
                # one that measures reuse across requests
                r.cache_hit_tokens = int(state.prefix_hit_tokens[i])
            elif state.prefix_hit_tokens is not None:
                # ... and count that hit apart: the handoff's own check
                self.handoff_hit_tokens += int(state.prefix_hit_tokens[i])
            self._trace_admit(r)
        rows: List[Optional[ServeRequest]] = \
            list(batch_reqs) + [None] * (padded - n)
        return Gang(decoder, state, rows)

    # ------------------------------------------------------ harvest

    def _decode_text(self, tokens: np.ndarray) -> str:
        return self.tok.decode(tokens) if self.tok is not None else ""

    def _make_completion(self, req: ServeRequest, gen: np.ndarray,
                         now: float, cancelled: bool = False) -> Completion:
        """Terminal record from a raw generated region. EOS-truncates
        (``eos_truncate``, the same policy as ``row_output``), then
        trims to the *requested* ``max_tokens`` — ``gen_len`` is
        block-rounded, and the surplus must never leave the engine."""
        gen, n_tok = eos_truncate(np.asarray(gen, np.int32),
                                  self.cfg.eos_token_id)
        gen = gen[:req.max_tokens]
        n_tok = min(n_tok, req.max_tokens)
        req.finish_time = now
        admit = req.admit_time if req.admit_time >= 0 else now
        first = req.first_block_time if req.first_block_time >= 0 else now
        self._trace_finish(req)
        conf = (np.concatenate(req.commit_conf).astype(np.float32)
                if req.commit_conf else None)
        K = self.dcfg.block_size
        return Completion(
            uid=req.uid, text=self._decode_text(gen), tokens=gen,
            latency_s=now - req.submit_time, nfe=req.nfe,
            ttfb_s=first - req.submit_time,
            queue_s=admit - req.submit_time,
            n_tokens=n_tok, n_blocks=req.blocks_decoded,
            max_tokens=req.max_tokens, cancelled=cancelled,
            host_syncs=req.host_syncs, logit_syncs=req.logit_syncs,
            trace_id=req.trace_id,
            cache_hit_tokens=req.cache_hit_tokens,
            expected_hit_tokens=req.expected_hit_tokens,
            prompt_tokens=req.prompt_tokens,
            commit_conf=conf,
            stolen=req.stolen > 0,
            handed_off=req.handoffs > 0,
            early_exited=req.blocks_decoded * K < req.gen_len)

    def _harvest(self, gang: Gang, dnfe: int, dsync: int = 0,
                 dlogit: int = 0, t0_ns: Optional[int] = None,
                 t1_ns: Optional[int] = None):
        st = gang.state
        K = gang.decoder.dcfg.block_size
        P = st.prompt_len
        eos = self.cfg.eos_token_id
        bidx = st.block_idx - 1
        bstart = P + bidx * K
        now = time.perf_counter()
        chunks: List[BlockChunk] = []
        completions: List[Completion] = []
        for i, req in enumerate(gang.requests):
            if req is None or gang.emitted[i]:
                continue
            req.nfe += dnfe
            req.host_syncs += dsync
            req.logit_syncs += dlogit
            if req.first_block_time < 0:
                req.first_block_time = now
            finished = st.row_finished(i)
            if bidx >= 0:   # a zero-block request decodes nothing
                req.blocks_decoded += 1
                toks = st.x[i, bstart:bstart + K].copy()
                if gang.last_commit_conf is not None:
                    req.commit_conf.append(np.asarray(
                        gang.last_commit_conf[i], np.float32))
                # chunk *text* is what network consumers concatenate:
                # clamp it to the requested max_tokens (gen_len is
                # block-rounded) and mute blocks after an EOS block so
                # joined stream text always equals Completion.text
                allowed = max(0, min(K, req.max_tokens - bidx * K))
                if req.eos_seen:
                    allowed = 0
                text = self._decode_text(toks[:allowed])
                if bool((toks[:allowed] == eos).any()):
                    req.eos_seen = True
                chunks.append(BlockChunk(req.uid, bidx, toks, text,
                                         finished,
                                         bool((toks == eos).any())))
                if self.tracer is not None and req.trace_id \
                        and t0_ns is not None:
                    # the decoded block, attributed to each live
                    # request's async track with the gang's bounds
                    self.tracer.async_span(
                        req.trace_id, f"block {bidx}", t0_ns, t1_ns,
                        pid=self.pid, nfe_delta=dnfe)
            if finished:
                gang.emitted[i] = True
                self._preempt.discard(req.uid)  # flags die with request
                self._cancel.discard(req.uid)
                completions.append(self._make_completion(
                    req, st.x[i, P:].copy(), now))
        return chunks, completions

    # ------------------------------------------------------ compaction

    def _compact(self) -> None:
        kept: List[Gang] = []
        for gang in self.gangs:
            st = gang.state
            # block-level preemption: extract flagged rows first
            for i in list(gang.open_rows()):
                req = gang.requests[i]
                if req.uid in self._preempt:
                    self._preempt.discard(req.uid)
                    sub = gang.decoder.take_rows(st, [i], alloc_cache=False)
                    req.preempted += 1
                    if self.tracer is not None and req.trace_id:
                        self.tracer.async_end(req.trace_id, "decode",
                                              pid=self.pid)
                        self.tracer.instant("preempt", pid=self.pid,
                                            uid=req.uid)
                        self._span_state[req.uid] = "paused"
                    self.paused.append((req, sub, gang.decoder))
                    gang.requests[i] = None
                    gang.emitted[i] = True
                    # if the gang can't compact (dkv), stop the vacated
                    # lane from driving further denoise steps — done
                    # rows no longer extend the block loop, and no
                    # other row reads this lane's state
                    st.done[i] = True
            open_rows = gang.open_rows()
            if not open_rows:
                self._release(gang.decoder, st)
                continue
            if self._reshapes_exactly(gang.decoder):
                new_b = self._pad_batch(len(open_rows))
                if new_b < st.batch:
                    rows = open_rows + [open_rows[0]] * \
                        (new_b - len(open_rows))
                    # the new state takes the bound buffer of its new
                    # (B, T), or, prefix-cached, gathers its prompt KV
                    # and the old buffer returns to the pool
                    new_state = gang.decoder.take_rows(st, rows)
                    self._release(gang.decoder, st)
                    reqs = [gang.requests[i] for i in open_rows] \
                        + [None] * (new_b - len(open_rows))
                    kept.append(Gang(gang.decoder, new_state, reqs))
                    continue
            kept.append(gang)
        self.gangs = kept
