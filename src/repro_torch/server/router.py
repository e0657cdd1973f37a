"""Multi-engine routing: N ``EngineLoop``s (one per device/mesh)
behind one front end (a copy of ``repro.server.router``).

``EngineRouter`` presents the same any-thread surface as a single
``EngineLoop`` (``submit`` / ``cancel`` / ``start`` / ``close`` /
``inflight``), so ``HttpFrontend`` drives either interchangeably. Each
loop owns one ``ContinuousEngine`` — typically bound to its own
``DecodeExecutor`` submesh, so the engines decode on disjoint devices
and the router is the only place where they meet.

Placement policy: **cache affinity, then least-loaded**. Each engine
owns a placement-bound cross-request prefix KV store (``repro.cache``)
— warming is per-engine, so routing a request to the engine whose
store holds the longest matching prompt prefix converts its prefill
from O(prompt) to O(novel tail). The router asks every engine for its
match length (a pure radix-tree walk, no pin) and prefers the deepest
hit; ties — including the everything-cold case, and any engine with
caching off — fall back to least loaded, where *load* weights a
decoding row at 1 and a still-queued (prefill-pending) row at
``PREFILL_PENDING_WEIGHT`` — a queued request has not claimed a slot
or any block-time yet, so counting it like a live gang row skews the
pick toward engines that merely have deep (cheap) queues. A request is
pinned to one engine at submit time (gang batching is per-scheduler,
so migrating later would restart the request). Reads of another
thread's scheduler/store state are racy by construction — these are
*heuristics*, and a one-tick stale read costs at most a slightly
uneven split or a missed hit.

Admission: the picked loop may reject (its bounded budget is full);
the router then tries the remaining loops in load order and only
re-raises when *every* engine rejected — one hot engine must not turn
away traffic the others could serve.

Placement-at-admission is no longer final: with ``steal=True`` (the
default) an idle loop asks ``pick_victim`` for the most-backlogged
sibling and steals waiting/paused requests from it at block boundaries
(see ``EngineLoop``), so a load split frozen by a bad heuristic read
self-corrects instead of persisting for the requests' lifetime.

Disaggregated pools: when the fleet mixes ``role="prefill"`` loops
(``ContinuousEngine(prefill_only=True)`` publishing chunk KV into ONE
shared radix store) with decode-capable loops, the router becomes
role-aware. A request whose chunk-aligned prompt prefix is not yet in
the shared store routes to the prefill pool (primed there, then handed
off to a decode loop via ``pick_decode_loop``); a fully-cached request
bypasses the prefill pool entirely. The other pool is kept as an
admission spill target only — a decode engine can always prime for
itself, and a prefill engine's handoff path can always finish a
request, so a full preferred pool degrades to the co-located behavior
instead of a 429. Stealing never crosses roles: ``pick_victim`` fences
on ``thief.role`` (a prefill engine must not adopt decode rows it can
never finish, and decode engines stealing prefill-pending work would
re-create the interference disaggregation removes).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.obs.log import get_logger
from repro_torch.server.loop import EngineLoop, Ticket
from repro_torch.server.types import AdmissionRejected, ServerRequest

log = get_logger(__name__)

# relative cost of a prefill-pending (queued, slotless) row vs a live
# decoding row in every load/backlog estimate below
PREFILL_PENDING_WEIGHT = 0.25


class EngineRouter:
    def __init__(self, loops: List[EngineLoop], steal: bool = True):
        assert loops, "EngineRouter needs at least one EngineLoop"
        self.loops = list(loops)
        self.prefill_pool = [lp for lp in self.loops
                             if lp.role == "prefill"]
        self.decode_pool = [lp for lp in self.loops
                            if lp.role != "prefill"]
        self.disaggregated = bool(self.prefill_pool) \
            and bool(self.decode_pool)
        if self.prefill_pool and not self.decode_pool:
            raise ValueError("a fleet of only prefill engines can never "
                             "complete a request")
        self.steal = steal and len(self.loops) > 1
        for lp in self.loops:
            lp.router = self
            # stealing is fenced to same-role siblings, so a loop only
            # asks when its own pool has a potential victim
            pool = (self.prefill_pool if lp.role == "prefill"
                    else self.decode_pool)
            lp.steal = self.steal and len(pool) > 1

    # ---------------------------------------------------- loop surface

    @property
    def engines(self):
        """The per-loop ``ContinuousEngine``s (metrics/health fan-in)."""
        return [lp.engine for lp in self.loops]

    @property
    def engine(self):
        """Single-engine compatibility alias (first engine)."""
        return self.loops[0].engine

    @property
    def inflight(self) -> int:
        return sum(lp.inflight for lp in self.loops)

    @property
    def running(self) -> bool:
        return all(lp.running for lp in self.loops)

    def start(self) -> "EngineRouter":
        for lp in self.loops:
            if not lp.running:
                lp.start()
        return self

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> bool:
        # signal every loop before joining any: the drains overlap
        # instead of serializing one engine's tail behind another's —
        # and the joins share ONE deadline, so a hung engine can't
        # stretch the caller's bound to N * timeout_s. Prefill loops
        # are joined first: their drains end in handoffs the decode
        # pool must still be alive to adopt.
        for lp in self.loops:
            lp.request_stop(drain)
        deadline = time.monotonic() + timeout_s
        ok = True
        for lp in self.prefill_pool + self.decode_pool:
            ok = lp.join(max(0.0, deadline - time.monotonic())) and ok
        return ok

    # ---------------------------------------------------- routing

    def _loop_load(self, lp: EngineLoop) -> float:
        """Weighted engine load: decoding rows (live in a gang) and
        parked mid-decode rows count 1; rows that are merely queued
        (front-end pending + scheduler waiting — no slot, no KV, no
        block-time yet) count ``PREFILL_PENDING_WEIGHT``."""
        sched = lp.engine.scheduler
        queued = len(lp._pending) + len(sched.waiting)
        return (sched.live_rows + len(sched.paused)
                + PREFILL_PENDING_WEIGHT * queued)

    def _by_load(self, loops: List[EngineLoop]) -> List[EngineLoop]:
        return [lp for _, lp in
                sorted(((self._loop_load(lp), lp) for lp in loops),
                       key=lambda it: (it[0], it[1].inflight, it[1].index))]

    def _needs_prefill(self, req: ServerRequest) -> bool:
        """True iff the request's chunk-aligned prompt prefix is not
        fully resident in the shared store — i.e. a prefill-pool pass
        would publish chunks a decode engine could then reuse. Prompts
        shorter than one chunk have no publishable prefix (the decode
        engine computes the remainder either way), so they bypass."""
        eng = self.decode_pool[0].engine
        store = getattr(eng, "prefix_cache", None)
        if store is None:
            return False
        try:
            toks = (eng.tok.encode(req.prompt)
                    if isinstance(req.prompt, str)
                    else np.asarray(req.prompt, np.int32))
        except Exception:          # malformed prompt: let submit raise
            return False
        C = store.chunk_tokens
        aligned = (len(toks) // C) * C
        return aligned > 0 and store.match_len(toks) < aligned

    def _load_order(self, req: ServerRequest = None) -> List[EngineLoop]:
        if self.disaggregated and req is not None:
            # role-aware: pick the pool, least-loaded within it; the
            # other pool rides along as an admission spill target (see
            # module docstring). No per-engine hit probe — the store is
            # shared, so affinity is meaningless within a pool.
            first, second = ((self.prefill_pool, self.decode_pool)
                             if self._needs_prefill(req)
                             else (self.decode_pool, self.prefill_pool))
            return self._by_load(first) + self._by_load(second)
        hits = [0] * len(self.loops)
        probe = (req is not None and len(self.loops) > 1
                 and any(getattr(lp.engine, "prefix_cache", None) is not None
                         for lp in self.loops))
        if probe:
            try:
                # tokenize once, probe every store with the ids —
                # engines share one tokenizer family by construction
                toks = self.loops[0].engine.tok.encode(req.prompt)
                for i, lp in enumerate(self.loops):
                    hits[i] = lp.engine.expected_prefix_hit(toks)
            except Exception:         # affinity is best-effort, never fatal
                log.exception("prefix-hit probe failed")

        def load(item):
            i, lp = item
            return (-hits[i], self._loop_load(lp), lp.inflight, i)
        return [lp for _, lp in
                sorted(enumerate(self.loops), key=lambda it: load(it))]

    def submit(self, req: ServerRequest,
               deliver: Callable[[tuple], None]) -> Ticket:
        order = self._load_order(req)
        last_reject = None
        for lp in order:
            try:
                # count_reject=False: a spill that a peer serves is not
                # a 429 — the counter moves only when everyone rejects
                ticket = lp.submit(req, deliver, count_reject=False)
            except AdmissionRejected as e:
                last_reject = e
                continue
            ticket.loop = lp        # cancel() routes back to the owner
            return ticket
        order[-1].count_admission_reject()
        raise last_reject

    def cancel(self, ticket: Ticket, reason: str = "cancelled") -> None:
        (ticket.loop or self.loops[0]).cancel(ticket, reason)

    # ---------------------------------------------------- stealing

    def pick_victim(self, thief: EngineLoop):
        """Most-backlogged loop in the *thief's own pool* (steal never
        crosses roles), where backlog is work beyond what the victim's
        own free slots will absorb next tick (front-end pending +
        scheduler waiting + parked rows − free slots). Victims are
        ranked by the weighted form — parked mid-decode rows at 1,
        merely-queued rows at ``PREFILL_PENDING_WEIGHT`` — so a deep
        but cheap queue no longer outbids parked rows that are actually
        starving. Reads of other threads' state are racy heuristics,
        same contract as ``_load_order``; the steal handshake itself is
        command-queue-serialized on the victim's decode thread. Returns
        ``(loop, backlog)`` or ``(None, 0)``."""
        best, best_backlog = None, 0
        best_score = float("-inf")
        for lp in self.loops:
            if lp is thief or not lp.running or lp.role != thief.role:
                continue
            sched = lp.engine.scheduler
            free = max(0, sched.max_slots - sched.slots_used)
            queued = len(lp._pending) + len(sched.waiting)
            parked = len(sched.paused)
            backlog = queued + parked - free
            if backlog <= 0:
                continue
            score = parked + PREFILL_PENDING_WEIGHT * queued - free
            if score > best_score:
                best, best_backlog, best_score = lp, backlog, score
        return best, best_backlog

    # ---------------------------------------------------- handoff

    def pick_decode_loop(self, exclude: Optional[EngineLoop] = None) \
            -> Optional[EngineLoop]:
        """Least-loaded running decode-capable loop — the prefill pool
        calls this to place each primed row. ``None`` when the decode
        pool is gone (caller fails the request rather than strand it)."""
        alive = [lp for lp in self.decode_pool
                 if lp is not exclude and lp.running]
        order = self._by_load(alive)
        return order[0] if order else None

    def pick_reroute_target(self, failed: EngineLoop) \
            -> Optional[EngineLoop]:
        """Healthy destination for work shed off a crashed engine:
        least-loaded same-role sibling first (it serves the same
        traffic shape), decode-capable loops otherwise (they can both
        prime and decode, so they can absorb anything)."""
        same = [lp for lp in self.loops
                if lp is not failed and lp.running
                and lp.role == failed.role]
        order = self._by_load(same)
        if order:
            return order[0]
        return self.pick_decode_loop(exclude=failed)
