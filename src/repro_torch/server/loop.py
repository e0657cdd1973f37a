"""Dedicated decode-thread tick loop over ``ContinuousEngine`` (a copy of
``repro.server.loop``).

On the card the decode thread is the only thread that runs CUDA work:
graph captures (a bucket that was not prewarmed, the auditor's cold
lane), replays, the host copies around each block and the audit lanes
all happen inside ``engine.step()`` / ``engine.audit_tick()`` here, on
the engine's own stream (``ContinuousEngine.cuda_stream``), so the loops of a
fleet on one card queue their blocks apart. The any-thread API below
and ``debug_vars`` touch Python state only; a steal or a handoff moves
host arrays and requests, never a device tensor. Graphs captured by
``prewarm`` on another thread replay here on the same engine stream.

The continuous batcher is a synchronous pull loop: someone must call
``engine.step()`` for blocks to decode. ``EngineLoop`` owns that call
on a single daemon thread so the asyncio front end never blocks on
device work, and exposes the only thread-safe surface into the engine:

* ``submit(req, deliver)`` — called from any thread. Admission is
  checked synchronously against a bounded in-flight budget (reject →
  ``AdmissionRejected`` → HTTP 429); accepted requests enter a
  priority queue serviced by the decode thread.
* ``cancel(ticket, reason)`` — asynchronous; takes effect immediately
  for requests still queued in the front end, at the next block
  boundary for rows already decoding (see ``BlockScheduler.cancel``).
* events — the decode thread calls ``ticket.deliver(event)`` with
  ``("chunk", BlockChunk)`` per committed block and a final
  ``("done", Completion)``. The HTTP layer bridges ``deliver`` onto a
  per-request ``asyncio.Queue`` via ``call_soon_threadsafe``.

All engine/scheduler state is touched exclusively by the decode thread
(submissions and cancels are marshalled through a command queue), so
the serving subsystem itself needs no locks. Deadlines (``timeout_s``)
are enforced here each iteration: an expired request is cancelled with
reason ``deadline`` and counted in ``ServeMetrics.deadline_misses``.

Block-boundary work stealing (multi-engine fleets): when this loop has
free slots and nothing queued, it asks the ``EngineRouter`` for the
most-backlogged sibling and posts a ``steal`` command to it. The
*victim's* decode thread services the command between ticks — i.e. at a
block boundary, where every row's state is at rest — handing over (in
cheapest-first order) scheduler-waiting requests, front-end-pending
tickets, and finally parked (preempted) rows whose host-side
``DecodeState`` the thief adopts and resumes through the normal
pool-acquire + radix-re-prime path. Ticket ownership (``ticket.loop``)
moves with the request so cancels and deadlines keep routing to
whichever engine currently holds it; in-flight accounting transfers
under both loops' locks. This unfreezes the at-admission load split
that placement-only routing produces.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.log import get_logger
from repro_torch.serving.types import Completion
from repro_torch.server.types import AdmissionRejected, ServerRequest

log = get_logger(__name__)

Event = Tuple[str, object]


class Ticket:
    """Handle for one in-flight request: the cancellation token and the
    delivery target. ``uid`` is assigned once the request is handed to
    the scheduler; until then the ticket lives in the front-end queue
    and can be cancelled without the engine ever seeing it."""

    def __init__(self, req: ServerRequest,
                 deliver: Callable[[Event], None]):
        self.req = req
        self.deliver = deliver
        self.submit_time = time.perf_counter()
        self.deadline = (self.submit_time + req.timeout_s
                         if req.timeout_s else None)
        self.uid: Optional[int] = None
        self.done = False
        self.cancel_reason: Optional[str] = None
        self.loop = None          # owning EngineLoop (set by EngineRouter)
        self.trace_id = ""        # repro_torch.obs correlation id ("" = off)
        self.accept_ns: Optional[int] = None  # HTTP-accept timestamp
        self.handoff_t: Optional[float] = None
                                  # prefill-pool extraction stamp; the
                                  # decode-pool adopter measures the
                                  # handoff wait from it

    def _emit(self, event: Event) -> None:
        try:
            self.deliver(event)
        except Exception:
            log.exception("ticket delivery failed (uid=%s)", self.uid)


class EngineLoop:
    def __init__(self, engine, max_pending: int = 64,
                 idle_poll_s: float = 0.05, tracer=None, index: int = 0,
                 role: Optional[str] = None):
        self.engine = engine
        self.max_pending = max_pending
        self.idle_poll_s = idle_poll_s
        self.index = index          # position in the fleet (track label)
        # pool role (disaggregated serving): "prefill" loops prime and
        # hand off, "decode" loops adopt and decode, "both" is the
        # co-located default. Derived from the engine when not given;
        # a stated role must agree with the engine's mode.
        derived = ("prefill" if getattr(engine, "prefill_only", False)
                   else "both")
        self.role = role or derived
        if (self.role == "prefill") != (derived == "prefill"):
            raise ValueError(
                f"role {self.role!r} does not match engine "
                f"prefill_only={getattr(engine, 'prefill_only', False)}")
        self.tracer = tracer
        if tracer is not None:
            engine.set_tracer(tracer, f"engine-{index}")
        self._cmds: "queue.Queue" = queue.Queue()
        self._pending: List[list] = []      # heap: [-priority, seq, ticket]
        self._seq = itertools.count()
        self._live = {}                     # uid -> Ticket
        self._inflight = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._drain_on_stop = True
        # block-boundary work stealing (set by EngineRouter)
        self.router = None
        self.steal = False
        # quality auditing / post-mortems (set by the front end):
        # SLOWatchdog observes each completion; FlightRecorder is the
        # dump sink for SLO breaches and decode-thread crashes
        self.watchdog = None
        self.flight = None
        # time-series recorder (repro_torch.obs.series; set by the front end).
        # Sampled on the decode thread each iteration, closed at drain.
        self.recorder = None
        self._steal_inflight = False        # one outstanding steal ask
        self._next_steal_t = 0.0            # backoff after an empty grant
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-engine-loop")
        engine.on_chunk(None, self._on_chunk)

    # ------------------------------------------------- any-thread API

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def debug_vars(self) -> dict:
        """Live JSON-safe state for ``GET /debug/vars`` and flight
        dumps: front-end queue depths plus the scheduler's occupancy
        snapshot and steal/compile/audit counters. Read from the
        asyncio thread while the decode thread runs — values may be one
        tick stale but never torn (GIL + list snapshots)."""
        eng = self.engine
        out = {
            "index": self.index,
            "role": self.role,
            "running": self.running,
            "inflight": self.inflight,
            "pending": len(self._pending),
            "live": len(self._live),
            "max_pending": self.max_pending,
            "steals_out": eng.metrics.steals_out,
            "steals_in": eng.metrics.steals_in,
            "handoffs_out": eng.metrics.handoffs_out,
            "handoffs_in": eng.metrics.handoffs_in,
            "scheduler": eng.scheduler.debug_state(),
        }
        if eng.auditor is not None:
            out["audit"] = eng.auditor.stats()
        if self.recorder is not None:
            out["recorder"] = self.recorder.last_rates()
        return out

    def start(self) -> "EngineLoop":
        self._thread.start()
        return self

    def submit(self, req: ServerRequest,
               deliver: Callable[[Event], None],
               count_reject: bool = True) -> Ticket:
        """Admit or reject *synchronously*; never blocks on the engine.
        The bounded budget covers everything submitted but unfinished
        (front-end queue + scheduler queue + decoding rows).

        ``count_reject=False`` raises without touching the rejection
        counter — the multi-engine router spills a rejected request to
        a peer engine, and a spill that gets *served* is not a 429; the
        router counts exactly once when every engine rejects.

        Counter ownership: ``admission_rejects`` is written only here
        and in ``count_admission_reject``, under ``_lock`` (the decode
        thread pre-checks ``max_waiting`` in ``_feed`` so the
        engine-side increment never fires); ``cancelled``/
        ``deadline_misses`` are written only by the decode thread. One
        writer per counter — no torn updates."""
        with self._lock:
            if self._stop.is_set():
                if count_reject:
                    self.engine.metrics.admission_rejects += 1
                raise AdmissionRejected("server is shutting down",
                                        retry_after_s=5.0)
            if self._inflight >= self.max_pending:
                if count_reject:
                    self.engine.metrics.admission_rejects += 1
                raise AdmissionRejected(
                    f"admission queue full ({self.max_pending} in flight)",
                    retry_after_s=1.0)
            self._inflight += 1
        ticket = Ticket(req, deliver)
        if self.tracer is not None:
            ticket.trace_id = self.tracer.new_trace_id()
        self._cmds.put(("submit", ticket, None))
        return ticket

    def count_admission_reject(self) -> None:
        """Record one client-visible 429 (router path: all engines
        rejected)."""
        with self._lock:
            self.engine.metrics.admission_rejects += 1

    def cancel(self, ticket: Ticket, reason: str = "cancelled") -> None:
        self._cmds.put(("cancel", ticket, reason))

    def request_stop(self, drain: bool = True) -> None:
        """Signal the decode thread to stop without waiting — the
        multi-engine router signals every loop first so their drains
        overlap instead of serializing."""
        self._drain_on_stop = drain
        self._stop.set()
        self._cmds.put(("wake", None, None))

    def join(self, timeout_s: float = 30.0) -> bool:
        if self._thread.is_alive():
            self._thread.join(timeout_s)
        return not self._thread.is_alive()

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> bool:
        """Stop the loop. ``drain=True`` finishes everything already
        admitted first (new submits are rejected); ``drain=False``
        cancels all in-flight work. Returns True if the thread exited
        within ``timeout_s``."""
        self.request_stop(drain)
        return self.join(timeout_s)

    # ------------------------------------------------- decode thread

    def _run(self) -> None:
        # however the loop exits (drain, no-drain, or a crash that
        # escaped the per-step guard), the observability capture must
        # close: the recorder flushes its final sample and detaches
        # from the --metrics-log sink, and an active profiler capture
        # is stopped — a drained fleet leaks neither
        try:
            self._run_loop()
        finally:
            self._shutdown_obs()

    def _shutdown_obs(self) -> None:
        if self.recorder is not None:
            self.recorder.close()
        profiler = getattr(self.engine, "profiler", None)
        if profiler is not None:
            try:
                profiler.close()
            except Exception:
                log.exception("profiler close failed at drain")

    def _run_loop(self) -> None:
        eng = self.engine
        if self.tracer is not None:
            self.tracer.name_thread("decode", pid=eng.obs_pid)
        while True:
            busy = bool(self._pending or self._live
                        or not eng.scheduler.idle
                        or eng.audit_pending)
            self._drain_commands(block=not busy)
            if self._stop.is_set():
                if not self._drain_on_stop:
                    self._cancel_all("shutdown")
                elif not (self._pending or self._live or self.inflight
                          or not eng.scheduler.idle
                          or self._draining_prefill_peers()):
                    return
            self._check_deadlines()
            self._feed()
            self._maybe_steal()
            # a placed engine that broke outside a step (an audit tick,
            # a submit) holds tickets no step will finish: its step
            # raises, and the failure path below concludes them
            broken = getattr(eng, "broken", None) is not None \
                and bool(self._live or self._pending)
            if not eng.scheduler.idle or broken:
                try:
                    for comp in eng.step():
                        self._finish(comp)
                except Exception:
                    # an engine failure must not kill the serving
                    # thread: move still-portable work to healthy
                    # siblings, then fail whatever could not move and
                    # keep accepting
                    log.exception("engine.step failed; re-routing and "
                                  "failing in-flight requests")
                    if self.flight is not None:
                        self.flight.dump("crash")
                    # rows primed before the failure are store-backed
                    # and safe to migrate — dispatch them first so the
                    # blanket error-cancel below never reaches them
                    self._dispatch_handoffs()
                    moved = self._reroute_all()
                    if moved:
                        log.info("re-routed %d request(s) off engine %d "
                                 "after step failure", moved, self.index)
                    self._cancel_all("error")
                    if getattr(eng, "broken", None) is not None:
                        # a placed engine lost a rank (serving.replica):
                        # it takes no more work, and the router spills
                        # past this stopped loop
                        self.request_stop(drain=False)
            # prefill pool: migrate rows the step just primed (also
            # drains anything a mid-tick failure left extracted)
            self._dispatch_handoffs()
            # audit lane: one decoder call per iteration, and only when
            # the scheduler reports no waiting traffic (the auditor
            # checks again itself) — paying requests always preempt it
            # at the next block boundary
            eng.audit_tick()
            eng.metrics.queue_depth = (len(self._pending)
                                       + len(eng.scheduler.waiting))
            if self.recorder is not None:
                # cheap per-iteration cadence check; a real sample at
                # most once per interval (repro_torch.obs.series)
                self.recorder.maybe_sample()
            if self._stop.is_set() and not self._drain_on_stop \
                    and not self._live and eng.scheduler.idle:
                return

    def _drain_commands(self, block: bool) -> None:
        try:
            cmd = self._cmds.get(timeout=self.idle_poll_s) if block \
                else self._cmds.get_nowait()
        except queue.Empty:
            return
        while True:
            self._exec(cmd)
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return

    def _exec(self, cmd) -> None:
        kind, ticket, reason = cmd
        if kind == "submit":
            heapq.heappush(self._pending,
                           [-ticket.req.priority, next(self._seq), ticket])
        elif kind == "cancel":
            self._cancel_ticket(ticket, reason)
        elif kind == "steal":            # I'm the victim: (thief, k)
            thief, k = ticket
            self._serve_steal(thief, k)
        elif kind == "steal_give":       # I'm the thief: a queued ticket
            self.engine.metrics.steals_in += 1
            heapq.heappush(self._pending,
                           [-ticket.req.priority, next(self._seq), ticket])
        elif kind == "adopt":            # I'm the thief: a parked row
            self._adopt(*ticket)
        elif kind == "handoff_give":     # I'm a decode engine: a row the
            self._adopt_handoff(*ticket)  # prefill pool just primed
        elif kind == "steal_done":       # grant report: ticket = count
            self._steal_inflight = False
            if not ticket:
                self._next_steal_t = (time.perf_counter()
                                      + 10 * self.idle_poll_s)

    # ------------------------------------------------- work stealing

    def _maybe_steal(self) -> None:
        """Thief side: with free slots and an empty local queue, ask the
        router for the most-backlogged sibling and post it a steal
        command (serviced on the victim's decode thread at its next
        block boundary). One outstanding ask at a time; an empty grant
        backs off so an idle fleet doesn't spin on steal traffic."""
        if (self.router is None or not self.steal or self._steal_inflight
                or self._stop.is_set()):
            return
        if time.perf_counter() < self._next_steal_t:
            return
        sched = self.engine.scheduler
        if self._pending or sched.waiting or sched.paused:
            return
        free = sched.max_slots - sched.slots_used
        if free <= 0:
            return
        victim, backlog = self.router.pick_victim(self)
        if victim is None:
            return
        self._steal_inflight = True
        victim._cmds.put(("steal", (self, max(1, min(free, backlog // 2))),
                          None))

    def _serve_steal(self, thief: "EngineLoop", k: int) -> None:
        """Victim side, on the decode thread between ticks: grant up to
        ``k`` requests, cheapest-to-move first — scheduler-waiting (no
        state), front-end-pending (never reached the engine), then
        parked rows (host DecodeState the thief resumes)."""
        given = 0
        for _ in range(k):
            if not self._steal_one(thief):
                break
            given += 1
        if given:
            log.info("stole %d request(s): engine %d -> engine %d",
                     given, self.index, thief.index)
        thief._cmds.put(("steal_done", given, None))

    def _steal_one(self, thief: "EngineLoop") -> bool:
        eng = self.engine
        req = eng.steal_waiting()
        if req is not None:
            ticket = self._live.pop(req.uid, None)
            if ticket is None:       # direct engine submission: not ours
                eng.return_waiting(req)
                return False
            ticket.uid = None        # thief re-submits through its feed
            self._transfer(ticket, thief)
            thief._cmds.put(("steal_give", ticket, None))
            return True
        while self._pending:
            _, _, ticket = heapq.heappop(self._pending)
            if ticket.done:
                continue
            eng.metrics.steals_out += 1
            self._transfer(ticket, thief)
            thief._cmds.put(("steal_give", ticket, None))
            return True
        out = eng.steal_paused()
        if out is not None:
            req, state = out
            ticket = self._live.pop(req.uid, None)
            if ticket is None:
                eng.return_paused(req, state)
                return False
            ticket.uid = None
            self._transfer(ticket, thief)
            thief._cmds.put(("adopt", (ticket, req, state), None))
            return True
        return False

    def _transfer(self, ticket: Ticket, thief: "EngineLoop") -> None:
        """Move in-flight accounting and cancel/deadline ownership to
        the thief. From here on ``cancel()`` on this loop forwards."""
        ticket.loop = thief
        with self._lock:
            self._inflight -= 1
        with thief._lock:
            thief._inflight += 1

    def _adopt(self, ticket: Ticket, req, state) -> None:
        """Thief side: adopt a stolen parked row. A cancel that raced
        the handoff already concluded the ticket — drop the state (it
        holds no device resources; parked rows travel cache-free)."""
        if ticket.done:
            return
        ticket.uid = self.engine.adopt_paused(req, state)
        self._live[ticket.uid] = ticket

    # ------------------------------------------------- handoff

    def _dispatch_handoffs(self) -> None:
        """Prefill-pool side: migrate every row the scheduler just
        primed to a decode-pool engine. The request travels bare — its
        chunk KV is already in the shared radix store, so the adopter's
        normal admission prefill reassembles it there (O(remainder)).
        The ticket transfers exactly like a steal: ownership moves
        first, so cancels queued behind this iteration forward to the
        adopter and conclude exactly once."""
        eng = self.engine
        if not getattr(eng, "prefill_only", False):
            return
        for req in eng.take_handoffs():
            ticket = self._live.pop(req.uid, None)
            if ticket is None:
                # direct engine submission (no front-end ticket):
                # unsupported on a loop-owned prefill engine — a
                # prefill pool can never complete it locally
                log.error("handoff-ready request without a ticket "
                          "(uid=%s) dropped — submit through the loop",
                          req.uid)
                continue
            if ticket.done:
                continue                 # cancel raced the extraction
            target = (self.router.pick_decode_loop(exclude=self)
                      if self.router is not None else None)
            if target is None:
                # no healthy decode engine: fail the request rather
                # than strand it (the prefill pool cannot decode)
                log.error("no decode-pool engine for handoff "
                          "(uid=%s); failing request", req.uid)
                ticket.uid = None
                self._cancel_ticket(ticket, "error")
                continue
            ticket.uid = None            # adopter assigns its own uid
            ticket.handoff_t = time.perf_counter()
            self._transfer(ticket, target)
            target._cmds.put(("handoff_give", (ticket, req), None))

    def _adopt_handoff(self, ticket: Ticket, req) -> None:
        """Decode-pool side: adopt a prefill-primed request. A cancel
        that raced the migration already concluded the ticket — the
        row's store chunks are unpinned (the prefill pass released
        them), so dropping the request leaks nothing."""
        if ticket.done:
            return
        wait = (time.perf_counter() - ticket.handoff_t
                if ticket.handoff_t is not None else None)
        ticket.handoff_t = None
        ticket.uid = self.engine.adopt_handoff(req, wait_s=wait)
        self._live[ticket.uid] = ticket

    def _draining_prefill_peers(self) -> bool:
        """A draining decode-capable loop may not exit while a prefill
        sibling still holds work — that work's tail is a handoff this
        loop must be alive to adopt. ``inflight`` is the signal — it is
        bumped synchronously at submit (command-queue entries that
        ``_pending``/``_live`` can't see yet) and moves to the adopter
        at transfer, exactly when the obligation moves. Racy cross-
        thread reads (GIL-safe, one-poll stale at worst); a dead
        prefill thread never blocks."""
        if self.router is None or self.role == "prefill":
            return False
        return any(lp.running and (lp.inflight
                                   or not lp.engine.scheduler.idle)
                   for lp in self.router.prefill_pool)

    def _reroute_all(self) -> int:
        """After an ``engine.step`` failure: move still-portable work —
        scheduler-waiting requests, front-end-pending tickets, parked
        host-portable rows — to healthy siblings (same pool first, then
        any decode-capable engine) via the steal machinery, so a
        crashed engine sheds its queue instead of failing it. Active
        gang rows stay: their device state died with the step."""
        if self.router is None:
            return 0
        moved = 0
        while True:
            target = self.router.pick_reroute_target(self)
            if target is None or not self._steal_one(target):
                return moved
            moved += 1

    def _feed(self) -> None:
        """Hand queued requests to the scheduler in priority order.
        The scheduler's own waiting queue is kept topped up to
        ``max_slots`` so its within-tick backfill always has material;
        everything beyond that waits here, where priority and
        pre-admission cancellation still apply. An engine-level
        ``max_waiting`` bound is respected by pre-checking, never by
        letting ``engine.submit`` raise — that path counts an
        admission *reject*, and backing off to retry is not one."""
        sched = self.engine.scheduler
        limit = sched.max_slots if sched.max_waiting is None \
            else min(sched.max_slots, sched.max_waiting)
        while self._pending and len(sched.waiting) < limit:
            _, _, ticket = heapq.heappop(self._pending)
            if ticket.done:
                continue
            try:
                ticket.uid = self.engine.submit(
                    ticket.req.prompt, max_tokens=ticket.req.max_tokens,
                    trace_id=ticket.trace_id)
            except RuntimeError:
                # defensive only (the pre-check makes this unreachable
                # on the single mutating thread): undo the spurious
                # reject count and park the ticket for the next round
                self.engine.metrics.admission_rejects -= 1
                heapq.heappush(self._pending,
                               [-ticket.req.priority, next(self._seq),
                                ticket])
                break
            self._live[ticket.uid] = ticket

    def _check_deadlines(self) -> None:
        now = time.perf_counter()
        expired = [t for t in
                   [e[2] for e in self._pending] + list(self._live.values())
                   if not t.done and t.deadline is not None
                   and now >= t.deadline]
        for t in expired:
            self.engine.metrics.deadline_misses += 1
            self._cancel_ticket(t, "deadline")

    def _cancel_all(self, reason: str) -> None:
        for entry in list(self._pending):
            self._cancel_ticket(entry[2], reason)
        for t in list(self._live.values()):
            self._cancel_ticket(t, reason)

    def _cancel_ticket(self, ticket: Ticket, reason: str) -> None:
        if ticket.done:
            return
        if ticket.loop is not None and ticket.loop is not self:
            # the ticket migrated (work stealing) after this cancel was
            # queued here — forward to the current owner; acting locally
            # would cancel whatever request now holds that uid
            ticket.loop.cancel(ticket, reason)
            return
        ticket.cancel_reason = reason
        if ticket.uid is None:
            # never reached the engine: synthesize the empty completion
            self.engine.metrics.cancelled += 1
            self._conclude(ticket, Completion(
                uid=-1, text="", tokens=np.zeros(0, np.int32),
                latency_s=time.perf_counter() - ticket.submit_time,
                nfe=0, max_tokens=ticket.req.max_tokens, cancelled=True))
            return
        comp = self.engine.cancel(ticket.uid)
        if comp is not None:    # was waiting/paused: finished immediately
            self._live.pop(ticket.uid, None)
            self._conclude(ticket, comp)
        # else: active row — Completion arrives via step() -> _finish

    def _on_chunk(self, chunk) -> None:
        ticket = self._live.get(chunk.uid)
        if ticket is not None and not ticket.done:
            ticket._emit(("chunk", chunk))

    def _finish(self, comp: Completion) -> None:
        ticket = self._live.pop(comp.uid, None)
        if self.watchdog is not None:
            self.watchdog.observe(comp)
        if ticket is not None:
            self._conclude(ticket, comp)

    def _conclude(self, ticket: Ticket, comp: Completion) -> None:
        ticket.done = True
        with self._lock:
            self._inflight -= 1
        ticket._emit(("done", comp))
