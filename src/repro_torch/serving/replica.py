"""Serving placed engines from one controller: the op log.

The JAX package serves a fleet from one process: every engine's work is
put on its submesh by GSPMD. The port is SPMD (``launch.mesh``): one
process a rank, and every rank of a mesh must make the same scheduler
decisions in the same order. The HTTP front end's decisions are the
process's own (admissions, cancels and deadlines, steals, which loop a
request goes to: a clock, a thread's timing, a client's order), so rank
0 alone makes them, as the JAX package's process does, and every other
rank replays them:

* ``ControlGroup``: one gloo group an engine, over rank 0 and the ranks
  of the engine's submesh (``make_control_groups``; every rank makes
  every group in the same order, since a new group is a collective of
  the whole world). It is never used inside a CUDA-graph capture, and
  its timeout is a year: a follower may wait for the next op while the
  server idles.
* ``EngineProxy``: what rank 0's ``EngineLoop``, ``EngineRouter`` and
  ``HttpFrontend`` hold in place of each engine. Every call that changes
  an engine (``OPS``) is one op, broadcast on the engine's control group
  before any rank executes it. The submesh's first rank (the *leader*;
  rank 0 itself for engine 0) broadcasts the op's result: what the call
  returned, the ``BlockChunk``s it published (the proxy publishes them
  to rank 0's subscribers, so SSE streams work) and a snapshot of the
  host state that the loop, the router and the front end read
  (``scheduler``, ``metrics``, ``stats``, ``telemetry``, the graph
  count). ``expected_prefix_hit`` and ``state`` are queries: the leader
  answers and no rank replays them.
* ``Replica``: executes the ops on this rank's ``ContinuousEngine``.
  ``follow`` is the loop of every rank but 0: take an op, execute it,
  and check it against the leader's result (the uid ``submit`` and
  ``adopt_paused`` gave, the uids and tokens ``step`` finished, what
  ``steal_*`` and ``cancel`` gave); a mismatch raises
  ``ReplicaDivergence`` and the rank exits non-zero. An op that raised
  on the leader must raise alike on every rank, and is re-raised on
  rank 0.

The proxy's ``metrics`` is a ``ServeMetrics`` of rank 0's: the loop's
own counters (admission rejects, front-end cancels, deadline misses,
front-end steals, the queue depth) are written there, and each result
adds what changed on the leader's engine since the last one. A
collective that fails (a rank of the engine died) breaks the proxy: it
reports the requests it knew were waiting so the loop re-routes them,
fails the rest, and stops its loop (``broken``, ``on_break``).

Observability rides the same log:

* the shadow auditor: ``attach_auditor`` is one op carrying the
  ``AuditConfig``, and every rank of the submesh builds its own
  ``ShadowAuditor`` (the audit lanes run the engine's collectives, and
  sampling is a stride over completions, so the ranks audit alike);
  ``audit_tick`` is an op while the last result says an audit is
  pending. The proxy's ``auditor`` is an ``AuditorView`` of the
  leader's stats; a divergence the leader found travels in the result,
  and rank 0 dumps its ``FlightRecorder`` as the auditor would;
* spans: a leader other than rank 0 records into a tracer of its own
  (the ``set_tracer`` op) and each result carries what it recorded
  since the last one (``obs.trace.TraceCursor``); the proxy re-records
  it on the engine's track of rank 0's tracer, moved onto rank 0's
  clock by the offset it measured at its first query;
* the block profiler lives on each rank's engine (``torch.profiler`` is
  per process); the ``stop`` op closes a window still open.

Disaggregated pools: ``take_handoffs`` is an op whose result carries,
for each primed request, its cached chunk chain as each model
coordinate of the prefill mesh holds it (gathered to the leader over
the control group); ``adopt_handoff`` carries them to the decode
engine's ranks, each of which inserts its coordinate's chain into its
own store before adopting the request (``handoff_bytes`` counts them).
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.log import get_logger
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.stream import StreamRouter
from repro_torch.serving.types import Completion

log = get_logger(__name__)

# ops that change an engine (replayed by every rank of its submesh)
OPS = ("submit", "cancel", "preempt", "step", "audit_tick", "prewarm",
       "steal_waiting", "steal_paused", "adopt_paused", "return_waiting",
       "return_paused", "take_handoffs", "adopt_handoff", "attach_auditor",
       "set_tracer", "stop")
# ops the Replica runs itself around the engine (``Replica._<name>``)
_OWN = ("take_handoffs", "adopt_handoff", "attach_auditor", "set_tracer",
        "stop")
# ops in which every member of the control group sends its part to the
# leader (rank 0 outside the submesh sends nothing)
GATHERED = ("take_handoffs",)
# read-only queries: answered by the leader, replayed by no rank
QUERIES = ("state", "expected_prefix_hit")
CONTROL_TIMEOUT = datetime.timedelta(days=365)
# the router's prefix probe waits this long for an engine busy with an
# op, then counts no hit (affinity is a heuristic; the asyncio thread
# never waits out a block)
PROBE_WAIT_S = 0.05

_SCALARS = tuple(f.name for f in dataclasses.fields(ServeMetrics)
                 if f.name not in ("requests", "_lock")
                 and not f.name.startswith("hist_"))


class ReplicaDivergence(RuntimeError):
    """A rank's op gave other than its leader's result."""


class EngineBroken(RuntimeError):
    """An engine's control group failed: a rank of it is gone."""


class ControlGroup:
    """Rank 0 and an engine's submesh on one gloo group. ``ranks`` are
    global and sorted; ``leader`` is the submesh's first rank. A group of
    one rank (rank 0 serving alone) moves nothing."""

    def __init__(self, ranks, leader: int, group=None):
        import torch.distributed as dist
        self.ranks = tuple(ranks)
        self.leader = leader
        self.group = group
        self.rank = dist.get_rank() if dist.is_initialized() else 0

    def __repr__(self):
        return f"ControlGroup(ranks={self.ranks}, leader={self.leader})"

    def share(self, obj, src: int):
        """``obj`` of rank ``src`` on every rank of the group."""
        if self.group is None:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def gather(self, obj, dst: int):
        """Every rank's ``obj`` in rank order on ``dst``; None elsewhere."""
        if self.group is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * len(self.ranks) if self.rank == dst else None
        dist.gather_object(obj, out, dst=dst, group=self.group)
        return out


def make_control_groups(meshes) -> List[Optional[ControlGroup]]:
    """One ``ControlGroup`` an engine's mesh, over rank 0 and the mesh's
    ranks (every rank of the world calls this, in the same order); None
    where this rank is in neither."""
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = []
    for mesh in meshes:
        members = sorted({0} | {int(r) for r in mesh.devices.flat})
        group = None
        if len(members) > 1:
            group = dist.new_group(members, backend="gloo",
                                   timeout=CONTROL_TIMEOUT)
        leader = int(mesh.devices.min())
        out.append(ControlGroup(members, leader, group)
                   if rank in members else None)
    return out


# ------------------------------------------------------------ results

def _tokens_crc(tokens) -> int:
    return zlib.crc32(np.ascontiguousarray(tokens, np.int32).tobytes())


def op_key(name: str, out, err):
    """What a follower checks against its leader for one op."""
    if err is not None:
        return ("raised", type(err).__name__, str(err))
    if name == "step":
        return tuple((c.uid, c.n_tokens, c.cancelled, _tokens_crc(c.tokens))
                     for c in out)
    if name == "cancel":
        return None if out is None else (out.uid, out.n_tokens)
    if name == "steal_waiting":
        return None if out is None else out.uid
    if name == "steal_paused":
        return None if out is None else out[0].uid
    if name == "prewarm":
        return out["graphs"]
    if name == "take_handoffs":
        return tuple(r.uid for r in out)
    if name in ("submit", "adopt_paused", "adopt_handoff", "audit_tick"):
        return out
    return None


class _Deltas:
    """The leader's side of the metrics mirror. Rank 0's loop adds to
    the integer counters of its mirror too, so those travel as what
    changed on the leader's engine since the last op's result; the
    float fields, the histograms and ``stats`` are the engine's alone
    and travel whole when they changed."""

    def __init__(self, engine):
        self.engine = engine
        self.ints = {n: 0 for n in _SCALARS}
        self.floats: Dict[str, float] = {}
        self.n_requests = 0
        self.hist: Dict[str, tuple] = {}
        self.stats: Dict[str, float] = {}

    def take(self) -> dict:
        m = self.engine.metrics
        add, put = {}, {}
        for n in _SCALARS:
            v = getattr(m, n)
            if isinstance(v, float):
                if v != self.floats.get(n):
                    put[n] = self.floats[n] = v
            elif v != self.ints[n]:
                add[n] = v - self.ints[n]
                self.ints[n] = v
        with m._lock:
            reqs = m.requests[self.n_requests:]
        self.n_requests += len(reqs)
        hist = {}
        for h in m.histograms:
            snap = h.snapshot()
            if snap != self.hist.get(h.name):
                hist[h.name] = self.hist[h.name] = snap
        stats = {k: v for k, v in self.engine.stats.items()
                 if v != self.stats.get(k)}
        self.stats.update(stats)
        return {"add": add, "put": put, "requests": reqs, "hist": hist,
                "stats": stats}


def apply_deltas(metrics: ServeMetrics, stats, patch: dict) -> None:
    """Bring rank 0's mirror up to a leader's ``_Deltas.take``."""
    with metrics._lock:
        for n, d in patch["add"].items():
            setattr(metrics, n, getattr(metrics, n) + d)
        for n, v in patch["put"].items():
            setattr(metrics, n, v)
        metrics.requests.extend(patch["requests"])
    for h in metrics.histograms:
        snap = patch["hist"].get(h.name)
        if snap is not None:
            with h._lock:
                h._counts, h._sum, h._n = list(snap[0]), snap[1], snap[2]
    stats.update(patch["stats"])


class Replica:
    """Executes an engine's ops on this rank's ``ContinuousEngine``; on
    the leader, also builds each op's result (``run``). ``history``
    keeps the last ops taken, as ``(seq, name)``."""

    def __init__(self, engine):
        self.engine = engine
        self._chunks: list = []
        engine.on_chunk(None, self._chunks.append)
        self._deltas = _Deltas(engine)
        self.history = collections.deque(maxlen=1024)
        self._cursor = None          # this rank's own tracer's (set_tracer)
        self._audit_mark = None      # the newest audit result sent

    def execute(self, op, ctl: Optional[ControlGroup] = None):
        """Run one op here: ``(out, err, chunks)``. ``ctl``: the engine's
        control group (the ops that gather or know the leader use it)."""
        seq, name, args = op
        if name not in OPS and name not in QUERIES:
            raise ReplicaDivergence(f"op {seq}: no op {name!r}")
        self.history.append((seq, name))
        eng = self.engine
        try:
            if name == "state":
                out = None
            elif name in _OWN:
                out = getattr(self, "_" + name)(ctl, *args)
            else:
                out = getattr(eng, name)(*args)
            err = None
        except Exception as e:          # re-raised on rank 0 (as the
            out, err = None, e          # engine's own call would raise)
        chunks = list(self._chunks)
        self._chunks.clear()
        return out, err, chunks

    def run(self, op, ctl: Optional[ControlGroup] = None) -> dict:
        """Execute ``op`` and build the result the leader broadcasts."""
        out, err, chunks = self.execute(op, ctl)
        return {"out": out, "err": err, "key": op_key(op[1], out, err),
                "chunks": chunks, "state": self.state()}

    # ------------------------------------------------------ own ops

    def _coords(self):
        """(model index, whether this rank is the first of its data
        line) on the engine's mesh."""
        ex = self.engine.scheduler.executor
        if ex is None:
            return 0, True
        return ex.mesh.coords.get("model", 0), ex.data.index == 0

    def _take_handoffs(self, ctl):
        # every rank of a data line holds the same rows (a prefill
        # publishes the gathered gang), so the first of each line sends
        # its model shard of each request's chain
        reqs = self.engine.take_handoffs()
        m, first = self._coords()
        store = self.engine.prefix_cache
        mine = ((m, [store.chain_kv(r.prompt_tokens) for r in reqs])
                if first and store is not None else None)
        parts = ctl.gather(mine, ctl.leader) if ctl is not None else [mine]
        if parts is not None:           # the leader: one chain a model
            by_m = dict(p for p in parts if p is not None)   # coordinate
            for i, r in enumerate(reqs):
                r.handoff_kv = [by_m[k][i] for k in sorted(by_m)] \
                    if by_m else None
        return reqs

    def _adopt_handoff(self, ctl, req, wait_s, kv):
        eng = self.engine
        if kv:
            from repro_torch.cache.slicing import slice_nbytes
            m, _ = self._coords()
            if eng.prefix_cache is not None and kv[m]:
                eng.prefix_cache.insert(req.prompt_tokens, 0, kv[m])
            eng.metrics.handoff_bytes += slice_nbytes(kv)
        return eng.adopt_handoff(req, wait_s)

    def _attach_auditor(self, ctl, config):
        from repro_torch.obs.audit import ShadowAuditor
        self.engine.attach_auditor(ShadowAuditor(self.engine, config))

    def _set_tracer(self, ctl, label: str):
        # rank 0 records its own engine's spans; a leader elsewhere
        # records into a tracer of its own, which each result drains
        if ctl is not None and ctl.rank == ctl.leader != 0:
            from repro_torch.obs.trace import TraceCursor, Tracer
            tracer = Tracer()
            self.engine.set_tracer(tracer, label)
            self._cursor = TraceCursor(tracer)

    def _stop(self, ctl):
        if self.engine.profiler is not None:
            self.engine.profiler.close()

    # ------------------------------------------------------ the result

    def _new_audits(self) -> list:
        """The audit results since the last call, oldest first."""
        a = self.engine.auditor
        if a is None:
            return []
        new = []
        for r in reversed(a.results):
            if r is self._audit_mark:
                break
            new.append(r)
        if new:
            self._audit_mark = new[0]
        return new[::-1]

    def state(self) -> dict:
        eng = self.engine
        sched = eng.scheduler
        trace = None
        if self._cursor is not None:
            trace = {"t0": self._cursor.tracer.t0_ns,
                     "events": self._cursor.take()}
        return {"idle": sched.idle,
                "waiting": [r.uid for r in sched.waiting],
                "paused": [item[0].uid for item in sched.paused],
                "max_slots": sched.max_slots,
                "max_waiting": sched.max_waiting,
                "slots_used": sched.slots_used,
                "live_rows": sched.live_rows,
                "audit_pending": eng.audit_pending,
                "handoff_ready": len(sched.handoff_ready),
                "graphs": eng.graph_cache_size(),
                "debug": sched.debug_state(),
                "telemetry": eng.telemetry.totals(),
                "audit": (eng.auditor.stats() if eng.auditor is not None
                          else None),
                "audits": self._new_audits(),
                "trace": trace,
                "clock": time.perf_counter_ns(),
                "deltas": self._deltas.take()}


def follow(replica: Replica, ctl: ControlGroup) -> int:
    """Replay rank 0's ops on this rank's engine until ``stop``; returns
    how many ops came. Raises ``ReplicaDivergence`` when an op's result
    here differs from the leader's, or an op comes out of order."""
    n = 0
    leader = ctl.rank == ctl.leader
    while True:
        op = ctl.share(None, src=0)
        seq, name, _ = op
        if seq != n + 1:
            raise ReplicaDivergence(f"rank {ctl.rank}: op {seq} ({name}) "
                                    f"after op {n}")
        n = seq
        if leader:
            ctl.share(replica.run(op, ctl), src=ctl.leader)
        elif name in QUERIES:
            ctl.share(None, src=ctl.leader)
        else:
            out, err, _ = replica.execute(op, ctl)
            mine = op_key(name, out, err)
            theirs = ctl.share(None, src=ctl.leader)["key"]
            if mine != theirs:
                raise ReplicaDivergence(
                    f"rank {ctl.rank}: op {seq} ({name}) gave {mine!r}, "
                    f"its leader rank {ctl.leader} {theirs!r}")
        if name == "stop":
            return n


# ------------------------------------------------------------ rank 0

class SchedulerView:
    """The scheduler state rank 0 reads, as of the engine's last op."""

    def __init__(self):
        self.idle = True
        self.waiting: list = []          # uids
        self.paused: list = []           # uids
        self.max_slots = 0
        self.max_waiting = None
        self.slots_used = 0
        self.live_rows = 0
        self._debug: dict = {}
        self._graphs = 0

    def debug_state(self) -> dict:
        return dict(self._debug)

    def graph_cache_size(self) -> int:
        return self._graphs


class TelemetryView:
    """The decode telemetry's rollup, as of the engine's last op."""

    def __init__(self):
        self._totals: dict = {}

    def totals(self) -> dict:
        return dict(self._totals)


class AuditorView:
    """The engine's ``ShadowAuditor`` as of its last op: the leader's
    ``stats()`` and ``pending``, its results since the proxy attached
    it (``results``), and rank 0's ``FlightRecorder`` (``flight``)."""

    def __init__(self, config, flight=None):
        self.config = config
        self.flight = flight
        self.pending = False
        self.results: collections.deque = collections.deque(
            maxlen=config.max_results)
        self._stats: dict = {}

    def stats(self) -> dict:
        return dict(self._stats)


class RemoteStore:
    """Stands for a prefix store that lives on the engine's ranks: the
    router reads its chunk size and probes ``match_len``, which asks the
    engine (``EngineProxy.expected_prefix_hit``)."""

    def __init__(self, chunk_tokens: int, probe: Callable):
        self.chunk_tokens = chunk_tokens
        self.match_len = probe


def clock_offset(t_send: int, t_remote: int, t_recv: int) -> int:
    """Another process's ``perf_counter_ns`` less this one's, from one
    round trip (sent at ``t_send``, answered at ``t_remote``, back at
    ``t_recv``): 0 when the answer lies inside the round trip, as on one
    host, whose processes share the monotonic clock; else the midpoint
    estimate."""
    if t_send <= t_remote <= t_recv:
        return 0
    return t_remote - (t_send + t_recv) // 2


@dataclasses.dataclass
class _Waiting:
    uid: int


class EngineProxy:
    """Rank 0's stand-in for an engine placed on a submesh: the
    ``ContinuousEngine`` surface that ``EngineLoop``, ``EngineRouter``
    and ``HttpFrontend`` use, each call that changes the engine one op
    on ``ctl`` (see the module docstring). ``replica``: this process's
    own ``Replica`` when rank 0 is the submesh's leader (engine 0), else
    None. ``prefill_only``: the engine's pool role. ``ops`` counts the
    ops sent, by name, and ``op_s`` their wall seconds."""

    def __init__(self, ctl: ControlGroup, *, cfg, dcfg, tokenizer,
                 replica: Optional[Replica] = None,
                 prefix_cache: Optional[int] = None, host_budget=None,
                 prefill_only: bool = False):
        self.ctl = ctl
        self.replica = replica
        self.cfg = cfg
        self.dcfg = dcfg
        self.tok = tokenizer
        self.prefill_only = prefill_only
        self.host_budget = host_budget
        self.prefix_cache = (RemoteStore(prefix_cache,
                                         self.expected_prefix_hit)
                             if prefix_cache else None)
        self.metrics = ServeMetrics()
        self.stats = collections.defaultdict(float)
        self.scheduler = SchedulerView()
        self.telemetry = TelemetryView()
        self.router = StreamRouter()
        self.auditor: Optional[AuditorView] = None
        self.tracer = None
        self.obs_pid = 0
        self.cuda_stream = None
        self.ops: Dict[str, int] = collections.Counter()
        self.op_s: Dict[str, float] = collections.defaultdict(float)
        self.broken: Optional[BaseException] = None
        self.on_break: Optional[Callable] = None
        # the leader's clock less rank 0's (``clock_offset``), measured
        # at the first query
        self.clock_offset_ns: Optional[int] = None
        self._audit_pending = False
        self._handoff_ready = 0
        self._tids: set = set()
        self._lock = threading.Lock()
        self._seq = 0
        self._call("state")

    def __repr__(self):
        return f"EngineProxy({self.ctl})"

    @property
    def profiler(self):
        """Engine 0's block profiler on rank 0 (the loop closes it at
        drain); the other ranks' close at ``stop``."""
        return (self.replica.engine.profiler if self.replica is not None
                else None)

    # ------------------------------------------------------ the op log

    def _call(self, name: str, *args, wait: Optional[float] = None):
        if not self._lock.acquire(timeout=-1 if wait is None else wait):
            return None
        try:
            if self.broken is not None:
                raise EngineBroken(f"{self.ctl}: {self.broken}")
            self._seq += 1
            op = (self._seq, name, args)
            t_send = time.perf_counter_ns()
            try:
                self.ctl.share(op, src=0)
                if self.replica is not None:
                    res = self.ctl.share(self.replica.run(op, self.ctl),
                                         src=self.ctl.leader)
                else:
                    if name in GATHERED:
                        self.ctl.gather(None, self.ctl.leader)
                    res = self.ctl.share(None, src=self.ctl.leader)
            except Exception as e:
                self._break(e)
                raise EngineBroken(f"{self.ctl}: {e}") from e
            t_recv = time.perf_counter_ns()
            self.ops[name] += 1
            self.op_s[name] += (t_recv - t_send) / 1e9
            if self.clock_offset_ns is None:
                self.clock_offset_ns = clock_offset(
                    t_send, res["state"]["clock"], t_recv)
            dumps = self._apply(res["state"])
        finally:
            self._lock.release()
        self.router.publish(res["chunks"])
        for reason in dumps:
            self.auditor.flight.dump(reason)
        if res["err"] is not None:
            raise res["err"]
        return res["out"]

    def _apply(self, st: dict) -> list:
        """Take the leader's snapshot; returns the flight dumps its new
        audit divergences call for."""
        s = self.scheduler
        s.waiting, s.paused = st["waiting"], st["paused"]
        s.max_slots, s.max_waiting = st["max_slots"], st["max_waiting"]
        s.slots_used, s.live_rows = st["slots_used"], st["live_rows"]
        s._debug, s._graphs = st["debug"], st["graphs"]
        s.idle = st["idle"]
        self._audit_pending = st["audit_pending"]
        self._handoff_ready = st["handoff_ready"]
        self.telemetry._totals = st["telemetry"]
        apply_deltas(self.metrics, self.stats, st["deltas"])
        if st["trace"] is not None and self.tracer is not None:
            self._ingest(st["trace"])
        dumps = []
        a = self.auditor
        if a is not None and st["audit"] is not None:
            a._stats, a.pending = st["audit"], st["audit_pending"]
            for r in st["audits"]:
                a.results.append(r)
                # what the auditor does in one process (the
                # audit_divergence instant came with the spans)
                if not r.matched and r.source != "dkv-structural" \
                        and a.flight is not None:
                    dumps.append(f"audit-{r.source}")
        return dumps

    def _ingest(self, trace: dict) -> None:
        """Re-record the leader's spans on this engine's track."""
        events = trace["events"]
        for tid in {e["tid"] for e in events} - self._tids:
            self._tids.add(tid)
            self.tracer.name_thread(f"rank {self.ctl.leader}",
                                    pid=self.obs_pid, tid=tid)
        shift_us = (trace["t0"] - self.clock_offset_ns
                    - self.tracer.t0_ns) / 1e3
        self.tracer.ingest(events, self.obs_pid, shift_us)

    def _break(self, err: BaseException) -> None:
        log.error("engine control group %s failed: %s", self.ctl, err)
        self.broken = err
        self.scheduler.idle = True
        self.scheduler.live_rows = self.scheduler.slots_used = 0
        self.scheduler.paused = []
        self._audit_pending = False
        self._handoff_ready = 0
        if self.on_break is not None:
            self.on_break(self)

    # ------------------------------------------------------ engine API

    def submit(self, prompt, max_tokens: int = 64, trace_id: str = "") -> int:
        toks = self.tok.encode(prompt) if isinstance(prompt, str) \
            else np.asarray(prompt, np.int32)
        return self._call("submit", toks, max_tokens, trace_id)

    def cancel(self, uid: int) -> Optional[Completion]:
        if self.broken is not None:
            # the row died with its ranks: conclude it here
            self.metrics.cancelled += 1
            return Completion(uid=uid, text="", tokens=np.zeros(0, np.int32),
                              latency_s=0.0, nfe=0, cancelled=True)
        return self._call("cancel", uid)

    def preempt(self, uid: int) -> None:
        self._call("preempt", uid)

    def step(self) -> List[Completion]:
        return self._call("step")

    def attach_auditor(self, auditor) -> None:
        """Every rank of the engine builds its own ``ShadowAuditor`` of
        ``auditor``'s config; rank 0 keeps an ``AuditorView`` of the
        leader's, with ``auditor``'s flight recorder."""
        self.auditor = AuditorView(auditor.config, flight=auditor.flight)
        self._call("attach_auditor", auditor.config)

    def audit_tick(self) -> bool:
        # the auditor's own gate (ShadowAuditor.tick), read from the
        # snapshot: no op while nothing is pending or traffic owns the
        # engine, so an idle loop sends none
        s = self.scheduler
        if not self._audit_pending or s.waiting \
                or s.slots_used >= s.max_slots:
            return False
        try:
            return bool(self._call("audit_tick"))
        except EngineBroken:
            return False            # the loop's next step reports it

    @property
    def audit_pending(self) -> bool:
        return self._audit_pending

    def prewarm(self, buckets, batch_sizes=None) -> dict:
        return self._call("prewarm", [tuple(b) for b in buckets],
                          batch_sizes)

    def steal_waiting(self):
        if self.broken is not None:
            # requests that never reached a row re-route from rank 0
            if self.scheduler.waiting:
                return _Waiting(self.scheduler.waiting.pop())
            return None
        return self._call("steal_waiting")

    def steal_paused(self):
        if self.broken is not None:
            return None             # a parked row's state died with it
        return self._call("steal_paused")

    def adopt_paused(self, req, state) -> int:
        return self._call("adopt_paused", req, state)

    def return_waiting(self, req) -> None:
        self._call("return_waiting", req)

    def return_paused(self, req, state) -> None:
        self._call("return_paused", req, state)

    def take_handoffs(self) -> list:
        """The rows the last step primed, each with its chunk KV
        (``handoff_kv``); no op while the snapshot shows none."""
        if self.broken is not None or not self._handoff_ready:
            return []               # (a broken engine's KV died with it)
        return self._call("take_handoffs")

    def adopt_handoff(self, req, wait_s: Optional[float] = None) -> int:
        kv, req.handoff_kv = req.handoff_kv, None
        return self._call("adopt_handoff", req, wait_s, kv)

    def expected_prefix_hit(self, prompt) -> int:
        if self.prefix_cache is None or self.broken is not None:
            return 0
        toks = self.tok.encode(prompt) if isinstance(prompt, str) \
            else np.asarray(prompt, np.int32)
        return self._call("expected_prefix_hit", toks,
                          wait=PROBE_WAIT_S) or 0

    def stop(self) -> None:
        """Tell every rank of the engine to leave ``follow``."""
        if self.broken is None:
            self._call("stop")

    # ------------------------------------------------------ the rest

    def on_chunk(self, uid: Optional[int], fn) -> None:
        self.router.subscribe(uid, fn)

    def set_tracer(self, tracer, label: str) -> None:
        """Rank 0's tracer: engine 0's own spans when rank 0 decodes it;
        an engine led from another rank records into the leader's tracer
        (the ``set_tracer`` op), re-recorded here as results come."""
        self.tracer = tracer
        if self.replica is not None:
            self.replica.engine.set_tracer(tracer, label)
            self.obs_pid = self.replica.engine.obs_pid
        else:
            self.obs_pid = tracer.process(label)
            self._call("set_tracer", label)

    def graph_cache_size(self) -> int:
        return self.scheduler.graph_cache_size()

    @property
    def throughput(self) -> float:
        return self.stats["tokens"] / max(self.stats["time_s"], 1e-9)
