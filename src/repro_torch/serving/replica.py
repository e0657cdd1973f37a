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
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import threading
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
       "return_paused", "stop")
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
    if name in ("submit", "adopt_paused", "audit_tick"):
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

    def execute(self, op):
        """Run one op here: ``(out, err, chunks)``."""
        seq, name, args = op
        if name not in OPS and name not in QUERIES:
            raise ReplicaDivergence(f"op {seq}: no op {name!r}")
        self.history.append((seq, name))
        eng = self.engine
        try:
            out = None if name in ("state", "stop") \
                else getattr(eng, name)(*args)
            err = None
        except Exception as e:          # re-raised on rank 0 (as the
            out, err = None, e          # engine's own call would raise)
        chunks = list(self._chunks)
        self._chunks.clear()
        return out, err, chunks

    def run(self, op) -> dict:
        """Execute ``op`` and build the result the leader broadcasts."""
        out, err, chunks = self.execute(op)
        return {"out": out, "err": err, "key": op_key(op[1], out, err),
                "chunks": chunks, "state": self.state()}

    def state(self) -> dict:
        eng = self.engine
        sched = eng.scheduler
        return {"idle": sched.idle,
                "waiting": [r.uid for r in sched.waiting],
                "paused": [item[0].uid for item in sched.paused],
                "max_slots": sched.max_slots,
                "max_waiting": sched.max_waiting,
                "slots_used": sched.slots_used,
                "live_rows": sched.live_rows,
                "audit_pending": eng.audit_pending,
                "graphs": eng.graph_cache_size(),
                "debug": sched.debug_state(),
                "telemetry": eng.telemetry.totals(),
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
            ctl.share(replica.run(op), src=ctl.leader)
        elif name in QUERIES:
            ctl.share(None, src=ctl.leader)
        else:
            out, err, _ = replica.execute(op)
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


@dataclasses.dataclass
class RemoteStore:
    """Stands for a prefix store that lives on the engine's ranks (the
    router reads only whether there is one)."""
    chunk_tokens: int


@dataclasses.dataclass
class _Waiting:
    uid: int


class EngineProxy:
    """Rank 0's stand-in for an engine placed on a submesh: the
    ``ContinuousEngine`` surface that ``EngineLoop``, ``EngineRouter``
    and ``HttpFrontend`` use, each call that changes the engine one op
    on ``ctl`` (see the module docstring). ``replica``: this process's
    own ``Replica`` when rank 0 is the submesh's leader (engine 0), else
    None. ``ops`` counts the ops sent, by name."""

    def __init__(self, ctl: ControlGroup, *, cfg, dcfg, tokenizer,
                 replica: Optional[Replica] = None,
                 prefix_cache: Optional[int] = None, host_budget=None):
        self.ctl = ctl
        self.replica = replica
        self.cfg = cfg
        self.dcfg = dcfg
        self.tok = tokenizer
        self.prefill_only = False
        self.host_budget = host_budget
        self.prefix_cache = (RemoteStore(prefix_cache)
                             if prefix_cache else None)
        self.metrics = ServeMetrics()
        self.stats = collections.defaultdict(float)
        self.scheduler = SchedulerView()
        self.telemetry = TelemetryView()
        self.router = StreamRouter()
        self.auditor = None
        self.profiler = None
        self.tracer = None
        self.obs_pid = 0
        self.cuda_stream = None
        self.ops: Dict[str, int] = collections.Counter()
        self.broken: Optional[BaseException] = None
        self.on_break: Optional[Callable] = None
        self._audit_pending = False
        self._lock = threading.Lock()
        self._seq = 0
        self._call("state")

    def __repr__(self):
        return f"EngineProxy({self.ctl})"

    # ------------------------------------------------------ the op log

    def _call(self, name: str, *args, wait: Optional[float] = None):
        if not self._lock.acquire(timeout=-1 if wait is None else wait):
            return None
        try:
            if self.broken is not None:
                raise EngineBroken(f"{self.ctl}: {self.broken}")
            self._seq += 1
            op = (self._seq, name, args)
            try:
                self.ctl.share(op, src=0)
                if self.replica is not None:
                    res = self.ctl.share(self.replica.run(op),
                                         src=self.ctl.leader)
                else:
                    res = self.ctl.share(None, src=self.ctl.leader)
            except Exception as e:
                self._break(e)
                raise EngineBroken(f"{self.ctl}: {e}") from e
            self.ops[name] += 1
            self._apply(res["state"])
        finally:
            self._lock.release()
        self.router.publish(res["chunks"])
        if res["err"] is not None:
            raise res["err"]
        return res["out"]

    def _apply(self, st: dict) -> None:
        s = self.scheduler
        s.waiting, s.paused = st["waiting"], st["paused"]
        s.max_slots, s.max_waiting = st["max_slots"], st["max_waiting"]
        s.slots_used, s.live_rows = st["slots_used"], st["live_rows"]
        s._debug, s._graphs = st["debug"], st["graphs"]
        s.idle = st["idle"]
        self._audit_pending = st["audit_pending"]
        self.telemetry._totals = st["telemetry"]
        apply_deltas(self.metrics, self.stats, st["deltas"])

    def _break(self, err: BaseException) -> None:
        log.error("engine control group %s failed: %s", self.ctl, err)
        self.broken = err
        self.scheduler.idle = True
        self.scheduler.live_rows = self.scheduler.slots_used = 0
        self.scheduler.paused = []
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

    def audit_tick(self) -> bool:
        # an engine on a mesh carries no auditor (ROADMAP A11.2): the
        # op would be a no-op on every rank, so none is sent
        return False

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
        return []                   # no prefill pool on a mesh (A11.2)

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
        """Rank 0's tracer: engine 0's own spans when rank 0 decodes it
        (the engines on other ranks record none: ROADMAP A11.2)."""
        self.tracer = tracer
        if self.replica is not None:
            self.replica.engine.set_tracer(tracer, label)
            self.obs_pid = self.replica.engine.obs_pid
        else:
            self.obs_pid = tracer.process(label)

    def graph_cache_size(self) -> int:
        return self.scheduler.graph_cache_size()

    @property
    def throughput(self) -> float:
        return self.stats["tokens"] / max(self.stats["time_s"], 1e-9)
