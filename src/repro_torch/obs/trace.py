"""Request span trees and per-thread timelines (a copy of
``repro.obs.trace``, which is stdlib-only), exported as Chrome-trace
JSON (the Trace Event Format Perfetto and ``chrome://tracing`` load
natively).

Design:

* **ring buffer per thread** — each thread that emits events gets its
  own bounded ``deque``; the hot path is one ``dict`` construction and
  one ``deque.append`` with no lock taken (the registry of rings is
  the only locked structure, touched once per thread). A full ring
  drops its *oldest* events — a long-running server keeps the recent
  window rather than dying or blocking the decode thread.
* **monotonic clocks** — timestamps are ``time.perf_counter_ns``
  deltas from the tracer's birth, emitted in microseconds (the unit
  the trace-event spec mandates). Wall-clock anchors never appear, so
  spans are immune to NTP steps.
* **two track families** — synchronous work is recorded as complete
  (``ph:"X"``) events on the emitting thread's track (one track per
  engine decode thread / asyncio thread), while each request gets an
  *async* track (``ph:"b"``/``"e"``, ``cat:"request"``, ``id`` = trace
  id) whose nested spans form the request's lifecycle tree: accept →
  queue → decode → block k → finalize. Both families can carry
  explicit timestamps, so a span whose bounds are only known after the
  fact (a decoded block, a queue wait) is emitted *once*, complete —
  no dangling ``b`` if the process stops mid-request.

``span(tracer, name, ...)`` is the call-site helper: with
``tracer=None`` (observability off) it returns a shared no-op context
manager, so instrumented code pays one ``is None`` test.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_NULL_CTX = contextlib.nullcontext()


def span(tracer: Optional["Tracer"], name: str, **args):
    """Thread-track span helper for maybe-absent tracers."""
    return _NULL_CTX if tracer is None else tracer.span(name, **args)


class _Span:
    """Context manager recording one complete ("X") event on exit."""
    __slots__ = ("tr", "name", "pid", "args", "t0")

    def __init__(self, tr: "Tracer", name: str, pid: int, args: dict):
        self.tr = tr
        self.name = name
        self.pid = pid
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.tr.complete(self.name, self.t0, t1, pid=self.pid,
                         **self.args)
        return False


class Tracer:
    """Process-wide event sink. All emit methods are callable from any
    thread; ``export``/``events`` snapshot every ring (reads race
    benignly with appends — an event is either in or out, never torn,
    since each event is one append of an immutable dict)."""

    def __init__(self, capacity_per_thread: int = 1 << 16):
        self.capacity = capacity_per_thread
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._rings: Dict[int, deque] = {}
        self._local = threading.local()
        # pid 0 is the front-end track group; engines claim 1..N via
        # ``process()``
        self._meta: List[dict] = [{"ph": "M", "name": "process_name",
                                   "pid": 0, "tid": 0,
                                   "args": {"name": "frontend"}}]
        self._pids = itertools.count(1)      # 0 = front end
        self._ids = itertools.count(1)
        self.dropped = 0                     # rings that hit capacity

    # ------------------------------------------------------ plumbing

    def _us(self, t_ns: int) -> float:
        return (t_ns - self._t0) / 1e3

    def _ring(self) -> deque:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = deque(maxlen=self.capacity)
            self._local.ring = ring
            with self._lock:
                self._rings[threading.get_ident()] = ring
        return ring

    def _emit(self, ev: dict) -> None:
        ring = self._ring()
        if len(ring) == ring.maxlen:
            self.dropped += 1
        ring.append(ev)

    # ------------------------------------------------------ identity

    def new_trace_id(self) -> str:
        """Process-unique request correlation id (hex, header-safe)."""
        return f"{os.getpid():x}-{next(self._ids):08x}"

    def process(self, label: str) -> int:
        """Allocate a pid (a top-level Perfetto track group) and name
        it — one per engine, plus pid 0 for the front end."""
        with self._lock:
            pid = next(self._pids)
            self._meta.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": label}})
        return pid

    def name_thread(self, label: str, pid: int = 0) -> None:
        with self._lock:
            self._meta.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": threading.get_ident(),
                               "args": {"name": label}})

    # ------------------------------------------------------ emission

    def span(self, name: str, pid: int = 0, **args) -> _Span:
        """Live thread-track span (bounds taken from enter/exit)."""
        return _Span(self, name, pid, args)

    def complete(self, name: str, t0_ns: int, t1_ns: int, pid: int = 0,
                 **args) -> None:
        """Thread-track span with explicit monotonic-ns bounds."""
        self._emit({"ph": "X", "name": name, "pid": pid,
                    "tid": threading.get_ident(),
                    "ts": self._us(t0_ns),
                    "dur": max((t1_ns - t0_ns) / 1e3, 0.001),
                    "args": args})

    def instant(self, name: str, pid: int = 0, **args) -> None:
        self._emit({"ph": "i", "name": name, "pid": pid,
                    "tid": threading.get_ident(), "s": "t",
                    "ts": self._us(time.perf_counter_ns()), "args": args})

    def async_begin(self, trace_id: str, name: str, pid: int = 0,
                    t_ns: Optional[int] = None, **args) -> None:
        """Open one span on the request's async track. Spans sharing a
        trace id nest by timestamp — emit begin/end in lifecycle order
        and Perfetto renders the tree."""
        self._emit({"ph": "b", "cat": "request", "id": trace_id,
                    "name": name, "pid": pid,
                    "tid": threading.get_ident(),
                    "ts": self._us(t_ns if t_ns is not None
                                   else time.perf_counter_ns()),
                    "args": args})

    def async_end(self, trace_id: str, name: str, pid: int = 0,
                  t_ns: Optional[int] = None, **args) -> None:
        self._emit({"ph": "e", "cat": "request", "id": trace_id,
                    "name": name, "pid": pid,
                    "tid": threading.get_ident(),
                    "ts": self._us(t_ns if t_ns is not None
                                   else time.perf_counter_ns()),
                    "args": args})

    def async_span(self, trace_id: str, name: str, t0_ns: int,
                   t1_ns: int, pid: int = 0, **args) -> None:
        """Complete async span with known bounds (e.g. one decoded
        block attributed to each live request after the fact)."""
        self.async_begin(trace_id, name, pid=pid, t_ns=t0_ns, **args)
        self.async_end(trace_id, name, pid=pid, t_ns=t1_ns)

    # ------------------------------------------------------ export

    def events(self) -> List[dict]:
        """Snapshot of every ring, time-ordered, metadata first."""
        with self._lock:
            rings = list(self._rings.values())
            meta = list(self._meta)
        evs: List[dict] = []
        for ring in rings:
            evs.extend(ring)          # deque iteration is GIL-atomic
        evs.sort(key=lambda e: e.get("ts", 0.0))
        return meta + evs

    def request_events(self, trace_id: str) -> List[dict]:
        """Async-track events for one request, time-ordered."""
        return [e for e in self.events() if e.get("id") == trace_id]

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write Chrome-trace JSON atomically (tmp + rename, so a
        reader or a crash mid-write never sees a torn file); returns
        the path written."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path


class TraceFlusher:
    """Periodic Chrome-trace export on a daemon thread, so a crashed or
    killed run keeps its trace up to the last flush instead of losing
    everything to an export that only ran at graceful shutdown. Each
    flush rewrites ``path`` atomically (``Tracer.export``); a failed
    flush is logged-and-dropped, never raised into the process."""

    def __init__(self, tracer: "Tracer", path: str,
                 interval_s: float = 30.0):
        self.tracer = tracer
        self.path = path
        self.interval_s = interval_s
        self.flushes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-trace-flush")

    def start(self) -> "TraceFlusher":
        self._thread.start()
        return self

    def _run(self) -> None:
        from repro_torch.obs.log import get_logger
        log = get_logger(__name__)
        while not self._stop.wait(self.interval_s):
            try:
                self.tracer.export(self.path)
                self.flushes += 1
            except Exception:
                log.exception("periodic trace flush failed")

    def stop(self, final_flush: bool = True) -> None:
        """Stop the thread; by default write one last (complete)
        export."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(max(self.interval_s, 1.0))
        if final_flush:
            self.tracer.export(self.path)
            self.flushes += 1


def request_tree(events: List[dict]):
    """Rebuild one request's span tree from its async b/e events:
    ``[(name, depth, ts, dur), ...]`` in open order. Raises
    ``ValueError`` on malformed nesting (an ``e`` without a matching
    open ``b``) and reports unclosed spans via depth bookkeeping —
    the well-formedness contract tests/test_obs.py asserts."""
    stack: List[dict] = []
    out = []
    open_idx: List[int] = []
    # at equal timestamps an "e" must sort before the next "b" (a span
    # closing exactly when its sibling opens); ties beyond that keep
    # emission order (sorted() is stable over the ring order)
    for e in sorted(events,
                    key=lambda e: (e["ts"], 0 if e.get("ph") == "e" else 1)):
        if e.get("ph") == "b":
            out.append([e["name"], len(stack), e["ts"], None])
            open_idx.append(len(out) - 1)
            stack.append(e)
        elif e.get("ph") == "e":
            if not stack or stack[-1]["name"] != e["name"]:
                raise ValueError(
                    f"unbalanced async span: end {e['name']!r}, open "
                    f"stack {[s['name'] for s in stack]}")
            b = stack.pop()
            idx = open_idx.pop()
            out[idx][3] = e["ts"] - b["ts"]
    if stack:
        raise ValueError(
            f"unclosed async spans: {[s['name'] for s in stack]}")
    return [tuple(r) for r in out]
