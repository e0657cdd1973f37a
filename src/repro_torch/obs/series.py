"""Fleet time-series recorder: counter deltas sampled on the decode
thread, queryable as windowed rate series (a copy of
``repro.obs.series``, which imports only the logger).

Everything the stack exposes today is point-in-time — ``/metrics`` is
a snapshot, the SLO watchdog latches breach *onset* — yet the paper's
confidence-aware decoding makes throughput inherently time-varying
(early exit swings tok/s with the prompt mix), and ROADMAP open item 1
needs the prefill/decode busy-seconds *ratio over time* to size
``--pool prefill:N,decode:M``. :class:`MetricsRecorder` closes that
gap:

* **sampling** — ``maybe_sample()`` is called once per ``EngineLoop``
  iteration on the decode thread (the single writer of every counter
  it reads); at most one sample per ``interval_s``. Each sample stores
  ``(t, dt, counter-deltas, gauge-values)`` — deltas *since the
  previous sample*, so ring eviction never corrupts reconstruction
  (a chained absolute-plus-delta encoding would break the moment the
  head sample is dropped).
* **bounded ring** — a ``deque`` sized by ``max_bytes``; a full ring
  drops its oldest sample and counts the drop, exactly the
  :class:`~repro_torch.obs.trace.Tracer` contract. The reader (the asyncio
  thread serving ``/debug/timeline``) snapshots the deque without a
  lock — each sample is one append of an immutable tuple, in or out,
  never torn.
* **rates at query time** — ``series(window_s, step_s)`` buckets the
  samples on a process-shared monotonic grid and derives rate series
  from the per-bucket delta sums: tok/s, rps, goodput,
  cache-hit-tok/s, steal/handoff rates, and the per-pool busy
  *fractions* (``prefill_busy_s`` / ``decode_busy_s`` deltas over
  wall time — the open-item-1 N:M sizing signal). Fleet fan-in
  (:func:`fleet_series`) sums the *raw* per-bucket deltas across
  engines before deriving, so fractions aggregate correctly (an
  average of per-engine rates would not).
* **optional JSONL persistence** — ``--metrics-log`` appends one JSON
  line per sample through a shared :class:`JsonlSink` (lock around the
  write + flush, so concurrent engines never interleave a line;
  ``close()`` at drain means a stopped fleet never leaves a
  half-written record).

Hot-path discipline (lint-enforced, like trace/audit): nothing here
may raise out of the serving path — a recorder failure is logged and
the sample dropped.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from repro_torch.obs.log import get_logger

log = get_logger(__name__)

# cumulative counters sampled each interval (deltas stored); order is
# the wire layout of every ring sample
COUNTERS = (
    "tokens",            # engine.stats (all completions)
    "good_tokens",       # ... from completions that were not cancelled
    "requests",
    "nfe",
    "cancelled",
    "admission_rejects",
    "deadline_misses",
    "steals_in",
    "steals_out",
    "handoffs_in",
    "handoffs_out",
    "cache_hit_tokens",
    "prefill_busy_s",
    "decode_busy_s",
    "busy_s",
    "wall_s",
    "compile_misses",
    "compile_seconds",
    "slo_breaches",
)

# absolute gauge values carried on each sample
GAUGES = ("queue_depth", "live_rows", "inflight", "cache_bytes",
          "audit_backlog")

# derived rate series: name -> (counter, per-second). Fractions divide
# a seconds-counter delta by the bucket's wall dt.
RATES = (
    ("tok_s", "tokens"),
    ("goodput_tok_s", "good_tokens"),
    ("rps", "requests"),
    ("nfe_s", "nfe"),
    ("cache_hit_tok_s", "cache_hit_tokens"),
    ("steal_s", "steals_in"),
    ("handoff_s", "handoffs_in"),
    ("prefill_busy_frac", "prefill_busy_s"),
    ("decode_busy_frac", "decode_busy_s"),
    ("busy_frac", "busy_s"),
)

# per-bucket event counts surfaced as console annotations
EVENTS = (
    ("steals", "steals_in"),
    ("handoffs", "handoffs_in"),
    ("compiles", "compile_misses"),
    ("slo_breaches", "slo_breaches"),
    ("rejects", "admission_rejects"),
)

# conservative per-sample footprint: two tuples of floats plus the
# wrapper tuple (used only to size the ring from max_bytes)
SAMPLE_BYTES = 8 * (len(COUNTERS) + len(GAUGES)) + 240


class JsonlSink:
    """Append-only JSON-lines file shared by every engine's recorder.
    One lock per line write (cold path — once per engine per sampling
    interval), flushed immediately so a crash loses at most the line
    being written, never leaves a torn earlier one. Reference-counted:
    the file closes when the last recorder detaches at drain."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._refs = 0
        self._f = None
        self.lines = 0

    def acquire(self) -> "JsonlSink":
        with self._lock:
            if self._f is None:
                import os
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "a")
            self._refs += 1
        return self

    def write(self, doc: dict) -> None:
        try:
            line = json.dumps(doc) + "\n"
            with self._lock:
                if self._f is None:
                    return
                self._f.write(line)
                self._f.flush()
                self.lines += 1
        except Exception:
            log.exception("metrics-log write failed (dropped)")

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            if self._refs <= 0 and self._f is not None:
                try:
                    self._f.close()
                except Exception:
                    log.exception("metrics-log close failed")
                self._f = None


class MetricsRecorder:
    """Per-engine background sampler (see module docstring). Owned by
    one ``EngineLoop``; ``maybe_sample``/``close`` run on its decode
    thread, ``series``/``last_rates`` on any reader thread."""

    def __init__(self, engine, *, index: int = 0, role: str = "both",
                 interval_s: float = 0.5, max_bytes: int = 256 << 10,
                 sink: Optional[JsonlSink] = None, watchdog=None,
                 loop=None):
        self.engine = engine
        self.loop = loop                 # owning EngineLoop (inflight gauge)
        self.index = index
        self.role = role
        self.interval_s = max(interval_s, 1e-3)
        self.max_bytes = max_bytes
        self.watchdog = watchdog
        self.sink = sink.acquire() if sink is not None else None
        maxlen = max(16, int(max_bytes // SAMPLE_BYTES))
        self.ring: deque = deque(maxlen=maxlen)
        self.samples = 0
        self.dropped = 0                 # ring evictions
        self.errors = 0                  # failed samples (logged)
        self._closed = False
        self._t0 = time.monotonic()
        self._last_t = self._t0
        self._prev = self._cumulative()

    # ------------------------------------------------------ sampling

    def _cumulative(self):
        """Read every counter's current cumulative value. All reads are
        single ``int``/``float`` attribute loads (GIL-atomic); the
        decode thread is the writer of each, so from ``maybe_sample``
        they are exact, and from ``__init__`` at worst one tick stale."""
        eng = self.engine
        m = eng.metrics
        stats = eng.stats
        breaches = 0
        if self.watchdog is not None:
            try:
                breaches = sum(self.watchdog.breaches.values())
            except Exception:
                pass                     # SLO annotation is best-effort
        return (
            stats.get("tokens", 0),
            stats.get("good_tokens", 0),
            stats.get("requests", 0),
            m.total_nfe,
            m.cancelled,
            m.admission_rejects,
            m.deadline_misses,
            m.steals_in,
            m.steals_out,
            m.handoffs_in,
            m.handoffs_out,
            m.prefix_cache_hit_tokens,
            m.prefill_busy_s,
            m.decode_busy_s,
            m.busy_time_s,
            m.wall_time_s,
            m.compile_misses,
            m.compile_seconds,
            breaches,
        )

    def _gauges(self):
        eng = self.engine
        m = eng.metrics
        try:
            live = eng.scheduler.live_rows
        except Exception:
            live = 0
        # loop._inflight read without its lock: a single GIL-atomic int
        # load, and a gauge may be one tick stale by contract
        inflight = self.loop._inflight if self.loop is not None else 0
        return (m.queue_depth, live, inflight,
                m.prefix_cache_bytes, m.audit_backlog)

    def maybe_sample(self, now: Optional[float] = None) -> bool:
        """Decode-thread cadence hook: one cheap clock read per loop
        iteration, a real sample at most once per ``interval_s``."""
        if self._closed:
            return False
        t = time.monotonic() if now is None else now
        if t - self._last_t < self.interval_s:
            return False
        return self.sample(t)

    def sample(self, now: Optional[float] = None) -> bool:
        """Take one sample unconditionally. Never raises."""
        try:
            t = time.monotonic() if now is None else now
            dt = t - self._last_t
            if dt <= 0:
                return False
            cum = self._cumulative()
            deltas = tuple(c - p for c, p in zip(cum, self._prev))
            gauges = self._gauges()
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append((t, dt, deltas, gauges))
            self._prev = cum
            self._last_t = t
            self.samples += 1
            if self.sink is not None:
                self.sink.write({
                    "engine": self.index, "role": self.role,
                    "t": round(t - self._t0, 4), "dt": round(dt, 4),
                    "d": dict(zip(COUNTERS, deltas)),
                    "g": dict(zip(GAUGES, gauges)),
                })
            return True
        except Exception:
            self.errors += 1
            log.exception("metrics sample failed (dropped)")
            return False

    def close(self) -> None:
        """Drain hook (decode-thread exit): one final sample so the
        tail of the run is recorded, then detach from the JSONL sink —
        a stopped fleet never leaves a live capture or a half-written
        log line. Idempotent."""
        if self._closed:
            return
        self.sample()
        self._closed = True
        if self.sink is not None:
            self.sink.release()

    # ------------------------------------------------------ queries

    @property
    def ring_bytes(self) -> int:
        return len(self.ring) * SAMPLE_BYTES

    def stats(self) -> Dict:
        return {"samples": self.samples, "dropped": self.dropped,
                "errors": self.errors, "ring_bytes": self.ring_bytes,
                "ring_len": len(self.ring), "ring_cap": self.ring.maxlen,
                "interval_s": self.interval_s,
                "log_lines": self.sink.lines if self.sink else 0}

    def last_rates(self) -> Dict:
        """Rates over the most recent sample — the compact snapshot
        ``GET /debug/vars`` embeds per engine."""
        snap = list(self.ring)
        if not snap:
            return {"samples": 0}
        t, dt, deltas, gauges = snap[-1]
        d = dict(zip(COUNTERS, deltas))
        out = {"age_s": round(time.monotonic() - t, 3),
               "dt_s": round(dt, 3), "samples": self.samples}
        for name, counter in RATES:
            out[name] = round(d[counter] / dt, 4)
        out.update(zip(GAUGES, gauges))
        return out

    def buckets(self, window_s: float, step_s: float,
                now: Optional[float] = None) -> List[Optional[dict]]:
        """Raw per-bucket sums over the trailing window: a list of
        ``{counter: delta-sum, "dt": wall-sum}`` (or ``None`` for empty
        buckets), oldest first, on the shared monotonic grid — the
        substrate both per-engine and fleet-aggregated series derive
        from."""
        t_now = time.monotonic() if now is None else now
        n = max(1, int(round(window_s / step_s)))
        start = t_now - n * step_s
        out: List[Optional[dict]] = [None] * n
        for t, dt, deltas, gauges in list(self.ring):
            i = int((t - start) / step_s)
            if i < 0 or i >= n:
                continue
            b = out[i]
            if b is None:
                b = out[i] = dict.fromkeys(COUNTERS, 0.0)
                b["dt"] = 0.0
                b["_gauges"] = list(gauges)
                b["_n"] = 0
            else:
                for j, g in enumerate(gauges):      # keep the latest
                    b["_gauges"][j] = g
            for name, d in zip(COUNTERS, deltas):
                b[name] += d
            b["dt"] += dt
            b["_n"] += 1
        return out

    def series(self, window_s: float = 120.0, step_s: float = 5.0,
               now: Optional[float] = None) -> Dict:
        doc = derive(self.buckets(window_s, step_s, now=now))
        doc.update({"engine": self.index, "role": self.role})
        doc.update(self.stats())
        return doc


def derive(buckets: List[Optional[dict]]) -> Dict:
    """Rate/gauge/event series from raw bucket sums. ``None`` buckets
    (no samples landed there) carry ``None`` values, so a console can
    show gaps instead of faking zeros."""
    rates = {name: [] for name, _ in RATES}
    gauges = {name: [] for name in GAUGES}
    events = {name: [] for name, _ in EVENTS}
    for b in buckets:
        if b is None or b["dt"] <= 0:
            for name, _ in RATES:
                rates[name].append(None)
            for name in GAUGES:
                gauges[name].append(None)
            for name, _ in EVENTS:
                events[name].append(0)
            continue
        dt = b["dt"]
        for name, counter in RATES:
            rates[name].append(round(b[counter] / dt, 4))
        for j, name in enumerate(GAUGES):
            gauges[name].append(b["_gauges"][j])
        for name, counter in EVENTS:
            events[name].append(int(b[counter]))
    return {"rates": rates, "gauges": gauges, "events": events,
            "buckets": len(buckets),
            "filled": sum(b is not None for b in buckets)}


def _merge(acc: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    if b is None:
        return acc
    if acc is None:
        acc = dict.fromkeys(COUNTERS, 0.0)
        acc["dt"] = 0.0
        acc["_gauges"] = [0] * len(GAUGES)
        acc["_n"] = 0
    for name in COUNTERS:
        acc[name] += b[name]
    acc["dt"] += b["dt"]
    acc["_n"] += b["_n"]
    for j in range(len(GAUGES)):        # fleet gauges sum across engines
        acc["_gauges"][j] += b["_gauges"][j]
    return acc


def fleet_series(recorders, window_s: float = 120.0, step_s: float = 5.0,
                 now: Optional[float] = None) -> Dict:
    """Fleet-aggregated series: raw per-bucket deltas are summed across
    engines *before* rates derive, so busy fractions mean "seconds of
    phase work per second of fleet decode-thread time" — the quantity
    the N:M pool-sizing rule compares. Also groups by pool role:
    ``pools[role]`` carries each pool's busy fraction so a
    disaggregated fleet reads its sizing signal directly."""
    t_now = time.monotonic() if now is None else now
    n = max(1, int(round(window_s / step_s)))
    total: List[Optional[dict]] = [None] * n
    by_role: Dict[str, List[Optional[dict]]] = {}
    for rec in recorders:
        bks = rec.buckets(window_s, step_s, now=t_now)
        role = by_role.setdefault(rec.role, [None] * n)
        for i, b in enumerate(bks):
            total[i] = _merge(total[i], b)
            role[i] = _merge(role[i], b)
    doc = derive(total)
    doc["engines"] = len(list(recorders))
    pools = {}
    for role, bks in sorted(by_role.items()):
        d = derive(bks)
        pools[role] = {
            "engines": sum(1 for r in recorders if r.role == role),
            "busy_frac": d["rates"]["busy_frac"],
            "prefill_busy_frac": d["rates"]["prefill_busy_frac"],
            "decode_busy_frac": d["rates"]["decode_busy_frac"],
            "tok_s": d["rates"]["tok_s"],
        }
    doc["pools"] = pools
    return doc


def timeline_doc(loops, window_s: float = 120.0, step_s: float = 5.0,
                 watchdog=None) -> Dict:
    """The ``GET /debug/timeline`` document: per-engine + fleet series
    on one shared time grid (bucket-end offsets in seconds, newest at
    0). ``loops`` is the EngineLoop list; loops without a recorder are
    skipped (the doc says how many reported)."""
    now = time.monotonic()
    recs = [lp.recorder for lp in loops
            if getattr(lp, "recorder", None) is not None]
    n = max(1, int(round(window_s / step_s)))
    t = [round(-(n - 1 - i) * step_s, 3) for i in range(n)]
    doc = {"window_s": window_s, "step_s": step_s, "t": t,
           "engines_total": len(list(loops)),
           "engines_reporting": len(recs),
           "engines": [r.series(window_s, step_s, now=now)
                       for r in recs],
           "fleet": (fleet_series(recs, window_s, step_s, now=now)
                     if recs else None)}
    if watchdog is not None:
        try:
            doc["slo"] = watchdog.current()
        except Exception:
            log.exception("timeline SLO snapshot failed")
    return doc
