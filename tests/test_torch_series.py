"""The port's time-series recorder (``repro_torch.obs.series``),
mirroring ``tests/test_series.py`` inside the port (``tiny`` on the CPU,
the port's own seeded weights).

Three layers:

* **unit** — the delta-encoded ring against a fake engine whose
  counters the test advances by hand: rate reconstruction, ring
  bounding + drop accounting, the never-raise sampling contract, the
  shared JSONL sink's refcounted lifecycle, and the fleet fan-in
  invariant (raw per-bucket deltas sum across engines *before* rates
  derive — an average of per-engine fractions is wrong whenever the
  engines' sample cadences differ, and the test constructs exactly
  that case).
* **concurrency** — a writer thread force-sampling flat out while the
  reader repeatedly derives windowed series and last-rates snapshots:
  the lock-free deque contract (GIL-atomic appends of immutable
  tuples) must never tear a sample or raise.
* **integration** — a real engine behind the HTTP frontend: the
  recorder sampled on the decode-thread cadence, `/debug/timeline`
  (including parameter clamping), `/console`, `/debug/vars`'s compact
  snapshot, `--metrics-log` JSONL persistence through graceful drain,
  a strict Prometheus-exposition parse of `_metrics_text()` from a
  loaded multi-engine frontend, and per-pool busy fractions on a live
  prefill:1,decode:1 fleet through the router.
"""
import asyncio
import contextlib
import json
import re
import threading
import time
import types

import pytest
import torch

from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import DecodeConfig
from repro_torch.models import get_config, init_params
from repro_torch.obs.series import (COUNTERS, GAUGES, JsonlSink,
                                    MetricsRecorder, fleet_series,
                                    timeline_doc)
from repro_torch.server import EngineLoop, EngineRouter, HttpFrontend
from repro_torch.server import client as C
from repro_torch.server.types import ServerRequest
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
MAX_TOKENS = 16
BLOCK = 8
CHUNK = 8
PROMPTS = [f"Q:{i}{(i + 3) % 10}+{(i + 5) % 10}{i}=? Answer"
           for i in range(4)]
TEST_TIMEOUT_S = 240


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, TEST_TIMEOUT_S))


# --------------------------------------------------------- fakes

_METRIC_ATTRS = (
    "total_nfe", "cancelled", "admission_rejects", "deadline_misses",
    "steals_in", "steals_out", "handoffs_in", "handoffs_out",
    "prefix_cache_hit_tokens", "prefill_busy_s", "decode_busy_s",
    "busy_time_s", "wall_time_s", "compile_misses", "compile_seconds",
    "queue_depth", "prefix_cache_bytes", "audit_backlog",
)


class FakeMetrics:
    def __init__(self):
        for name in _METRIC_ATTRS:
            setattr(self, name, 0.0)


class FakeEngine:
    """Counters the test advances by hand, shaped like the slice of
    ContinuousEngine the recorder reads."""

    def __init__(self):
        self.metrics = FakeMetrics()
        self.stats = {"tokens": 0.0, "good_tokens": 0.0,
                      "requests": 0.0}
        self.scheduler = types.SimpleNamespace(live_rows=0)

    def tick(self, tokens=0.0, requests=0.0, busy=0.0, wall=0.0,
             prefill=0.0, decode=0.0, nfe=0.0, steals=0.0):
        self.stats["tokens"] += tokens
        self.stats["good_tokens"] += tokens
        self.stats["requests"] += requests
        m = self.metrics
        m.busy_time_s += busy
        m.wall_time_s += wall
        m.prefill_busy_s += prefill
        m.decode_busy_s += decode
        m.total_nfe += nfe
        m.steals_in += steals


class _BrokenMetrics:
    def __getattr__(self, name):
        raise RuntimeError(f"metrics read of {name} exploded")


# --------------------------------------------------------- unit

def test_delta_rates_and_windowed_series():
    eng = FakeEngine()
    t0 = time.monotonic()
    rec = MetricsRecorder(eng, interval_s=0.01)
    rec._last_t = t0                       # pin the grid for the test
    # three 1 s samples: 100, 50, 0 tokens; half-busy throughout
    for i, toks in enumerate((100, 50, 0)):
        eng.tick(tokens=toks, requests=1, busy=0.5, wall=1.0,
                 decode=0.5)
        assert rec.sample(now=t0 + (i + 1) * 1.0)
    assert rec.samples == 3 and rec.errors == 0

    last = rec.last_rates()
    assert last["tok_s"] == 0.0            # newest sample had 0 tokens
    assert last["rps"] == 1.0
    assert last["busy_frac"] == pytest.approx(0.5)

    # query half a step after the last sample (a live query's clock is
    # always strictly ahead of every sample it reads)
    doc = rec.series(window_s=4.0, step_s=1.0, now=t0 + 3.5)
    assert doc["buckets"] == 4 and doc["filled"] == 3
    tok_s = doc["rates"]["tok_s"]
    assert tok_s[0] is None                # empty bucket shows a gap
    assert tok_s[1:] == [100.0, 50.0, 0.0]
    assert doc["rates"]["decode_busy_frac"][1:] == [0.5, 0.5, 0.5]
    # per-bucket deltas are self-contained: dropping the head sample
    # must not change the remaining buckets
    rec.ring.popleft()
    doc2 = rec.series(window_s=4.0, step_s=1.0, now=t0 + 3.5)
    assert doc2["rates"]["tok_s"][2:] == [50.0, 0.0]


def test_ring_bounded_and_drops_counted():
    eng = FakeEngine()
    rec = MetricsRecorder(eng, interval_s=0.001, max_bytes=1)
    assert rec.ring.maxlen == 16           # floor
    t0 = time.monotonic()
    rec._last_t = t0
    for i in range(40):
        eng.tick(tokens=1, wall=0.01)
        assert rec.sample(now=t0 + (i + 1) * 0.01)
    assert len(rec.ring) == 16
    assert rec.samples == 40
    assert rec.dropped == 24
    assert rec.stats()["ring_cap"] == 16


def test_sampler_never_raises():
    eng = FakeEngine()
    rec = MetricsRecorder(eng, interval_s=0.001)
    good = eng.metrics
    eng.metrics = _BrokenMetrics()
    time.sleep(0.005)
    assert rec.sample() is False           # logged and dropped
    assert rec.errors == 1
    eng.metrics = good                     # recovers on the next tick
    eng.tick(tokens=5, wall=0.01)
    time.sleep(0.005)
    assert rec.sample() is True
    assert rec.errors == 1


def test_interval_throttle():
    eng = FakeEngine()
    rec = MetricsRecorder(eng, interval_s=10.0)
    assert rec.maybe_sample() is False     # inside the interval
    assert rec.samples == 0
    t = time.monotonic() + 11.0
    eng.tick(tokens=1, wall=1.0)
    assert rec.maybe_sample(now=t) is True


def test_jsonl_sink_refcounted_shared(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    sink = JsonlSink(path)
    engines = [FakeEngine(), FakeEngine()]
    recs = [MetricsRecorder(e, index=i, role="decode",
                            interval_s=0.001, sink=sink)
            for i, e in enumerate(engines)]
    for _ in range(2):
        for e, r in zip(engines, recs):
            e.tick(tokens=3, wall=0.01)
            time.sleep(0.003)
            assert r.sample()
    recs[0].close()
    assert sink._f is not None             # still held by recorder 1
    recs[1].close()
    assert sink._f is None                 # last release closes
    recs[1].close()                        # idempotent
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert len(lines) >= 4 and len(lines) == sink.lines
    for doc in lines:
        assert doc["engine"] in (0, 1) and doc["role"] == "decode"
        assert set(doc["d"]) == set(COUNTERS)
        assert set(doc["g"]) == set(GAUGES)
        assert doc["dt"] > 0


def test_fleet_fan_in_sums_deltas_before_deriving():
    """Engine A: 1 s sampled, fully busy. Engine B: 3 s sampled, fully
    idle. Correct fleet busy fraction is 1/4 (one busy second out of
    four decode-thread seconds); averaging per-engine fractions would
    say 1/2."""
    t0 = time.monotonic()
    a, b = FakeEngine(), FakeEngine()
    ra = MetricsRecorder(a, index=0, role="prefill", interval_s=0.001)
    rb = MetricsRecorder(b, index=1, role="decode", interval_s=0.001)
    ra._last_t = t0 + 2.0                  # A's sample spans [2, 3)
    rb._last_t = t0
    a.tick(tokens=80, busy=1.0, wall=1.0, prefill=1.0)
    assert ra.sample(now=t0 + 3.0)
    b.tick(tokens=0, busy=0.0, wall=3.0)
    assert rb.sample(now=t0 + 3.0)

    doc = fleet_series([ra, rb], window_s=4.0, step_s=4.0,
                       now=t0 + 3.5)
    assert doc["engines"] == 2
    assert doc["rates"]["busy_frac"][-1] == pytest.approx(0.25)
    assert doc["rates"]["tok_s"][-1] == pytest.approx(80 / 4.0)
    # per-pool view keeps each role's own fraction
    assert set(doc["pools"]) == {"prefill", "decode"}
    assert doc["pools"]["prefill"]["engines"] == 1
    assert doc["pools"]["prefill"]["busy_frac"][-1] \
        == pytest.approx(1.0)
    assert doc["pools"]["decode"]["busy_frac"][-1] \
        == pytest.approx(0.0)
    assert doc["pools"]["prefill"]["prefill_busy_frac"][-1] \
        == pytest.approx(1.0)


def test_timeline_doc_skips_recorderless_loops():
    eng = FakeEngine()
    rec = MetricsRecorder(eng, interval_s=0.001)
    eng.tick(tokens=10, wall=0.01)
    time.sleep(0.005)
    assert rec.sample()
    loops = [types.SimpleNamespace(recorder=rec, role="both"),
             types.SimpleNamespace()]      # no recorder attached
    doc = timeline_doc(loops, window_s=10.0, step_s=1.0)
    assert doc["engines_total"] == 2
    assert doc["engines_reporting"] == 1
    assert len(doc["t"]) == 10 and doc["t"][-1] == 0.0
    assert doc["t"][0] == -9.0
    assert len(doc["engines"]) == 1
    assert doc["fleet"]["engines"] == 1
    json.dumps(doc)                        # wire-serializable


def test_timeline_doc_empty_fleet():
    doc = timeline_doc([types.SimpleNamespace()], window_s=10.0,
                       step_s=1.0)
    assert doc["engines_reporting"] == 0 and doc["fleet"] is None


# --------------------------------------------------------- concurrency

def test_writer_reader_hammer():
    """Writer thread samples flat out while the reader derives series
    and snapshots continuously: no tearing, no exceptions, and every
    datum the reader sees is well-formed."""
    eng = FakeEngine()
    rec = MetricsRecorder(eng, interval_s=1e-6, max_bytes=64 << 10)
    stop = threading.Event()
    wrote = {"n": 0}

    def writer():
        while not stop.is_set():
            eng.tick(tokens=4, requests=1, busy=0.001, wall=0.002,
                     decode=0.001, nfe=2)
            if rec.sample():
                wrote["n"] += 1

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 2.0
        reads = 0
        while time.monotonic() < deadline:
            doc = rec.series(window_s=1.0, step_s=0.05)
            assert doc["buckets"] == 20
            for vals in doc["rates"].values():
                assert len(vals) == 20
                assert all(v is None or v >= 0 for v in vals)
            last = rec.last_rates()
            if last["samples"]:
                assert last["dt_s"] >= 0
            reads += 1
    finally:
        stop.set()
        th.join(timeout=10)
    assert reads > 50 and wrote["n"] > 100
    assert rec.errors == 0
    assert rec.samples == wrote["n"]


# --------------------------------------------------------- integration

def make_engine(store=None, prefill_only=False, max_slots=2):
    dcfg = DecodeConfig(method="streaming", gen_len=MAX_TOKENS,
                        block_size=BLOCK, window=4, tau0=0.5,
                        prefix_cache=store is not None, cache_chunk=CHUNK)
    return ContinuousEngine(CFG, PARAMS, dcfg, max_slots=max_slots,
                            prefix_cache=store, prefill_only=prefill_only,
                            device="cpu")


@contextlib.asynccontextmanager
async def _server(metrics_log=None):
    eng = make_engine()
    loop = EngineLoop(eng, max_pending=16, idle_poll_s=0.002)
    sink = JsonlSink(metrics_log) if metrics_log else None
    loop.recorder = MetricsRecorder(eng, index=0, role="both",
                                    interval_s=0.02, sink=sink,
                                    loop=loop)
    front = await HttpFrontend(loop, port=0).start()
    try:
        yield front, eng, loop
    finally:
        await front.shutdown(drain=True, timeout_s=30)


def test_http_timeline_and_console(tmp_path):
    log_path = str(tmp_path / "metrics.jsonl")

    async def scenario():
        async with _server(metrics_log=log_path) as (front, eng, loop):
            host, port = front.host, front.port
            for p in PROMPTS[:2]:
                status, _, doc = await C.complete(
                    host, port, {"prompt": p, "max_tokens": MAX_TOKENS})
                assert status == 200

            status, headers, body = await C.request(
                host, port, "GET", "/debug/timeline?window=30&step=1")
            assert status == 200
            assert headers["content-type"].startswith("application/json")
            doc = json.loads(body)
            assert doc["window_s"] == 30.0 and doc["step_s"] == 1.0
            assert len(doc["t"]) == 30
            assert doc["engines_reporting"] == 1
            tok_s = doc["fleet"]["rates"]["tok_s"]
            assert any(v for v in tok_s if v), tok_s
            busy = doc["fleet"]["rates"]["busy_frac"]
            assert any(v is not None for v in busy)

            # hostile parameters clamp to sane defaults, never 500
            status, _, body = await C.request(
                host, port, "GET",
                "/debug/timeline?window=bogus&step=-5&junk=1")
            assert status == 200
            doc = json.loads(body)
            assert doc["window_s"] == 120.0 and doc["step_s"] == 0.1

            status, headers, page = await C.request(
                host, port, "GET", "/console")
            assert status == 200
            assert headers["content-type"].startswith("text/html")
            text = page.decode()
            assert text.lstrip().lower().startswith("<!doctype html>")
            assert "/debug/timeline" in text
            # zero external deps: no other-origin fetches in the page
            assert "https://" not in text and "cdn." not in text

            status, _, body = await C.request(host, port, "GET",
                                              "/debug/vars")
            assert status == 200
            dv = json.loads(body)
            eng_vars = dv["engines"][0]
            assert eng_vars["recorder"]["samples"] >= 1
            assert "tok_s" in eng_vars["recorder"]
            rec = loop.recorder
        # graceful drain closed the recorder (final tail sample) and
        # released the shared sink
        assert rec._closed
        lines = [json.loads(ln) for ln in open(log_path) if ln.strip()]
        assert len(lines) == rec.stats()["log_lines"] >= 1
        assert all(set(d["d"]) == set(COUNTERS) for d in lines)

    _run(scenario())


# strict exposition-format grammar (the subset Prometheus accepts for
# text format 0.0.4): used to parse the full /metrics payload below
_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE = re.compile(rf"^({_NAME})(?:\{{(.*)\}})?\s(\S+)$")


def parse_exposition(text):
    """Strict parse: HELP before TYPE before samples per family, legal
    types, parseable label sets and float values, no duplicate
    (name, labels) pairs. Returns {family: {"type", "samples"}}."""
    fams, seen = {}, set()
    for ln in text.splitlines():
        if not ln.strip():
            continue
        if ln.startswith("# HELP "):
            name, _, help_text = ln[len("# HELP "):].partition(" ")
            assert re.fullmatch(_NAME, name), ln
            assert name not in fams, f"duplicate HELP for {name}"
            fams[name] = {"type": None, "help": help_text,
                          "samples": []}
        elif ln.startswith("# TYPE "):
            name, _, mtype = ln[len("# TYPE "):].partition(" ")
            assert mtype in ("counter", "gauge", "summary",
                             "histogram"), ln
            assert name in fams, f"TYPE before HELP: {ln}"
            assert fams[name]["type"] is None, f"duplicate TYPE {name}"
            fams[name]["type"] = mtype
        else:
            assert not ln.startswith("#"), f"unknown comment: {ln!r}"
            m = _SAMPLE.match(ln)
            assert m, f"unparseable sample line: {ln!r}"
            name, labels, value = m.groups()
            float(value)                   # must parse
            fam = name
            for suffix in ("_bucket", "_sum", "_count"):
                base = name[:-len(suffix)] if name.endswith(suffix) \
                    else None
                if base in fams and fams[base]["type"] in ("summary",
                                                           "histogram"):
                    fam = base
            assert fam in fams, f"sample without HELP/TYPE: {ln!r}"
            if labels:
                consumed = _LABEL.sub("", labels).strip(", ")
                assert not consumed, f"bad label syntax: {labels!r}"
            key = (name, labels or "")
            assert key not in seen, f"duplicate sample {key}"
            seen.add(key)
            fams[fam]["samples"].append((name, labels or "",
                                         float(value)))
    for name, fam in fams.items():
        assert fam["type"] is not None, f"HELP without TYPE: {name}"
    return fams


def test_metrics_text_strict_exposition():
    """Every line of /metrics from a *loaded* two-engine frontend (real
    requests decoded, recorders sampling) passes a strict
    exposition-format parse, and the repro_series_* families report
    the recorders' true totals."""
    engines = [make_engine() for _ in range(2)]
    for eng in engines:
        for p in PROMPTS[:2]:
            eng.submit(p, max_tokens=MAX_TOKENS)
        eng.run_to_completion()
    loops = []
    for i, eng in enumerate(engines):
        rec = MetricsRecorder(eng, index=i, role="both",
                              interval_s=0.001)
        time.sleep(0.003)
        assert rec.sample()
        loops.append(types.SimpleNamespace(recorder=rec, role="both"))
    front = HttpFrontend(types.SimpleNamespace(engines=engines,
                                               loops=loops,
                                               inflight=0, pending=0),
                         port=0)
    fams = parse_exposition(front._metrics_text())
    assert len(fams) > 20
    for name in ("repro_series_samples_total",
                 "repro_series_dropped_total",
                 "repro_series_errors_total", "repro_series_ring_bytes",
                 "repro_series_log_lines_total"):
        assert name in fams, sorted(fams)
    n_samples = sum(r.recorder.samples for r in loops)
    assert fams["repro_series_samples_total"]["samples"][0][2] \
        == n_samples
    assert fams["repro_series_errors_total"]["samples"][0][2] == 0
    assert fams["repro_tokens_total"]["samples"][0][2] > 0


def test_pool_busy_fractions_live_fleet():
    """A real prefill:1,decode:1 fleet under load reports per-pool busy
    fractions through the timeline doc: the prefill pool shows
    prefill-phase work, the decode pool decode-phase work (the N:M
    sizing signal)."""
    store = PrefixKVCache(chunk_tokens=CHUNK, shared=True,
                          placement=device_placement("cpu"))
    engines = [make_engine(store, prefill_only=True), make_engine(store)]
    loops = [EngineLoop(e, max_pending=32, idle_poll_s=0.002, index=i,
                        role="prefill" if i == 0 else "decode")
             for i, e in enumerate(engines)]
    for lp, eng in zip(loops, engines):
        lp.recorder = MetricsRecorder(eng, index=lp.index,
                                      role=lp.role, interval_s=0.01,
                                      loop=lp)
    router = EngineRouter(loops)
    for lp in loops:
        lp.start()
    try:
        done = []
        for p in PROMPTS:
            ev = threading.Event()

            def deliver(event, ev=ev):
                if event[0] == "done":
                    ev.set()

            router.submit(ServerRequest(prompt=p,
                                        max_tokens=MAX_TOKENS), deliver)
            done.append(ev)
        for ev in done:
            assert ev.wait(timeout=TEST_TIMEOUT_S)
        time.sleep(0.05)                   # one more sampling tick
    finally:
        assert router.close(drain=True, timeout_s=60)

    assert engines[0].metrics.handoffs_out == len(PROMPTS)
    doc = timeline_doc(loops, window_s=60.0, step_s=60.0)
    assert doc["engines_reporting"] == 2
    pools = doc["fleet"]["pools"]
    assert set(pools) == {"prefill", "decode"}
    assert pools["prefill"]["engines"] == 1
    assert pools["decode"]["engines"] == 1

    def last(series):
        vals = [v for v in series if v is not None]
        return vals[-1] if vals else None

    # the prefill pool did prefill-phase work and decoded nothing; the
    # decode pool generated the tokens
    assert last(pools["prefill"]["prefill_busy_frac"]) > 0
    assert not last(pools["prefill"]["decode_busy_frac"])
    assert last(pools["decode"]["decode_busy_frac"]) > 0
    assert last(pools["decode"]["tok_s"]) > 0
    json.dumps(doc)
