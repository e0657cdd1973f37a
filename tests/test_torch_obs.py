"""The port's observability layer (``repro_torch.obs``), mirroring
``tests/test_obs.py``: tracer ring buffers, Chrome-trace export and the
periodic flusher, request span trees, histograms, the CUDA allocator
reader, structured logging under ``repro_torch``, telemetry and the
graph-capture ledger. Then the span trees themselves against the JAX
package: one lifecycle script (a finish, a cancel while waiting, a
preempt and resume, a cancel while active) through
``repro.serving.ContinuousEngine`` and ``repro_torch.serving.
ContinuousEngine`` on ``tiny`` with the same ``PRNGKey(3)`` weights,
each with its own tracer, gives the same span tree for every request
and the same engine-track spans (name and arguments) in the same order.
"""
import functools
import io
import json
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.obs.trace import Tracer as JTracer
from repro.obs.trace import request_tree as jrequest_tree
from repro.serving import ContinuousEngine as JContinuousEngine
from repro_torch.bridge import params_from_jax
from repro_torch.core.decoder import DecodeConfig
from repro_torch.models.config import get_config
from repro_torch.obs import (BlockStats, CompileWatch, Histogram,
                             TelemetryAggregator, TraceFlusher, Tracer,
                             device_memory_stats, get_logger, setup_logging,
                             span)
from repro_torch.obs.trace import request_tree
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)


# ------------------------------------------------------------ tracer core


def test_tracer_complete_events_and_clock():
    tr = Tracer()
    with tr.span("work", pid=0, tag="x"):
        time.sleep(0.002)
    evs = [e for e in tr.events() if e.get("ph") == "X"]
    assert len(evs) == 1
    ev = evs[0]
    assert ev["name"] == "work" and ev["args"] == {"tag": "x"}
    assert ev["dur"] >= 1500                 # >= 1.5 ms in microseconds
    assert ev["ts"] >= 0                     # monotonic since birth


def test_tracer_null_span_helper():
    with span(None, "ignored"):              # tracer off: no-op context
        pass
    tr = Tracer()
    with span(tr, "kept"):
        pass
    assert any(e.get("name") == "kept" for e in tr.events())


def test_tracer_ring_capacity_drops_oldest():
    tr = Tracer(capacity_per_thread=8)
    for i in range(20):
        tr.instant(f"ev{i}")
    evs = [e for e in tr.events() if e.get("ph") == "i"]
    assert len(evs) == 8 and evs[-1]["name"] == "ev19"
    assert tr.dropped == 12
    assert len({tr.new_trace_id() for _ in range(100)}) == 100


def test_request_tree_nesting_and_errors():
    tr = Tracer()
    tid = tr.new_trace_id()
    t = time.perf_counter_ns()
    tr.async_begin(tid, "request", t_ns=t)
    tr.async_begin(tid, "queue", t_ns=t + 10)
    tr.async_end(tid, "queue", t_ns=t + 20)
    tr.async_begin(tid, "decode", t_ns=t + 20)   # ties: e before b
    tr.async_end(tid, "decode", t_ns=t + 50)
    tr.async_end(tid, "request", t_ns=t + 60)
    tree = request_tree(tr.request_events(tid))
    assert [(name, depth) for name, depth, _, _ in tree] == \
        [("request", 0), ("queue", 1), ("decode", 1)]
    assert all(dur is not None for _, _, _, dur in tree)
    with pytest.raises(ValueError):          # unclosed span
        request_tree([{"ph": "b", "name": "a", "ts": 1.0}])
    with pytest.raises(ValueError):          # end without begin
        request_tree([{"ph": "e", "name": "a", "ts": 1.0}])


def test_chrome_trace_export_schema(tmp_path):
    tr = Tracer()
    pid = tr.process("engine-0")
    tr.name_thread("decode", pid=pid)
    with tr.span("block", pid=pid):
        pass
    tid = tr.new_trace_id()
    t = time.perf_counter_ns()
    tr.async_span(tid, "request", t, t + 1000, pid=pid)
    doc = json.loads(open(tr.export(str(tmp_path / "t.json"))).read())
    evs = doc["traceEvents"]
    for e in evs:
        assert e["ph"] in {"M", "X", "b", "e", "i"}
        assert isinstance(e["name"], str) and isinstance(e["pid"], int)
        if e["ph"] != "M":
            assert isinstance(e["ts"], float)
        if e["ph"] in ("b", "e"):
            assert e["cat"] == "request" and e["id"] == tid
    kinds = [e["ph"] for e in evs]
    assert kinds[:kinds.count("M")] == ["M"] * kinds.count("M")
    assert {"frontend", "engine-0", "decode"} <= {
        e["args"]["name"] for e in evs if e["ph"] == "M"}


def test_trace_flusher_periodic_and_final(tmp_path):
    tr = Tracer()
    path = str(tmp_path / "trace.json")
    fl = TraceFlusher(tr, path, interval_s=0.05).start()
    with tr.span("early"):
        pass
    deadline = time.time() + 5.0
    while fl.flushes == 0 and time.time() < deadline:
        time.sleep(0.02)
    assert fl.flushes >= 1
    early = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "early" for e in early)
    with tr.span("late"):
        pass
    fl.stop()                                # final flush by default
    assert not fl._thread.is_alive()
    late = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "late" for e in late)


def test_trace_flusher_stop_without_final_flush(tmp_path):
    tr = Tracer()
    path = str(tmp_path / "trace.json")
    fl = TraceFlusher(tr, path, interval_s=60.0).start()
    with tr.span("never-flushed"):
        pass
    fl.stop(final_flush=False)
    assert not fl._thread.is_alive()
    assert not os.path.exists(path)          # no tick fired, no write


# ------------------------------------------------- metrics, logs, ledger


def test_histogram_buckets_sum_count_and_merge():
    h = Histogram("x_seconds", "test", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    counts, s, n = h.snapshot()
    assert counts == [1, 1, 1, 1] and n == 4
    assert s == pytest.approx(55.55)
    lines = h.prometheus()
    assert 'x_seconds_bucket{le="1.0"} 2' in lines     # cumulative
    assert 'x_seconds_bucket{le="+Inf"} 4' in lines
    assert 'x_seconds_bucket{engine="1",le="0.1"} 1' in h.prometheus(
        'engine="1"')
    a = Histogram("x", "t", buckets=(1.0, 2.0))
    b = Histogram("x", "t", buckets=(1.0, 2.0))
    a.observe(0.5)
    b.observe(1.5)
    a.merge(b)
    assert a.snapshot()[0] == [1, 1, 0]
    with pytest.raises(ValueError):
        a.merge(Histogram("x", "t", buckets=(5.0,)))


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("the card's reader is tests/test_torch_cuda.py's")
    assert device_memory_stats() == {}


def _tiny_engine():
    from repro_torch.models import init_params
    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    return ContinuousEngine(cfg, params, DecodeConfig(
        method="streaming", gen_len=32, block_size=8, window=4),
        max_slots=2, device="cpu")


def test_device_memory_stats_reference_keys_on_a_faked_allocator(
        monkeypatch):
    """On a card the reader reports the keys the front end's
    ``repro_device_*`` series read (the JAX package's names), beside
    PyTorch's own, and takes ``bytes_limit`` from the device properties
    once (never ``mem_get_info``, a CUDA call that a graph capture on
    the decode thread would refuse). The allocator is faked here."""
    from types import SimpleNamespace

    from repro_torch.obs import metrics
    from repro_torch.server import EngineLoop, HttpFrontend
    stats = {"allocated_bytes.all.current": 123, "allocated_bytes.all.peak":
             456, "num_alloc_retries": 0, "requested_bytes.all.current": 120}
    props = []

    def fake_props(i):
        props.append(i)
        return SimpleNamespace(total_memory=80 << 30)

    def no_mem_get_info(*a, **kw):
        raise AssertionError("mem_get_info must not be called")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties", fake_props)
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_mem_get_info)
    monkeypatch.setattr(metrics, "_BYTES_LIMIT", {})
    for _ in range(2):
        mem = metrics.device_memory_stats()
        assert set(mem) == {"cuda:0"}
        row = mem["cuda:0"]
        assert (row["bytes_in_use"], row["peak_bytes_in_use"],
                row["bytes_limit"]) == (123.0, 456.0, float(80 << 30))
        assert row["allocated_bytes.all.current"] == 123.0
    assert props == [0]                      # read once, then cached
    text = HttpFrontend(EngineLoop(_tiny_engine()))._metrics_text()
    assert 'repro_device_bytes_in_use{device="cuda:0"} 123' in text
    assert 'repro_device_peak_bytes_in_use{device="cuda:0"} 456' in text
    assert f'repro_device_bytes_limit{{device="cuda:0"}} {80 << 30}' in text


def test_block_profiler_writes_a_trace_over_n_blocks_on_the_cpu(tmp_path):
    """``BlockProfiler`` (``torch.profiler``, the CPU activity here)
    starts at the first decoded block, stops itself once N blocks are
    decoded and writes a Chrome trace under ``<dir>/torch_profile``; a
    later tick does nothing."""
    from repro_torch.obs import BlockProfiler
    eng = _tiny_engine()
    eng.profiler = prof = BlockProfiler(str(tmp_path), 2)
    eng.submit(np.arange(10, dtype=np.int32), max_tokens=32)
    seen = []
    while not eng.scheduler.idle:
        eng.step()
        seen.append((prof.active, prof.done))
    assert seen[0] == (True, False)          # one block decoded
    assert seen[1] == (False, True)          # the second stops it
    assert prof.seen == 2 and eng.telemetry.blocks == 4
    path = tmp_path / "torch_profile" / "trace.json"
    assert str(path) == prof.trace_path
    doc = json.loads(path.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    mtime = path.stat().st_mtime_ns
    prof.tick(1)
    prof.close()
    assert path.stat().st_mtime_ns == mtime and not prof.active


def test_json_logging_under_repro_torch():
    buf = io.StringIO()
    setup_logging(level="debug", json_mode=True, stream=buf)
    log = get_logger("test.obs")
    assert log.name == "repro_torch.test.obs"
    log.info("block decoded", extra={"uid": 7, "gang": [7, 8],
                                     "trace_id": "t-1"})
    doc = json.loads(buf.getvalue().strip())
    assert doc["msg"] == "block decoded" and doc["level"] == "INFO"
    assert doc["logger"] == "repro_torch.test.obs"
    assert doc["uid"] == 7 and doc["gang"] == [7, 8]
    buf2 = io.StringIO()
    setup_logging(level="info", json_mode=False, stream=buf2)
    assert len(logging.getLogger("repro_torch").handlers) == 1
    log.info("plain", extra={"uid": 9})
    assert "plain" in buf2.getvalue() and "uid=9" in buf2.getvalue()
    setup_logging(level="warning", stream=io.StringIO())


def test_telemetry_aggregator_accumulates():
    agg = TelemetryAggregator()
    bs = BlockStats(method="streaming", block_idx=0, batch=2, live_rows=2,
                    steps=3, steps_cap=8, committed_per_step=[10, 4, 2],
                    straggler_fill=0, conf_hist=[0] * 9 + [16], window=4,
                    early_exits=2, wall_s=0.5)
    agg.add(bs)
    agg.add(bs)
    assert bs.tokens_committed == 16 and bs.nfe == 6
    row = agg.summary()["streaming/0"]
    assert row["blocks"] == 2 and row["committed_per_step"] == [20, 8, 4]
    tot = agg.totals()
    assert tot["tokens"] == 32
    assert tot["steps_saved_frac"] == pytest.approx(1 - 6 / 16)


def test_compile_watch_counts_captures_after_warm():
    cw, tr, size = CompileWatch(), Tracer(), [0]

    def build():
        size[0] += 2
        return "built"

    assert cw.watched(build, lambda: size[0], "admit", tracer=tr) == "built"
    cw.mark_warm()
    cw.watched(lambda: None, lambda: size[0], "admit")   # nothing new
    cw.watched(build, lambda: size[0], "resume", tracer=tr)
    c = cw.counters()
    assert (c["misses"], c["hits"], c["post_warm"]) == (4, 1, 2)
    assert [e["args"] for e in tr.events() if e["ph"] == "X"] == [
        {"variants": 2, "what": "admit"}, {"variants": 2, "what": "resume"}]


# ------------------------------------------- span trees against the JAX one

PROMPTS = np.random.default_rng(0).integers(0, 200, (3, 10)).astype(
    np.int32)
DKW = dict(method="streaming", gen_len=32, block_size=8, window=4,
           tau0=0.5)


def lifecycle(eng, tr, tree):
    """Two slots. r2 waits and is cancelled while waiting; r1 is
    preempted after tick 0 and resumes at once; r0 is cancelled while
    active after tick 1; r3 arrives then, takes r0's slot and runs to
    its end. Returns each request's span tree (built by ``tree``) as
    (name, depth) and the engine track's events as (phase, name, args)
    in order. ``compile`` spans are left out: the JAX package's count
    XLA compiles, the port's graph captures, which differ by design."""
    ids = [tr.new_trace_id() for _ in range(4)]
    u = [eng.submit(PROMPTS[i], max_tokens=32, trace_id=ids[i])
         for i in range(3)]
    eng.step()
    assert eng.cancel(u[2]).cancelled
    eng.preempt(u[1])
    assert eng.cancel(u[0]) is None          # active: released next tick
    u.append(eng.submit(PROMPTS[2], max_tokens=32, trace_id=ids[3]))
    eng.run_to_completion()
    trees = [[(n, d) for n, d, _, _ in tree(tr.request_events(t))]
             for t in ids]
    track = [(e["ph"], e["name"], e["args"]) for e in tr.events()
             if e["ph"] in ("X", "i") and e["name"] != "compile"]
    return trees, track


@functools.lru_cache(maxsize=None)
def jax_lifecycle():
    cfg = jget_config("tiny")
    params = jax.jit(jinit_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(3))
    tr = JTracer()
    eng = JContinuousEngine(cfg, params, JDecodeConfig(**DKW), max_slots=2,
                            tracer=tr)
    return (*lifecycle(eng, tr, jrequest_tree), params)


@functools.lru_cache(maxsize=None)
def port_lifecycle():
    params = params_from_jax(jax.tree.map(np.asarray, jax_lifecycle()[2]),
                             "cpu")
    tr = Tracer()
    eng = ContinuousEngine(get_config("tiny"), params, DecodeConfig(**DKW),
                           max_slots=2, tracer=tr, device="cpu")
    return lifecycle(eng, tr, request_tree)


@pytest.mark.parametrize("request_index", range(4),
                         ids=["cancel_active", "preempted",
                              "cancel_waiting", "finished"])
def test_span_tree_matches_jax(request_index):
    trees, _ = port_lifecycle()
    jtrees = jax_lifecycle()[0]
    assert trees[request_index] == jtrees[request_index]
    names = [n for n, _ in trees[request_index]]
    assert names[0] == "request"
    assert names.count("decode") == [1, 2, 0, 1][request_index]


def test_engine_track_matches_jax():
    """prefill, decode_block (method, block, batch, steps, committed)
    and preempt spans, in the JAX engine's order."""
    _, track = port_lifecycle()
    assert track == jax_lifecycle()[1]
    assert {n for _, n, _ in track} >= {"prefill", "decode_block",
                                        "preempt"}
