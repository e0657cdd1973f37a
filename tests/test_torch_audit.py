"""The port's quality-audit layer (``repro_torch.obs.audit``), mirroring
``tests/test_audit.py`` inside the port (``tiny`` on the CPU, the port's
own seeded weights), all of it.

Fault injection is the core of this suite: a flipped committed token
and a poisoned cached prefix chunk must each be *caught* by the shadow
auditor, attributed to the right divergence source and block index,
and produce a well-formed flight-recorder dump — including when the
audited request lived through preempt/resume and a cross-engine steal.
The clean matrix is the complement: every method x {fused, host} x
{cached, cold} serving configuration audits clean (dkv per its
documented structural contract), so the auditor can run always-on
without crying wolf.
"""
import asyncio
import contextlib
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import DecodeConfig
from repro_torch.models import get_config, init_params
from repro_torch.obs import Tracer
from repro_torch.obs.audit import (AuditConfig, FlightRecorder,
                                   ShadowAuditor, SLOWatchdog)
from repro_torch.server import EngineLoop, HttpFrontend
from repro_torch.server import client as C
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
MAX_TOKENS = 16
BLOCK = 8
CHUNK = 8                       # prefix-cache chunk (tokens)
# 16 chars = two full cache chunks, one shape bucket
PROMPTS = [f"Q:{i}{(i + 3) % 10}+{(i + 5) % 10}{i}=? Answer" for i in range(6)]
TEST_TIMEOUT_S = 240


def make_engine(method="streaming", fused=True, cached=False,
                max_slots=2):
    dcfg = DecodeConfig(method=method, gen_len=MAX_TOKENS,
                        block_size=BLOCK, window=4, tau0=0.5,
                        fused=fused, prefix_cache=cached,
                        cache_chunk=CHUNK)
    store = PrefixKVCache(chunk_tokens=CHUNK,
                          placement=device_placement("cpu")) \
        if cached else None
    return ContinuousEngine(CFG, PARAMS, dcfg, max_slots=max_slots,
                            prefix_cache=store, device="cpu")


def attach(eng, tmp_path=None, tracer=None, oracle="auto", rate=1.0,
           **cfg):
    flight = None
    if tmp_path is not None:
        flight = FlightRecorder(str(tmp_path), tracer=tracer)
    auditor = ShadowAuditor(
        eng, AuditConfig(sample_rate=rate, oracle=oracle, **cfg),
        tracer=tracer, flight=flight)
    eng.attach_auditor(auditor)
    return auditor, flight


def serve_and_audit(eng, prompts, tracer=None):
    """Run ``prompts`` to completion, then drain every audit."""
    for p in prompts:
        eng.submit(p, max_tokens=MAX_TOKENS,
                   trace_id=tracer.new_trace_id()
                   if tracer is not None else "")
    comps = eng.run_to_completion()
    eng.drain_audits()
    return comps


# --------------------------------------------------- clean matrix

MATRIX = [(m, fused, cached)
          for m in ("vanilla", "dkv", "prefix", "fast", "streaming")
          for fused in (True, False)
          for cached in ((False, True) if m != "vanilla" else (False,))]


@pytest.mark.parametrize("method,fused,cached", MATRIX)
def test_clean_run_zero_divergences(method, fused, cached):
    """Every serving configuration audits clean against its oracle
    lane(s); dkv may only report its documented structural class."""
    eng = make_engine(method, fused=fused, cached=cached)
    auditor, _ = attach(eng)
    comps = serve_and_audit(eng, PROMPTS[:2])
    assert len(comps) == 2 and not any(c.cancelled for c in comps)
    assert auditor.sampled == 2
    assert auditor.completed == 2
    assert auditor.errors == 0 and auditor.dropped == 0
    div = dict(auditor.divergences)
    structural = div.pop("dkv-structural")
    assert sum(div.values()) == 0, f"real divergences on clean run: {div}"
    if method != "dkv":
        assert structural == 0
    # lane coverage: host always; cold only when the cache is live
    lanes = {r.lane for r in auditor.results}
    assert lanes == ({"host", "cold"} if cached else {"host"})
    # a lane on the block loop (cold on a fused engine, host on a
    # host-loop one) builds its own block programs (CUDA graphs on the
    # card), counted apart from serving
    assert (auditor.lane_graphs() > 0) == (cached or not fused)
    # calibration rides every audited token; clean runs agree everywhere
    # except dkv's structural divergence tail
    assert sum(auditor.conf_total) > 0
    if method != "dkv":
        assert auditor.conf_agree == auditor.conf_total


# --------------------------------------------------- fault injection

def test_injected_token_flip_caught_and_attributed(tmp_path):
    """A flipped committed token is detected, classified fused-vs-host,
    attributed to the right block + span, and dumps a flight dir."""
    tracer = Tracer()
    eng = make_engine()
    eng.set_tracer(tracer, "engine-0")
    auditor, flight = attach(eng, tmp_path, tracer=tracer)
    flipped = {}

    def flip(tokens, lane):
        pos = len(tokens) // 2
        tokens[pos] = (tokens[pos] + 1) % CFG.vocab_size
        flipped["pos"] = pos
        return tokens

    auditor.inject = flip
    comps = serve_and_audit(eng, PROMPTS[:1], tracer=tracer)
    assert auditor.completed == 1
    assert auditor.divergences == {"fused-vs-host": 1,
                                   "cached-vs-cold": 0,
                                   "stolen-vs-resident": 0,
                                   "dkv-structural": 0}
    res = [r for r in auditor.results if not r.matched]
    assert len(res) == 1
    r = res[0]
    assert r.position == flipped["pos"]
    assert r.block == flipped["pos"] // BLOCK
    assert r.uid == comps[0].uid
    assert r.got != r.expected and r.got >= 0 and r.expected >= 0
    # span attribution resolves to the live block span, not evicted
    assert r.span == f"block {r.block}"
    # regret counts early-exited requests only
    assert auditor.regret == (1 if comps[0].early_exited else 0)
    # disagreeing tokens land in the calibration counters
    assert sum(auditor.conf_agree) < sum(auditor.conf_total)
    # the tracer carries the divergence instant
    assert any(e.get("name") == "audit_divergence"
               and e["args"]["source"] == "fused-vs-host"
               and e["args"]["block"] == r.block
               for e in tracer.events())
    _assert_flight_dump(flight, tmp_path, "audit-fused-vs-host")


def test_poisoned_cache_chunk_caught_by_cold_lane(tmp_path):
    """Corrupting a cached prefix chunk's KV changes served tokens; the
    host lane shares the store (reproduces the poison, matches) while
    the cache-bypass cold lane diverges -> cached-vs-cold."""
    tracer = Tracer()
    eng = make_engine(cached=True)
    eng.set_tracer(tracer, "engine-0")
    auditor, flight = attach(eng, tmp_path, tracer=tracer)
    prompt = PROMPTS[0]

    # request 1 populates the cache and audits clean on both lanes
    serve_and_audit(eng, [prompt], tracer=tracer)
    assert auditor.divergences_total() == 0
    store = eng.prefix_cache
    tok = np.asarray(eng.tok.encode(prompt), np.int32)
    chain = store.tree.walk(tok)
    assert chain, "prompt left no cached chunks"
    # poison the first chunk's KV in place (large perturbation so the
    # attention outputs actually move); a payload is one (k, v) host
    # tensor pair per layer
    chain[0].payload = [(k + 7.0, v + 7.0) for k, v in chain[0].payload]

    # request 2 prefills over the poisoned chunk
    comps = serve_and_audit(eng, [prompt], tracer=tracer)
    assert comps[0].cache_hit_tokens > 0, "expected a cache hit"
    assert auditor.divergences["cached-vs-cold"] == 1
    assert auditor.divergences["fused-vs-host"] == 0
    bad = [r for r in auditor.results if not r.matched]
    assert len(bad) == 1 and bad[0].lane == "cold"
    assert bad[0].source == "cached-vs-cold"
    assert bad[0].block == bad[0].position // BLOCK >= 0
    _assert_flight_dump(flight, tmp_path, "audit-cached-vs-cold")


def test_divergence_on_stolen_request_classified(tmp_path):
    """A request that was preempted, stolen, and finished on the thief
    still audits end to end on the thief; an injected flip there is
    classified stolen-vs-resident and the flight dump stays
    well-formed."""
    victim = make_engine(max_slots=1)
    thief = make_engine(max_slots=1)
    tracer = Tracer()
    thief.set_tracer(tracer, "thief")
    auditor, flight = attach(thief, tmp_path, tracer=tracer)

    uid = victim.submit(PROMPTS[0], max_tokens=MAX_TOKENS)
    victim.step()                         # prefill + block 0
    victim.preempt(uid)
    victim.scheduler._compact()
    req, state = victim.steal_paused()
    assert req.uid == uid
    thief.adopt_paused(req, state)
    comps = thief.run_to_completion()
    assert len(comps) == 1 and comps[0].stolen

    # clean audit of the stolen completion first
    thief.drain_audits()
    assert auditor.completed == 1
    assert auditor.divergences_total() == 0

    # then the same completion with a flip: stolen-vs-resident
    auditor.inject = lambda t, lane: (t.__setitem__(0, (t[0] + 1)
                                                    % CFG.vocab_size)
                                      or t)
    auditor.on_completion(comps[0])
    thief.drain_audits()
    assert auditor.divergences["stolen-vs-resident"] == 1
    bad = [r for r in auditor.results if not r.matched]
    assert bad[-1].block == 0 and bad[-1].position == 0
    _assert_flight_dump(flight, tmp_path, "audit-stolen-vs-resident")
    assert victim.run_to_completion() == []


def _assert_flight_dump(flight, tmp_path, reason):
    """One dump dir exists for ``reason`` and all three artifacts are
    present and parseable; trace.json is Chrome-trace shaped."""
    assert flight.dumps >= 1
    dirs = [d for d in os.listdir(tmp_path) if reason in d]
    assert dirs, f"no flight dump for {reason}: {os.listdir(tmp_path)}"
    path = os.path.join(tmp_path, sorted(dirs)[0])
    trace = json.load(open(os.path.join(path, "trace.json")))
    assert isinstance(trace["traceEvents"], list)
    metrics = json.load(open(os.path.join(path, "metrics.json")))
    assert metrics["meta"]["reason"] == reason
    state = json.load(open(os.path.join(path, "state.json")))
    assert state["meta"]["seq"] == metrics["meta"]["seq"]


# --------------------------------------------------- lane discipline

def test_audit_lane_yields_to_paying_traffic():
    """tick() refuses to decode while real traffic waits or occupies
    every slot — the audit lane only runs in the gaps."""
    eng = make_engine(max_slots=1)
    auditor, _ = attach(eng)
    comps = serve_and_audit(eng, PROMPTS[:1])
    assert auditor.completed == 1

    # queue another audit job, then make the engine busy again
    auditor.on_completion(comps[0])
    assert auditor.pending
    eng.submit(PROMPTS[1], max_tokens=MAX_TOKENS)
    assert eng.scheduler.waiting or eng.scheduler.slots_used >= 1
    assert eng.audit_tick() is False      # paying traffic owns the engine
    eng.run_to_completion()
    eng.drain_audits()
    assert not auditor.pending and auditor.errors == 0


def test_backlog_bound_drops_not_blocks():
    eng = make_engine()
    auditor, _ = attach(eng, max_backlog=1)
    serve_and_audit(eng, PROMPTS[:4])
    # 4 sampled, 1 queued at a time; intake past the bound drops
    assert auditor.sampled == 4
    assert auditor.dropped >= 1
    assert auditor.completed == auditor.sampled - auditor.dropped
    assert auditor.errors == 0


def test_audit_decoders_bypass_serving_compile_ledger():
    """Audit-lane decoders are not registered with the scheduler: their
    compiles must not count as serving (post-warm) compiles."""
    eng = make_engine()
    auditor, _ = attach(eng)
    serve_and_audit(eng, PROMPTS[:1])
    assert auditor.completed == 1
    watch = eng.scheduler.compile_watch
    assert watch.counters()["post_warm"] == 0
    assert all(k[0] in ("host", "cold")
               for k in auditor._lane_decoders)
    # the serving ledger counts the scheduler's own programs only
    assert watch.misses == eng.scheduler.graph_cache_size()
    assert auditor.stats()["lane_graphs"] == auditor.lane_graphs()


# --------------------------------------------------- SLO + flight

def _fake_comp(ttfb=0.01, latency=0.1, n=16):
    return types.SimpleNamespace(cancelled=False, ttfb_s=ttfb,
                                 latency_s=latency, n_tokens=n)


def test_slo_watchdog_breach_latches_and_dumps(tmp_path):
    flight = FlightRecorder(str(tmp_path), tracer=Tracer())
    wd = SLOWatchdog(ttfb_p50_s=0.05, min_requests=2, flight=flight)
    for _ in range(3):
        wd.observe(_fake_comp(ttfb=0.01))
    assert wd.breaches["ttfb_p50_s"] == 0       # in SLO
    for _ in range(6):
        wd.observe(_fake_comp(ttfb=0.5))        # p50 now over target
    cur = wd.current()
    assert cur["breached"]["ttfb_p50_s"] == 1
    assert wd.breaches["ttfb_p50_s"] == 1       # one onset, latched
    dirs = os.listdir(tmp_path)
    assert any("slo-ttfb_p50_s" in d for d in dirs)
    # a breach that stays breached never re-dumps
    wd.observe(_fake_comp(ttfb=0.5))
    assert wd.breaches["ttfb_p50_s"] == 1


def test_slo_goodput_floor():
    wd = SLOWatchdog(goodput_tok_s=1e12, min_requests=2)
    for _ in range(4):
        wd.observe(_fake_comp())
    assert wd.current()["breached"]["goodput_tok_s"] == 1
    wd2 = SLOWatchdog(goodput_tok_s=1e-9, min_requests=2)
    for _ in range(4):
        wd2.observe(_fake_comp())
        time.sleep(0.002)                 # nonzero window span
    assert wd2.current()["breached"]["goodput_tok_s"] == 0


def test_flight_recorder_debounce_and_force(tmp_path):
    flight = FlightRecorder(str(tmp_path), min_interval_s=60.0)
    assert flight.dump("first") is not None
    assert flight.dump("second") is None          # debounced
    assert flight.suppressed == 1
    forced = flight.dump("manual", force=True)
    assert forced is not None and "manual" in forced
    assert flight.dumps == 2
    # never raises, even with a broken state provider
    flight.state_provider = lambda: 1 / 0
    assert flight.dump("broken", force=True) is not None


# --------------------------------------------------- server routes

@contextlib.asynccontextmanager
async def _server(audit=True, flight_dir=None):
    tracer = Tracer()
    eng = make_engine(max_slots=2)
    eng.set_tracer(tracer, "engine-0")
    flight = FlightRecorder(flight_dir, tracer=tracer) \
        if flight_dir else None
    auditor = None
    if audit:
        auditor = ShadowAuditor(eng, AuditConfig(sample_rate=1.0),
                                tracer=tracer, flight=flight)
        eng.attach_auditor(auditor)
    wd = SLOWatchdog(ttfb_p50_s=30.0, min_requests=1)
    loop = EngineLoop(eng, max_pending=16, idle_poll_s=0.005,
                      tracer=tracer)
    loop.watchdog = wd
    loop.flight = flight
    if flight is not None and flight.state_provider is None:
        from repro_torch.server.http import _flight_state
        flight.state_provider = lambda: _flight_state([loop], wd)
    front = await HttpFrontend(loop, port=0, tracer=tracer,
                               flight=flight, watchdog=wd).start()
    try:
        yield front, eng, auditor
    finally:
        await front.shutdown(drain=False, timeout_s=30)


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, TEST_TIMEOUT_S))


async def _wait_audits(eng, auditor, timeout_s=60.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if auditor.sampled and not auditor.pending:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("audits never drained")


def test_debug_vars_and_flight_routes(tmp_path):
    async def scenario():
        async with _server(flight_dir=str(tmp_path)) as (front, eng,
                                                         auditor):
            host, port = front.host, front.port
            status, _, doc = await C.complete(
                host, port, {"prompt": PROMPTS[0],
                             "max_tokens": MAX_TOKENS})
            assert status == 200
            await _wait_audits(eng, auditor)

            status, _, body = await C.request(host, port, "GET",
                                              "/debug/vars")
            assert status == 200
            doc = json.loads(body)
            eng0 = doc["engines"][0]
            assert eng0["scheduler"]["slots_used"] == 0
            assert eng0["audit"]["sampled"] == auditor.sampled
            assert "compile" in eng0["scheduler"]
            assert doc["slo"]["targets"] == {"ttfb_p50_s": 30.0}

            status, _, body = await C.request(host, port, "GET",
                                              "/debug/flight")
            assert status == 200
            fl = json.loads(body)
            assert fl["dumps"] == 1
            assert os.path.isdir(fl["path"])
            for name in ("trace.json", "metrics.json", "state.json"):
                assert os.path.exists(os.path.join(fl["path"], name))
            # the manual dump's metrics carry live engine + audit state
            m = json.load(open(os.path.join(fl["path"], "metrics.json")))
            assert m["engines"][0]["audit"]["sampled"] >= 1

            status, _, body = await C.request(host, port, "GET",
                                              "/metrics")
            text = body.decode()
            for family in ("repro_audit_sampled_total",
                           "repro_audit_divergences_total",
                           "repro_audit_conf_agree_total",
                           "repro_slo_target", "repro_slo_breaches_total",
                           "repro_flight_dumps_total",
                           "repro_trace_drops_total"):
                assert family in text, f"missing {family} in /metrics"
            assert 'repro_audit_divergences_total{source="dkv-structural"}' \
                in text

    _run(scenario())


def test_debug_flight_without_recorder_503():
    async def scenario():
        async with _server(audit=False, flight_dir=None) as (front, _, _):
            status, _, body = await C.request(front.host, front.port,
                                              "GET", "/debug/flight")
            assert status == 503
            assert b"flight" in body

    _run(scenario())


def test_loop_audits_in_gaps_and_mirrors_metrics(tmp_path):
    """Under the EngineLoop, audits advance automatically between
    scheduler ticks and the counters are mirrored into ServeMetrics."""
    async def scenario():
        async with _server() as (front, eng, auditor):
            for p in PROMPTS[:3]:
                status, _, _ = await C.complete(
                    front.host, front.port,
                    {"prompt": p, "max_tokens": MAX_TOKENS})
                assert status == 200
            await _wait_audits(eng, auditor)
            assert auditor.completed == auditor.sampled == 3
            assert auditor.divergences_total() == 0
            snap = eng.metrics.snapshot()
            assert snap["audits_completed"] == 3
            assert snap["audit_divergences"] == 0
            assert snap["host_syncs_per_block"] == 1.0

    _run(scenario())
