"""The serving layers on a served ``--mesh``: disaggregated pools, the
shadow auditor, the flight recorder, the block profiler and every
rank's spans, through ``python -m repro_torch.launch.serve`` on gloo CPU
ranks, against the JAX package on the same weights.

The weights are the JAX package's ``init_params(get_config("tiny"),
PRNGKey(3))``, written by ``repro.training.checkpoint.save`` and served
through ``--ckpt`` in float32. One launcher starts four ranks
(``--force-host-devices 4``): ``--mesh 2,1 --pool prefill:1,decode:1``,
so the prefill engine is on ranks 0 and 1 (rank 0 leads it) and the
decode engine on ranks 2 and 3 (rank 2 leads it), and every handoff
crosses processes; with ``--prefix-cache --cache-chunk 4 --audit-rate
1.0 --flight-dir --trace-dir --profile-blocks 2``.

Held, over loopback: every completion's tokens equal the JAX
``ContinuousEngine`` serving that prompt alone with the prefix cache;
every request is handed off, each with a decode-side prefix hit of its
whole aligned prompt, and the handoff bytes are reported; the port's
auditor and a JAX ``ShadowAuditor`` on the same prompts both audit
clean, as many audits each; ``GET /debug/flight`` writes both engines'
metrics and scheduler state; both ranks of engine 0 write their own
profiler trace; rank 0's trace holds engine 1's ``block N`` spans, each
inside its request's ``http`` span; SIGINT drains and every rank exits
0. Then the pieces the cross-rank trace rests on, in one process: the
cursor over the tracer's rings, ``ingest`` and the clock offset."""
import asyncio
import functools
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"
# 12 byte tokens each: three whole chunks of 4, so a handoff carries the
# whole prompt
PROMPTS = [f"Q:{a:02d}+{b:02d}=? A:" for a, b in
           ((12, 34), (56, 11), (7, 42), (99, 1))]
ALIGNED = 12
MAX_TOKENS = 16
UP_S = 180


@functools.lru_cache(maxsize=None)
def _tmp() -> str:
    return tempfile.mkdtemp(prefix="mesh_obs_")


@pytest.fixture(scope="module", autouse=True)
def _cleanup():
    """Every launcher is stopped and its files removed, whatever failed."""
    yield
    if _launchers.cache_info().currsize:
        for srv in _launchers().values():
            srv.stop()
    shutil.rmtree(_tmp(), ignore_errors=True)


def _path(*parts) -> str:
    return os.path.join(_tmp(), *parts)


def _flags() -> dict:
    return {
        # the JAX CLI's pool example on a mesh, every layer on
        "pool": ["--mesh", "2,1", "--pool", "prefill:1,decode:1",
                 "--force-host-devices", "4", "--prefix-cache",
                 "--cache-chunk", "4", "--audit-rate", "1.0", "--flight-dir",
                 _path("flight"), "--trace-dir", _path("trace"),
                 "--profile-blocks", "2"],
        # one engine (no --engines), the host lane, the profile under
        # results/torch/profile
        "single": ["--mesh", "2,1", "--force-host-devices", "2",
                   "--audit-rate", "1.0", "--audit-oracle", "host",
                   "--flight-dir", _path("flight1"), "--profile-blocks",
                   "2"],
        # without --http every rank runs the engine and profiles it
        "synthetic": ["--mesh", "2,1", "--force-host-devices", "2",
                      "--profile-blocks", "2", "--trace-dir",
                      _path("trace2"), "--n", "2"]}


class Launcher:
    """One launcher and its ranks; stdout and stderr go to files."""

    def __init__(self, name: str):
        with socket.socket() as s:
            s.bind((HOST, 0))
            self.port = s.getsockname()[1]
        http = [] if name == "synthetic" else ["--http", str(self.port)]
        self.out = open(_path(f"{name}.out"), "w+")
        self.err = open(_path(f"{name}.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "tiny", "--device", "cpu", "--dtype", "float32", "--ckpt",
             _path("tiny"), "--host-threads-per-engine", "1", "--max-slots",
             "4", "--gen-len", "32", "--window", "16",
             "--metrics-interval-s", "0", *http, *_flags()[name]],
            stdout=self.out, stderr=self.err, cwd=_tmp(),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def logs(self) -> str:
        self.out.seek(0)
        self.err.seek(0)
        return self.out.read() + self.err.read()

    def get(self, path: str):
        with urllib.request.urlopen(f"http://{HOST}:{self.port}{path}",
                                    timeout=30) as r:
            return json.loads(r.read())

    def wait_up(self) -> None:
        t0 = time.monotonic()
        while True:
            try:
                self.get("/healthz")
                return
            except OSError:
                assert self.proc.poll() is None, self.logs()
                assert time.monotonic() - t0 < UP_S, self.logs()
                time.sleep(0.2)

    def finish(self, sigint: bool = True) -> dict:
        """SIGINT (a server) and wait: the exit code, the summary line."""
        if sigint:
            self.proc.send_signal(signal.SIGINT)
        self.proc.wait(timeout=120)
        summary = None
        if self.proc.returncode == 0:
            self.out.seek(0)
            summary = json.loads(self.out.read().strip().splitlines()[-1])
        return {"code": self.proc.returncode, "summary": summary,
                "logs": self.logs()}


@functools.lru_cache(maxsize=None)
def _launchers() -> dict:
    from repro.models import get_config, init_params
    from repro.training import checkpoint
    params = jax.tree.map(np.asarray, init_params(get_config("tiny"),
                                                  jax.random.PRNGKey(3)))
    checkpoint.save(_path("tiny"), params)
    launchers = {name: Launcher(name) for name in _flags()}
    # the JAX references compile while the ranks start
    _jax(True)
    _jax(False)
    return launchers


def _traffic(srv: Launcher) -> dict:
    """Every prompt at once over JSON, then (once the audits are done)
    a manual flight dump, then SIGINT."""
    from repro_torch.server import client as C
    srv.wait_up()

    async def go():
        async def one(p):
            st, _, doc = await C.complete(HOST, srv.port, {
                "prompt": p, "max_tokens": MAX_TOKENS})
            assert st == 200, doc
            return doc
        return await asyncio.gather(*(one(p) for p in PROMPTS))
    docs = asyncio.run(asyncio.wait_for(go(), 240))
    t0 = time.monotonic()
    while True:       # the audit lanes decode in the gaps after traffic
        done = sum(lp.get("audit", {}).get("completed", 0)
                   for lp in srv.get("/debug/vars")["engines"])
        if done >= len(PROMPTS) or time.monotonic() - t0 > 120:
            break
        time.sleep(0.2)
    flight = srv.get("/debug/flight")
    return {"docs": dict(zip(PROMPTS, docs)), "flight": flight,
            **srv.finish()}


@functools.lru_cache(maxsize=None)
def _run(name: str) -> dict:
    srv = _launchers()[name]
    if name == "synthetic":
        return srv.finish(sigint=False)
    return _traffic(srv)


def _summary(name: str) -> dict:
    out = _run(name)
    assert out["code"] == 0 and out["summary"] is not None, \
        out["logs"][-4000:]
    return out["summary"]


@functools.lru_cache(maxsize=None)
def _jax(prefix_cache: bool = True) -> dict:
    """Each prompt served alone by the JAX engine (with the prefix cache
    or not), and a JAX ShadowAuditor over all of them on one engine."""
    from repro.core.decoder import DecodeConfig
    from repro.models import get_config, init_params
    from repro.obs import AuditConfig, ShadowAuditor
    from repro.serving import ContinuousEngine
    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.PRNGKey(3))
    dcfg = DecodeConfig(method="streaming", gen_len=32,
                        block_size=cfg.block_size, window=16,
                        prefix_cache=prefix_cache, cache_chunk=4)
    alone = {}
    for p in PROMPTS:
        eng = ContinuousEngine(cfg, params, dcfg, max_slots=4)
        eng.submit(p, max_tokens=MAX_TOKENS)
        alone[p] = [int(t) for t in eng.run_to_completion()[0].tokens]
    out = {"alone": alone}
    if prefix_cache:
        eng = ContinuousEngine(cfg, params, dcfg, max_slots=4)
        eng.attach_auditor(ShadowAuditor(eng, AuditConfig(sample_rate=1.0)))
        for p in PROMPTS:
            eng.submit(p, max_tokens=MAX_TOKENS)
        eng.run_to_completion()
        eng.drain_audits()
        out["audit"] = eng.auditor.stats()
    return out


@pytest.mark.parametrize("name,prefix_cache", [("pool", True),
                                               ("single", False)])
def test_completions_equal_jax_alone(name, prefix_cache):
    out = _run(name)
    ref = _jax(prefix_cache)["alone"]
    for p, doc in out["docs"].items():
        assert doc["tokens"] == ref[p], p
        assert not doc["cancelled"]


def test_every_handoff_crosses_ranks_with_a_full_hit():
    s = _summary("pool")
    n = len(PROMPTS)
    assert s["handoffs"] == n and s["served_per_engine"] == [0, n]
    # each adopted row found its whole aligned prompt in the decode
    # ranks' stores (a hit is at most the aligned length)
    assert s["handoff_hit_tokens"] == n * ALIGNED
    assert s["handoff_bytes"] > 0
    prefill, decode = s["ops"]
    assert prefill["take_handoffs"] >= 1 and decode["adopt_handoff"] == n


def test_audits_clean_as_the_jax_auditor():
    s = _summary("pool")
    ref = _jax()["audit"]
    assert ref["completed"] == len(PROMPTS)
    assert sum(ref["divergences"].values()) == 0
    got = s["audit"]                       # one record an engine
    assert sum(a["completed"] for a in got) == ref["completed"]
    assert all(sum(a["divergences"].values()) == 0 and a["errors"] == 0
               for a in got)


def test_one_engine_audits_and_dumps():
    s = _summary("single")
    assert s["engines"] == 1 and s["ranks"] == 2
    assert s["audit"]["completed"] == len(PROMPTS)
    assert sum(s["audit"]["divergences"].values()) == 0
    with open(os.path.join(_run("single")["flight"]["path"],
                           "metrics.json")) as f:
        (engine,) = json.load(f)["engines"]
    assert engine["metrics"]["requests"] == len(PROMPTS)
    assert engine["audit"]["completed"] == len(PROMPTS)


def test_manual_flight_dump_holds_both_engines():
    path = _run("pool")["flight"]["path"]
    with open(os.path.join(path, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(path, "state.json")) as f:
        state = json.load(f)
    assert len(metrics["engines"]) == 2 and len(state["schedulers"]) == 2
    prefill, decode = metrics["engines"]
    assert prefill["metrics"]["handoffs_out"] == len(PROMPTS)
    assert decode["metrics"]["requests"] == len(PROMPTS)
    assert decode["audit"]["completed"] == len(PROMPTS)
    assert decode["telemetry"]["blocks"] > 0
    assert state["schedulers"][0]["prefill_only"]
    assert [lp["role"] for lp in state["loops"]] == ["prefill", "decode"]


@pytest.mark.parametrize("name,where", [
    ("pool", ("trace",)), ("single", ("results", "torch", "profile")),
    ("synthetic", ("trace2",))])
def test_each_rank_of_engine_0_writes_its_profile(name, where):
    _summary(name)
    for r in (0, 1):
        path = _path(*where, "torch_profile", f"rank{r}", "trace.json")
        with open(path) as f:
            assert json.load(f)["traceEvents"], path
    # engine 1's ranks (the pool's decode engine) open none
    assert sorted(os.listdir(_path(*where, "torch_profile"))) == [
        "rank0", "rank1"]


def test_rank0_trace_holds_engine1_spans_inside_http():
    _summary("pool")
    with open(_path("trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    pid = next(e["pid"] for e in events if e.get("ph") == "M"
               and e["name"] == "process_name"
               and e["args"]["name"] == "engine-1")
    http = {}
    for e in events:
        if e.get("name") == "http" and e.get("ph") in ("b", "e"):
            http.setdefault(e["id"], {})[e["ph"]] = e["ts"]
    blocks = [e for e in events if e.get("pid") == pid
              and e.get("ph") in ("b", "e")
              and str(e.get("name", "")).startswith("block ")]
    assert {e["id"] for e in blocks} == set(http) and len(http) == len(
        PROMPTS)
    for e in blocks:
        assert http[e["id"]]["b"] <= e["ts"] <= http[e["id"]]["e"], e
    from repro_torch.obs.trace import request_tree
    for tid in http:
        names = [n for n, *_ in request_tree(
            [e for e in events if e.get("id") == tid])]
        assert names[0] == "http" and "block 0" in names


def test_sigint_drains_every_rank_at_zero():
    s = _summary("pool")
    assert s["ranks"] == 4 and s["engines"] == 2
    assert s["mesh"] == {"data": 2, "model": 1}
    assert s["served"] == len(PROMPTS)
    assert all(ops["stop"] == 1 for ops in s["ops"])


# ------------------------------------------------------------ one process

def test_cursor_takes_each_event_once_and_ingest_shifts_it():
    import threading
    from repro_torch.obs.trace import TraceCursor, Tracer
    src, dst = Tracer(capacity_per_thread=4), Tracer()
    cur = TraceCursor(src)
    assert cur.take() == []
    src.instant("a")
    t = threading.Thread(target=lambda: src.instant("b"))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [e["name"] for e in cur.take()] == ["a", "b"]
    for i in range(6):                 # the ring wraps past the mark
        src.instant(f"c{i}")
    got = cur.take()
    assert [e["name"] for e in got] == ["c2", "c3", "c4", "c5"]
    assert cur.take() == []
    dst.ingest(got, pid=7, shift_us=1000.0)
    ingested = [e for e in dst.events() if e.get("ph") == "i"]
    assert [e["pid"] for e in ingested] == [7] * 4
    assert [e["ts"] for e in ingested] == [e["ts"] + 1000.0 for e in got]


def test_clock_offset_is_zero_inside_the_round_trip():
    from repro_torch.serving.replica import clock_offset
    assert clock_offset(100, 150, 200) == 0
    assert clock_offset(100, 100, 100) == 0
    assert clock_offset(100, 5000, 200) == 4850
    assert clock_offset(100, -50, 200) == -200
