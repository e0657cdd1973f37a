"""``python -m repro_torch.launch.serve --mesh ... --http`` on gloo CPU
ranks, against the JAX package's engine on the same weights.

The weights are the JAX package's ``init_params(get_config("tiny"),
PRNGKey(3))``, written by ``repro.training.checkpoint.save`` and served
through ``--ckpt``. Two launchers start at once, each with its ranks
(``--force-host-devices``): ``fleet`` is the JAX CLI's own example,
``--mesh 2,1 --engines 2`` on four ranks (two data-sharded engines
behind the router), and ``cached`` is ``--mesh 2,1`` on two ranks with
``--prefix-cache --cache-chunk 4``. The other flags that the JAX CLI
takes with ``--mesh`` ride along on one or the other (the host budget,
admission bound, tracing with periodic flushes, the recorder, the SLO
watchdog, logging, prewarm, padding, the host loop, ``--no-steal``).

Held, over loopback: six prompts at once, each as JSON and as SSE; every
completion's token ids equal the JAX ``ContinuousEngine`` serving that
prompt alone in float32 (with the same prefix-cache setting); the
streamed completion's text equals the JSON one's, after one chunk a
block. ``fleet``: ``/healthz`` reports two
engines and both serve; a cancel mid-stream and a deadline reach the
engines' ranks (their ``cancel`` ops are replayed; a follower that
diverged would end the run) and a later request stays exact; SIGINT
drains and every rank exits 0, with ``ranks: 4, engines: 2`` in the
summary and a trace flushed. ``cached``: a repeated prompt is served
with prefix-cache hits and still exact; killing a follower ends the
launcher non-zero within 60 s."""
import asyncio
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import shutil

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"
PROMPTS = [f"Q:{a:02d}+{b:02d}=? A:" for a, b in
           ((12, 34), (56, 11), (7, 42), (99, 1), (31, 13), (45, 67))]
MAX_TOKENS = 16
UP_S = 180
BASE = ["--arch", "tiny", "--device", "cpu", "--dtype", "float32",
        "--host-threads-per-engine", "1", "--max-slots", "4"]


@functools.lru_cache(maxsize=None)
def _tmp() -> str:
    return tempfile.mkdtemp(prefix="mesh_http_")


@pytest.fixture(scope="module", autouse=True)
def _stop_servers():
    """Every launcher this file started is stopped, whatever failed."""
    yield
    if _servers.cache_info().currsize:
        for srv in _servers().values():
            srv.stop()
        shutil.rmtree(_tmp(), ignore_errors=True)


def _configs() -> dict:
    t = _tmp()
    return {
        "fleet": ["--mesh", "2,1", "--engines", "2", "--force-host-devices",
                  "4", "--trace-dir", os.path.join(t, "trace"),
                  "--trace-flush-s", "0.2", "--metrics-interval-s", "0.1",
                  "--slo-ttfb-p50-ms", "60000", "--slo-token-latency-ms",
                  "60000", "--max-pending", "32", "--log-json"],
        "cached": ["--mesh", "2,1", "--force-host-devices", "2",
                   "--prefix-cache", "--cache-chunk", "4", "--cache-bytes",
                   str(1 << 24), "--prewarm", "12:16", "--pad-pow2",
                   "--no-steal", "--host-loop", "--log-level", "warning",
                   "--metrics-log", os.path.join(t, "series.jsonl"),
                   # the decode settings the reference mirrors, spelled out
                   "--method", "streaming", "--gen-len", "32", "--window",
                   "16", "--tau0", "0.9", "--alpha", "0.3", "--use-kernels",
                   "--http-host", HOST]}


class Server:
    """One launcher and its ranks; stdout and stderr go to files."""

    def __init__(self, name: str):
        with socket.socket() as s:
            s.bind((HOST, 0))
            self.port = s.getsockname()[1]
        self.out = open(os.path.join(_tmp(), f"{name}.out"), "w+")
        self.err = open(os.path.join(_tmp(), f"{name}.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *BASE,
             "--ckpt", os.path.join(_tmp(), "tiny"), "--http",
             str(self.port), *_configs()[name]],
            stdout=self.out, stderr=self.err, cwd=_tmp(),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        self.health = None

    def stop(self) -> None:
        """SIGTERM: the launcher stops its ranks on the way out."""
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

    def wait_up(self) -> dict:
        t0 = time.monotonic()
        while self.health is None:
            try:
                with urllib.request.urlopen(
                        f"http://{HOST}:{self.port}/healthz",
                        timeout=5) as r:
                    self.health = json.loads(r.read())
            except OSError:
                assert self.proc.poll() is None, self.logs()
                assert time.monotonic() - t0 < UP_S, self.logs()
                time.sleep(0.2)
        return self.health

    def pid_of(self, rank: int) -> int:
        for line in self.logs().splitlines():
            if line.startswith(f"rank {rank} of "):
                return int(line.rsplit(" ", 1)[1])
        raise AssertionError(self.logs())

    def summary(self) -> dict:
        self.out.seek(0)
        return json.loads(self.out.read().strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _servers() -> dict:
    from repro.models import get_config, init_params
    from repro.training import checkpoint
    params = jax.tree.map(np.asarray, init_params(get_config("tiny"),
                                                  jax.random.PRNGKey(3)))
    checkpoint.save(os.path.join(_tmp(), "tiny"), params)
    return {name: Server(name) for name in ("fleet", "cached")}


@functools.lru_cache(maxsize=None)
def _reference(prefix_cache: bool) -> dict:
    """Each prompt served alone by the JAX package's engine, with the
    serve CLI's decode settings."""
    from repro.core.decoder import DecodeConfig
    from repro.models import get_config, init_params
    from repro.serving import ContinuousEngine
    cfg = get_config("tiny")
    params = init_params(cfg, jax.random.PRNGKey(3))
    dcfg = DecodeConfig(method="streaming", gen_len=32,
                        block_size=cfg.block_size, window=16, tau0=0.9,
                        alpha=0.3, prefix_cache=prefix_cache, cache_chunk=4)
    out = {}
    for p in PROMPTS:
        eng = ContinuousEngine(cfg, params, dcfg, max_slots=4)
        eng.submit(p, max_tokens=MAX_TOKENS)
        out[p] = [int(t) for t in eng.run_to_completion()[0].tokens]
    return out


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 240))


async def _both_ways(port: int, prompts) -> dict:
    """Every prompt as JSON and as SSE, all at once: {prompt: (json doc,
    final SSE event, the SSE chunks' block indices)}."""
    from repro_torch.server import client as C

    async def as_json(p):
        st, _, doc = await C.complete(HOST, port, {"prompt": p,
                                                   "max_tokens": MAX_TOKENS})
        assert st == 200, doc
        return doc

    async def as_sse(p):
        stream = await C.SSEStream.open(HOST, port, {
            "prompt": p, "max_tokens": MAX_TOKENS})
        events = [e async for e in stream.events()]
        await stream.close()
        return events[-1], [e["block"] for e in events[:-1]]
    docs = await asyncio.gather(*(as_json(p) for p in prompts),
                                *(as_sse(p) for p in prompts))
    n = len(prompts)
    return {p: (docs[i], *docs[n + i]) for i, p in enumerate(prompts)}


def _assert_exact(got: dict, ref: dict) -> None:
    for p, (doc, final, blocks) in got.items():
        assert doc["tokens"] == ref[p], p
        assert final["tokens"] == ref[p], p
        # (a chunk's text is its own bytes decoded: a character split
        # over two blocks reads differently joined, so text is held
        # between the two whole completions)
        assert final["text"] == doc["text"], p
        assert blocks == list(range(final["n_blocks"])), p
        assert not doc["cancelled"] and not final["cancelled"]


@functools.lru_cache(maxsize=None)
def _fleet_traffic() -> dict:
    srv = _servers()["fleet"]
    health = srv.wait_up()

    async def go():
        from repro_torch.server import client as C
        out = {"exact": await _both_ways(srv.port, PROMPTS)}
        # a cancel mid-stream: drop the stream after its first block
        stream = await C.SSEStream.open(HOST, srv.port, {
            "prompt": PROMPTS[0], "max_tokens": 256})
        async for first in stream.events():
            break
        stream.abort()
        out["first_chunk"] = first
        # a deadline inside the decode
        st, _, out["deadline"] = await C.complete(HOST, srv.port, {
            "prompt": PROMPTS[1], "max_tokens": 256, "timeout_s": 2.0})
        assert st == 200
        await asyncio.sleep(0.5)
        out["after"] = await _both_ways(srv.port, PROMPTS[2:4])
        st, _, body = await C.request(HOST, srv.port, "GET", "/metrics")
        out["metrics"] = body.decode()
        return out
    out = _run(go())
    out["health"] = health
    srv.proc.send_signal(signal.SIGINT)
    srv.proc.wait(timeout=120)
    out["code"] = srv.proc.returncode
    out["logs"] = srv.logs()
    out["summary"] = srv.summary() if srv.proc.returncode == 0 else None
    return out


def test_fleet_completions_equal_jax_alone():
    out = _fleet_traffic()
    _assert_exact(out["exact"], _reference(False))
    assert out["health"]["engines"] == 2 and out["health"]["idle"]


def test_fleet_cancel_and_deadline_reach_the_ranks():
    out = _fleet_traffic()
    assert out["first_chunk"]["block"] == 0
    assert out["deadline"]["cancelled"]
    assert out["deadline"]["finish_reason"] == "deadline"
    _assert_exact(out["after"], _reference(False))
    s = out["summary"]
    assert s is not None, out["logs"][-4000:]
    assert s["cancelled"] >= 2 and s["deadline_misses"] == 1
    # both cancels were ops replayed on their engine's ranks
    assert sum(ops.get("cancel", 0) for ops in s["ops"]) >= 2
    assert "repro_cancelled_total" in out["metrics"]


def test_fleet_drains_on_sigint_with_every_rank_at_zero():
    out = _fleet_traffic()
    assert out["code"] == 0, out["logs"][-4000:]
    s = out["summary"]
    assert s["ranks"] == 4 and s["engines"] == 2
    assert s["mesh"] == {"data": 2, "model": 1}
    assert all(n > 0 for n in s["served_per_engine"]), s
    assert s["served"] == 2 * len(PROMPTS) + 2 + 4
    assert s["trace_flushes"] >= 1
    assert os.path.exists(os.path.join(_tmp(), "trace", "trace.json"))
    assert all(ops["stop"] == 1 for ops in s["ops"])


def test_cached_mesh_reuses_prefixes_exactly():
    srv = _servers()["cached"]
    srv.wait_up()

    async def go():
        first = await _both_ways(srv.port, PROMPTS)
        again = await _both_ways(srv.port, PROMPTS[:1])
        return first, again
    first, again = _run(go())
    ref = _reference(True)
    _assert_exact(first, ref)
    _assert_exact(again, ref)
    doc, final, _ = again[PROMPTS[0]]
    assert doc["cache_hit_tokens"] > 0 and final["cache_hit_tokens"] > 0
    assert os.path.getsize(os.path.join(_tmp(), "series.jsonl")) > 0


def test_killing_a_follower_ends_the_launcher_within_60s():
    srv = _servers()["cached"]
    srv.wait_up()
    t0 = time.monotonic()
    os.kill(srv.pid_of(1), signal.SIGKILL)
    try:
        code = srv.proc.wait(timeout=60)
    finally:
        srv.stop()
    assert code != 0 and time.monotonic() - t0 < 60
    assert "rank 1 of 2 exited with -9" in srv.logs()
