"""The port's HTTP front end (``repro_torch.server``) over real loopback
sockets, mirroring ``tests/test_server.py`` inside the port: round-trip
identity with the in-process engine, SSE chunk ordering, bounded
admission (429), deadline expiry → partial completion, client
disconnect → slot release without disturbing concurrent requests, and
graceful drain shutdown; then the prefix cache's ``/metrics`` series
(``tests/test_cache.py::test_metrics_endpoint_exposes_cache_series``).
Everything runs on ``tiny`` on the CPU with the port's own seeded
weights and the stdlib-only loopback client. The multi-engine tests
build the router with ``steal=False``, as the reference's do; stealing
and the prefill/decode pools are ``tests/test_torch_steal.py`` and
``tests/test_torch_disagg.py``. The port's front end against the JAX
package's is ``tests/test_torch_server_jax.py``."""
import asyncio
import contextlib
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.core.decoder import DecodeConfig
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_config, init_params
from repro_torch.server import EngineLoop, HttpFrontend, ServerRequest
from repro_torch.server import client as C
from repro_torch.server.types import BadRequest
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
TOK = ByteTokenizer(CFG.vocab_size)
PROMPT = "Q:12+34=? A:"
PROMPT_B = "Q:56+11=? A:"          # same length -> same shape bucket
TEST_TIMEOUT_S = 240


def _dcfg(gen_len=16):
    return DecodeConfig(method="streaming", gen_len=gen_len, block_size=8,
                        window=8, early_exit=False)


def _engine(gen_len=16, max_slots=4):
    return ContinuousEngine(CFG, PARAMS, _dcfg(gen_len),
                            max_slots=max_slots, tokenizer=TOK, device="cpu")


_REF = {}


def _reference(prompt, max_tokens, gen_len):
    """In-process ContinuousEngine.run_to_completion() ground truth."""
    key = (prompt, max_tokens, gen_len)
    if key not in _REF:
        eng = _engine(gen_len)
        eng.submit(prompt, max_tokens=max_tokens)
        _REF[key] = eng.run_to_completion()[0]
    return _REF[key]


@contextlib.asynccontextmanager
async def _server(gen_len=16, max_slots=4, max_pending=16):
    eng = _engine(gen_len, max_slots)
    loop = EngineLoop(eng, max_pending=max_pending, idle_poll_s=0.005)
    frontend = await HttpFrontend(loop, port=0).start()
    try:
        yield frontend, eng
    finally:
        await frontend.shutdown(drain=False, timeout_s=30)


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, TEST_TIMEOUT_S))


async def _await_idle(eng, loop, timeout_s=60.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if eng.scheduler.idle and loop.inflight == 0:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("engine did not return to idle")


# ------------------------------------------------------------ round trip


def test_http_roundtrip_matches_engine():
    """Acceptance: the HTTP JSON response carries exactly the tokens the
    in-process engine produces for the same prompt/config."""
    ref = _reference(PROMPT, 13, 16)

    async def main():
        async with _server() as (fe, eng):
            status, _, doc = await C.complete(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 13})
            assert status == 200
            assert doc["text"] == ref.text
            assert doc["n_tokens"] == ref.n_tokens == 13
            assert doc["max_tokens"] == 13          # never over-returns
            assert doc["finish_reason"] in ("stop", "length")
            assert not doc["cancelled"]
    _run(main())


def test_sse_stream_ordering_and_identity():
    """Acceptance: SSE chunks arrive in block order and their joined
    text equals the in-process Completion text; the stream ends with a
    summary event and the [DONE] sentinel."""
    ref = _reference(PROMPT, 13, 16)

    async def main():
        async with _server() as (fe, eng):
            stream = await C.SSEStream.open(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 13})
            assert stream.status == 200
            events = [e async for e in stream.events()]
            await stream.close()
            blocks = [e for e in events if "block" in e]
            finals = [e for e in events if "finish_reason" in e]
            assert [b["block"] for b in blocks] == \
                list(range(len(blocks)))            # ordered, gapless
            assert blocks[-1]["finished"]
            assert len(finals) == 1
            joined = "".join(b["text"] for b in blocks)
            assert joined == ref.text == finals[0]["text"]
    _run(main())


# ------------------------------------------------------------ admission


def test_429_on_full_admission_queue():
    async def main():
        async with _server(gen_len=32, max_pending=1) as (fe, eng):
            stream = await C.SSEStream.open(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 32})
            # the stream's ticket is in flight -> the queue (depth 1)
            # is full and the next request must bounce with Retry-After
            status, headers, doc = await C.complete(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 8})
            assert status == 429
            assert int(headers["retry-after"]) >= 1
            assert "error" in doc
            async for _ in stream.events():
                pass
            await stream.close()
            await _await_idle(eng, fe.loop)
            assert eng.metrics.admission_rejects == 1
    _run(main())


def test_bad_requests_are_400():
    async def main():
        async with _server() as (fe, eng):
            for payload in ({}, {"prompt": 7}, {"prompt": ""},
                            {"prompt": "x", "max_tokens": 0},
                            {"prompt": "x", "bogus": 1},
                            {"prompt": "x", "timeout_s": -1}):
                status, _, doc = await C.complete(fe.host, fe.port, payload)
                assert status == 400, payload
                assert "error" in doc
            status, _, body = await C.request(fe.host, fe.port, "GET",
                                              "/nope")
            assert status == 404
            status, _, body = await C.request(fe.host, fe.port, "GET",
                                              "/v1/completions")
            assert status == 405
    _run(main())


# ------------------------------------------------------------ lifecycle


def test_deadline_returns_partial_completion():
    """timeout_s expiry cancels at a block boundary: the response is a
    partial completion marked finish_reason=deadline, and the engine
    counts the miss."""
    async def main():
        async with _server(gen_len=64) as (fe, eng):
            status, _, doc = await C.complete(
                fe.host, fe.port,
                {"prompt": PROMPT, "max_tokens": 64, "timeout_s": 0.03})
            assert status == 200
            assert doc["cancelled"]
            assert doc["finish_reason"] == "deadline"
            assert doc["n_tokens"] < 64
            await _await_idle(eng, fe.loop)
            assert eng.metrics.deadline_misses == 1
            assert eng.metrics.cancelled == 1
    _run(main())


def test_disconnect_mid_stream_releases_slot():
    """Acceptance: a client that vanishes mid-stream frees its decode
    slot (engine returns to idle) and concurrent requests' tokens are
    untouched (bit-identical to a solo run)."""
    ref_b = _reference(PROMPT_B, 32, 32)

    async def main():
        async with _server(gen_len=32) as (fe, eng):
            sa = await C.SSEStream.open(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 32})
            sb = await C.SSEStream.open(
                fe.host, fe.port, {"prompt": PROMPT_B, "max_tokens": 32})
            events_b = []
            it_b = sb.events()
            events_b.append(await it_b.__anext__())   # both streams live
            sa.abort()                                # client A vanishes
            async for e in it_b:
                events_b.append(e)
            await sb.close()
            finals = [e for e in events_b if "finish_reason" in e]
            assert len(finals) == 1
            assert not finals[0]["cancelled"]
            assert finals[0]["text"] == ref_b.text    # B undisturbed
            await _await_idle(eng, fe.loop)           # A's slot released
            assert eng.metrics.cancelled == 1
    _run(main())


def test_graceful_drain_completes_inflight():
    """shutdown(drain=True) closes the listener but lets the in-flight
    request finish with a full (non-cancelled) response."""
    async def main():
        eng = _engine(gen_len=32)
        frontend = await HttpFrontend(
            EngineLoop(eng, max_pending=4, idle_poll_s=0.005),
            port=0).start()
        task = asyncio.create_task(C.complete(
            frontend.host, frontend.port,
            {"prompt": PROMPT, "max_tokens": 32}))
        while not (frontend.loop.inflight or task.done()):
            await asyncio.sleep(0.005)                # admitted
        await frontend.shutdown(drain=True, timeout_s=60)
        status, _, doc = await task
        assert status == 200
        assert not doc["cancelled"]
        assert doc["n_tokens"] > 0
        assert eng.scheduler.idle
    _run(main())


# ------------------------------------------------------------ observability


def test_healthz_and_metrics():
    async def main():
        async with _server() as (fe, eng):
            status, _, body = await C.request(fe.host, fe.port, "GET",
                                              "/healthz")
            assert status == 200
            health = json.loads(body)
            assert health["status"] == "ok" and health["idle"]
            st, _, doc = await C.complete(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 8})
            assert st == 200
            status, _, body = await C.request(fe.host, fe.port, "GET",
                                              "/metrics")
            assert status == 200
            text = body.decode()
            assert "repro_requests_total 1" in text
            for metric in ("repro_admission_rejects_total",
                           "repro_cancelled_total",
                           "repro_deadline_misses_total",
                           "repro_queue_depth",
                           'repro_latency_seconds{quantile="0.99"}'):
                assert metric in text, metric
    _run(main())


def test_keepalive_serves_many_requests_per_socket():
    """HTTP/1.1 keep-alive: a ClientSession issues several completions
    (and a /metrics scrape) over ONE TCP connection, each response
    matches the per-connection path bit for bit, and an explicit
    Connection: close still closes."""
    ref = _reference(PROMPT, 13, 16)
    ref_b = _reference(PROMPT_B, 13, 16)

    async def main():
        async with _server() as (fe, eng):
            sess = C.ClientSession(fe.host, fe.port)
            for expect in (ref, ref_b, ref):
                status, headers, doc = await sess.complete(
                    {"prompt": PROMPT if expect is not ref_b else PROMPT_B,
                     "max_tokens": 13})
                assert status == 200
                assert headers["connection"] == "keep-alive"
                assert doc["text"] == expect.text
            status, _, body = await sess.request("GET", "/metrics")
            assert status == 200
            assert b"repro_requests_total" in body
            assert sess.connects == 1, "all exchanges must share a socket"
            assert sess.requests == 4
            await sess.close()
            # legacy one-shot path still gets Connection: close
            status, headers, _ = await C.complete(
                fe.host, fe.port, {"prompt": PROMPT, "max_tokens": 13})
            assert status == 200
            assert headers["connection"] == "close"
    _run(main())


def test_keepalive_session_survives_server_side_close():
    """A stale keep-alive socket (server idle-timeout closed it) must
    reconnect transparently on the next request."""
    async def main():
        async with _server() as (fe, eng):
            fe.request_timeout_s = 0.2        # aggressive idle timeout
            sess = C.ClientSession(fe.host, fe.port)
            st, _, doc = await sess.complete(
                {"prompt": PROMPT, "max_tokens": 8})
            assert st == 200
            await asyncio.sleep(0.6)          # server times the socket out
            st, _, doc = await sess.complete(
                {"prompt": PROMPT, "max_tokens": 8})
            assert st == 200
            assert sess.connects == 2         # exactly one reconnect
            await sess.close()
    _run(main())


# ------------------------------------------------------------ validation


def test_server_request_validation_unit():
    ok = ServerRequest.from_json(
        {"prompt": "x", "max_tokens": 3, "stream": True,
         "timeout_s": 2, "priority": 5})
    assert (ok.max_tokens, ok.stream, ok.timeout_s, ok.priority) == \
        (3, True, 2.0, 5)
    for bad in ([], {"prompt": "x", "max_tokens": True},
                {"prompt": "x", "stream": "yes"},
                {"prompt": "x", "priority": 1.5},
                {"prompt": "x" * (ServerRequest.PROMPT_CAP + 1)}):
        with pytest.raises(BadRequest):
            ServerRequest.from_json(bad)


# ------------------------------------------------------------ multi-engine


def test_two_engine_loops_behind_one_frontend():
    """Acceptance: two EngineLoops (independent engines/schedulers)
    behind one HttpFrontend serve a concurrent loopback workload with
    correct per-request results, spread across both engines, and
    /metrics aggregates with per-engine labels."""
    from repro_torch.server import EngineRouter

    async def main():
        engines = [_engine(), _engine()]
        router = EngineRouter([
            EngineLoop(e, max_pending=16, idle_poll_s=0.005)
            for e in engines], steal=False)
        frontend = await HttpFrontend(router, port=0).start()
        try:
            ref = _reference(PROMPT, 8, 16)
            n = 6
            results = await asyncio.gather(*[
                C.complete(frontend.host, frontend.port,
                           {"prompt": PROMPT, "max_tokens": 8})
                for _ in range(n)])
            for status, _, doc in results:
                assert status == 200
                assert doc["text"] == ref.text, "routed result diverged"
                assert doc["finish_reason"] in ("stop", "length")
            served = [len(e.metrics.requests) for e in engines]
            assert sum(served) == n
            assert all(s > 0 for s in served), \
                f"least-loaded routing left an engine idle: {served}"
            # one SSE stream through the router for good measure
            stream = await C.SSEStream.open(
                frontend.host, frontend.port,
                {"prompt": PROMPT, "max_tokens": 8})
            events = [ev async for ev in stream.events()]
            await stream.close()
            assert events[-1]["text"] == ref.text
            status, _, body = await C.request(
                frontend.host, frontend.port, "GET", "/metrics")
            assert status == 200
            text = body.decode()
            assert f"repro_requests_total {n + 1}" in text
            assert "repro_engines 2" in text
            assert 'repro_engine_requests_total{engine="0"}' in text
            assert 'repro_engine_requests_total{engine="1"}' in text
            assert 'repro_latency_seconds{quantile="0.99"}' in text
            status, _, body = await C.request(
                frontend.host, frontend.port, "GET", "/healthz")
            health = json.loads(body)
            assert health["engines"] == 2 and health["idle"]
        finally:
            await frontend.shutdown(drain=False, timeout_s=30)

    _run(main())


def test_router_falls_back_when_one_engine_full():
    """A loop whose bounded budget is exhausted must not turn traffic
    away while its peer has room: the router tries engines in load
    order and only 429s when every engine rejects."""
    from repro_torch.server import EngineRouter
    from repro_torch.server.types import AdmissionRejected

    def deliver(_):
        pass

    engines = [_engine(), _engine()]
    loops = [EngineLoop(e, max_pending=1, idle_poll_s=0.005)
             for e in engines]
    router = EngineRouter(loops, steal=False)  # NOT started: nothing drains
    try:
        tickets = [router.submit(ServerRequest(prompt=PROMPT), deliver)
                   for _ in range(2)]
        assert {t.loop for t in tickets} == set(loops), \
            "second submit must spill to the other engine"
        # a spill that got served is not a 429: no reject counted yet
        assert sum(e.metrics.admission_rejects for e in engines) == 0
        with pytest.raises(AdmissionRejected):
            router.submit(ServerRequest(prompt=PROMPT), deliver)
        # ...while a full-fleet rejection counts exactly once
        assert sum(e.metrics.admission_rejects for e in engines) == 1
    finally:
        router.close(drain=False, timeout_s=5)


# ------------------------------------------------------------ prefix cache


def test_metrics_endpoint_exposes_cache_series():
    """The prefix cache's five ``/metrics`` series, filled by the engine
    (``tests/test_cache.py::test_metrics_endpoint_exposes_cache_series``:
    a 20-token prompt decoded twice hits its two 8-token chunks)."""
    from repro_torch.cache import PrefixKVCache, device_placement
    prompt = np.random.default_rng(7).integers(0, 200, 20).astype(np.int32)
    d = DecodeConfig(method="streaming", gen_len=16, block_size=8, window=8,
                     prefix_cache=True, cache_chunk=8)
    eng = ContinuousEngine(CFG, PARAMS, d, max_slots=4, tokenizer=TOK,
                           device="cpu", prefix_cache=PrefixKVCache(
                               chunk_tokens=8,
                               placement=device_placement("cpu")))
    eng.submit(prompt, max_tokens=16)
    eng.run_to_completion()
    eng.submit(prompt, max_tokens=16)
    eng.run_to_completion()
    text = HttpFrontend(EngineLoop(eng))._metrics_text()
    assert "repro_prefix_cache_hits_total 1" in text
    assert "repro_prefix_cache_hit_tokens_total 16" in text
    assert "repro_prefix_cache_evictions_total 0" in text
    assert "repro_prefix_cache_bytes" in text
    assert "repro_prefix_cache_chunks" in text
    # the persistent compilation-cache series keep their contract at 0
    assert "repro_persistent_cache_hits_total 0" in text
    assert "repro_persistent_cache_misses_total 0" in text


# ------------------------------------------------------------ CLI


def _cli_http_roundtrip(tmp_path, extra):
    """Start ``python -m repro_torch.launch.serve --http PORT`` on the
    CPU with ``extra`` flags, wait for ``/healthz``, complete one request
    over loopback, SIGINT, and return the summary line."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tiny",
         "--device", "cpu", "--dtype", "float32", "--train-steps", "0",
         "--http", str(port), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp_path)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() - t0 < 120, "server never came up"
                time.sleep(0.1)
        assert health["status"] == "ok" and health["idle"]
        req = urllib.request.Request(
            url + "/v1/completions", headers={"Content-Type":
                                              "application/json"},
            data=json.dumps({"prompt": PROMPT, "max_tokens": 8}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["n_tokens"] == 8 and not doc["cancelled"]
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1]), health, port


def test_cli_http_answers_then_drains_on_sigint(tmp_path):
    """``python -m repro_torch.launch.serve --http PORT`` on the CPU:
    answers ``/healthz`` and a completion over loopback, then drains on
    SIGINT and prints its summary line (exit code 0); ``--trace-flush-s``
    rewrote the trace while it served."""
    summary, _, port = _cli_http_roundtrip(
        tmp_path, ["--trace-dir", str(tmp_path), "--trace-flush-s", "0.1",
                   "--log-level", "warning"])
    assert summary["http"] == port and summary["served"] == 1
    assert (tmp_path / "trace.json").exists()
    assert summary["trace_flushes"] >= 1


@pytest.mark.parametrize("flags,engines,handoffs", [
    (["--engines", "2", "--host-threads-per-engine", "1"], 2, 0),
    (["--prefix-cache", "--cache-chunk", "4", "--pool",
      "prefill:1,decode:1"], 2, 1)], ids=["engines", "pool"])
def test_cli_fleet_answers_then_drains_on_sigint(tmp_path, flags, engines,
                                                 handoffs):
    """``--engines 2`` and ``--pool prefill:1,decode:1`` serve a fleet
    behind one front end: one completion over loopback, a clean drain,
    and a summary that sums the engines (a pool request is primed on
    the prefill engine and handed to the decode engine)."""
    summary, health, _ = _cli_http_roundtrip(tmp_path, flags)
    assert health["engines"] == engines
    assert summary["engines"] == engines and summary["served"] == 1
    assert summary["handoffs"] == handoffs
    assert summary["post_warm_captures"] == 0


@pytest.mark.parametrize("argv,err", [
    (["--engines", "2"], "needs --http"),
    (["--pool", "prefill:1,decode:1", "--http", "1"], "needs --prefix-cache"),
    (["--pool", "prefill:1,decode:1"], "needs --http"),
    (["--pool", "prefill:1", "--http", "1", "--prefix-cache"],
     "at least one decode"),
    (["--pool", "decode:2", "--http", "1", "--prefix-cache"],
     "without a prefill"),
    (["--pool", "prefill:1,decode:1", "--engines", "3", "--http", "1",
      "--prefix-cache"], "implies --engines 2"),
    (["--trace-flush-s", "1", "--http", "1"], "needs --trace-dir"),
    (["--trace-flush-s", "1", "--trace-dir", "t"], "needs --http")])
def test_cli_fleet_flags_are_validated(argv, err):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=err):
        serve.main(["--device", "cpu", *argv])


def test_cli_mesh_flags_name_a11():
    """The mesh flags (ROADMAP A11, ported) are validated before any
    weights are made: the rank count is engines x data x model (a pool's
    engines counted), ``--pool`` needs ``--http`` and ``--prefix-cache``
    on a mesh too, and the serving layers of A11.2 pass with ``--mesh``;
    ``tests/test_torch_sharded_decode.py``,
    ``tests/test_torch_mesh_http.py`` and ``tests/test_torch_mesh_obs.py``
    serve through them on CPU ranks."""
    from repro_torch.launch import serve
    for argv, err in ((["--force-host-devices", "4"], "pass --mesh"),
                      (["--mesh", "2"], "data,model"),
                      (["--mesh", "2,1", "--engines", "2",
                        "--force-host-devices", "2"], "needs 4 ranks"),
                      (["--mesh", "1,1", "--pool", "prefill:1,decode:1",
                        "--http", "1", "--prefix-cache"], "needs 2 ranks"),
                      (["--mesh", "1,1", "--pool", "prefill:1,decode:1",
                        "--prefix-cache"], "needs --http"),
                      (["--mesh", "1,1", "--pool", "prefill:1,decode:1",
                        "--http", "1"], "needs --prefix-cache"),
                      (["--mesh", "2,1", "--force-host-devices", "1"],
                       "needs 2 ranks"),
                      (["--mesh", "2,1", "--mode", "batch"],
                       "continuous engine")):
        with pytest.raises(SystemExit, match=err):
            serve.main(["--device", "cpu", *argv])
    passing = [serve.parse_args(["--device", "cpu", *argv]) for argv in (
        ["--mesh", "1,1", "--pool", "prefill:1,decode:1", "--http", "1",
         "--prefix-cache", "--force-host-devices", "2"],
        ["--mesh", "1,1", "--audit-rate", "0.5", "--http", "1",
         "--flight-dir", "d", "--profile-blocks", "2"])]
    for args in passing:
        serve.check_args(args)
    assert [a.engines for a in passing] == [2, 1]
