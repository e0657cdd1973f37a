"""The port's HTTP front end against the JAX package's, at ``tiny`` on the
CPU with the same weights (JAX ``PRNGKey(3)``, carried across by
``repro_torch.bridge.params_from_jax``): each side wires its own
``EngineLoop`` + ``HttpFrontend`` with a tracer, a ``MetricsRecorder``,
an ``SLOWatchdog`` and a ``ShadowAuditor`` at rate 1.0 (the package's
own ``http._front``), and serves the same requests over loopback, one
at a time: JSON and SSE completions of two prompts. Held equal: the
completions' text and token ids (streamed and not), the audit counters,
the keys of ``/healthz`` and ``/debug/vars`` (the port's scheduler
reports ``graph_cache_size`` where the JAX one reports
``jit_cache_size``, and its auditor ``lane_graphs`` besides), and the
metric families of ``/metrics``."""
import asyncio
import functools
import importlib
import json

import jax
import numpy as np
import torch

torch.set_num_threads(1)

PROMPTS = ["Q:12+34=? A:", "Q:56+11=? A:"]       # one shape bucket
MAX_TOKENS = 16
TIMEOUT_S = 240
# metric families only one side exposes (none: the front ends are one
# copy, and neither side reports device memory on the CPU)
ONLY_JAX, ONLY_PORT = set(), set()
# keys renamed or added by the port
RENAMED = {"jit_cache_size": "graph_cache_size"}
PORT_AUDIT_KEYS = {"lane_graphs"}


@functools.lru_cache(maxsize=None)
def _params():
    from repro.models import get_config, init_params
    jparams = jax.tree.map(np.asarray, jax.jit(
        init_params, static_argnums=0)(get_config("tiny"),
                                        jax.random.PRNGKey(3)))
    return jparams


def _families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


async def _scenario(pkg: str) -> dict:
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    models, http = mod("models"), mod("server.http")
    client, obs = mod("server.client"), mod("obs")
    cfg = models.get_config("tiny")
    dcfg = mod("core.decoder").DecodeConfig(
        method="streaming", gen_len=MAX_TOKENS, block_size=8, window=8,
        early_exit=False)
    if pkg == "repro":
        eng = mod("serving").ContinuousEngine(cfg, _params(), dcfg,
                                              max_slots=2)
    else:
        params = mod("bridge").params_from_jax(_params(), "cpu")
        eng = mod("serving").ContinuousEngine(cfg, params, dcfg,
                                              max_slots=2, device="cpu")
    tokens = {}
    eng.on_chunk(None, lambda ch: tokens.setdefault(ch.uid, []).extend(
        int(t) for t in ch.tokens))
    tracer = obs.Tracer()
    watchdog = obs.SLOWatchdog(ttfb_p50_s=30.0, min_requests=1)
    loop = http._front(eng, 16, tracer, steal=False,
                       audit=obs.AuditConfig(sample_rate=1.0),
                       watchdog=watchdog, metrics_interval_s=0.02)
    loop.idle_poll_s = 0.005
    fe = await http.HttpFrontend(loop, port=0, tracer=tracer,
                                 watchdog=watchdog).start()
    out = {"json": [], "sse": []}
    try:
        for p in PROMPTS:
            st, _, doc = await client.complete(
                fe.host, fe.port, {"prompt": p, "max_tokens": MAX_TOKENS})
            assert st == 200
            out["json"].append((doc["text"], tokens[doc["uid"]]))
            stream = await client.SSEStream.open(
                fe.host, fe.port, {"prompt": p, "max_tokens": MAX_TOKENS})
            events = [e async for e in stream.events()]
            await stream.close()
            final = events[-1]
            out["sse"].append(("".join(e["text"] for e in events[:-1]),
                               final["text"], tokens[final["uid"]]))
        auditor = eng.auditor
        for _ in range(TIMEOUT_S * 100):
            if auditor.sampled == 2 * len(PROMPTS) and not auditor.pending:
                break
            await asyncio.sleep(0.01)
        for path in ("/healthz", "/debug/vars", "/metrics"):
            st, _, body = await client.request(fe.host, fe.port, "GET", path)
            assert st == 200, path
            out[path] = body.decode() if path == "/metrics" \
                else json.loads(body)
        out["audit"] = auditor.stats()
    finally:
        await fe.shutdown(drain=True, timeout_s=60)
    return out


@functools.lru_cache(maxsize=None)
def run(pkg: str) -> dict:
    return asyncio.run(asyncio.wait_for(_scenario(pkg), TIMEOUT_S))


def test_completions_match_jax_streamed_and_not():
    port, ref = run("repro_torch"), run("repro")
    assert port["json"] == ref["json"]
    assert port["sse"] == ref["sse"]
    for joined, final, toks in port["sse"]:
        assert joined == final and len(toks) == MAX_TOKENS


def test_audit_counters_match_jax():
    port, ref = run("repro_torch")["audit"], run("repro")["audit"]
    for key in ("seen", "sampled", "completed", "dropped", "errors",
                "regret", "divergences", "conf_agree", "conf_total"):
        assert port[key] == ref[key], key
    assert port["completed"] == 2 * len(PROMPTS)
    assert sum(port["divergences"].values()) == 0
    assert set(port) - set(ref) == PORT_AUDIT_KEYS
    assert set(ref) <= set(port)


def test_healthz_and_debug_vars_keys_match_jax():
    port, ref = run("repro_torch"), run("repro")
    assert port["/healthz"] == ref["/healthz"]
    assert set(port["/debug/vars"]) == set(ref["/debug/vars"])
    pv, rv = port["/debug/vars"]["engines"][0], ref["/debug/vars"][
        "engines"][0]
    assert set(pv) == set(rv)
    assert set(pv["scheduler"]) == {RENAMED.get(k, k)
                                    for k in rv["scheduler"]}
    assert pv["scheduler"]["graph_cache_size"] > 0
    assert set(pv["audit"]) == set(rv["audit"]) | PORT_AUDIT_KEYS
    assert set(pv["recorder"]) == set(rv["recorder"])


def test_metrics_families_match_jax():
    port = _families(run("repro_torch")["/metrics"])
    ref = _families(run("repro")["/metrics"])
    assert port - ref == ONLY_PORT
    assert ref - port == ONLY_JAX
    assert len(port) > 40
