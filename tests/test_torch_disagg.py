"""Disaggregated prefill/decode pools in the port (``EngineRouter``
roles and the prefill->decode handoff through the shared prefix store),
mirroring ``tests/test_disagg.py`` on ``tiny`` on the CPU with the
port's seeded weights.

The contract under test: a request primed on a prefill-pool engine and
adopted by a decode-pool engine produces the SAME tokens as the
single-engine path — the prefill pool publishes every chunk-aligned
prompt chunk into the ONE shared store, the adopter's normal admission
prefill assembles the prompt KV from it, and cached-vs-cold prefill is
bit-identical by construction (repro_torch.cache), so token identity is
exact, not approximate (dkv per its documented structural policy). On
top of identity: fully-cached requests bypass the prefill pool, a
prefill-engine crash re-routes its queue instead of failing it (no
orphaned span trees, no leaked radix pins), cancels racing the handoff
conclude exactly once, stealing never crosses pool roles, and the
busy-time/load accounting splits prefill from decode.
"""
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.cache import PrefixKVCache, device_placement
from repro_torch.core.decoder import DecodeConfig
from repro_torch.models import get_config, init_params
from repro_torch.obs import Tracer
from repro_torch.obs.trace import request_tree
from repro_torch.server import EngineLoop, EngineRouter, HttpFrontend
from repro_torch.server.router import PREFILL_PENDING_WEIGHT
from repro_torch.server.types import ServerRequest
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
PLACEMENT = device_placement("cpu")
MAX_TOKENS = 16
BLOCK = 8
CHUNK = 8                       # prefix-cache chunk (tokens)
# 16 chars = two full cache chunks, one shape bucket
PROMPTS = [f"Q:{i}{(i + 3) % 10}+{(i + 5) % 10}{i}=? Answer"
           for i in range(4)]
METHODS = ["vanilla", "dkv", "prefix", "fast", "streaming"]


def make_engine(method="streaming", store=None, prefill_only=False,
                max_slots=2):
    dcfg = DecodeConfig(method=method, gen_len=MAX_TOKENS,
                        block_size=BLOCK, window=4, tau0=0.5,
                        prefix_cache=store is not None,
                        cache_chunk=CHUNK)
    return ContinuousEngine(CFG, PARAMS, dcfg, max_slots=max_slots,
                            prefix_cache=store,
                            prefill_only=prefill_only, device="cpu")


REF = {}


def ref_comps(method):
    """Every prompt decoded co-located on ONE engine: prompt ->
    Completion (the disaggregated fleet must reproduce its tokens)."""
    if method not in REF:
        store = PrefixKVCache(chunk_tokens=CHUNK, placement=PLACEMENT) \
            if method != "vanilla" else None
        eng = make_engine(method, store)
        uids = {eng.submit(p, max_tokens=MAX_TOKENS): p for p in PROMPTS}
        comps = eng.run_to_completion()
        assert len(comps) == len(PROMPTS)
        REF[method] = {uids[c.uid]: c for c in comps}
    return REF[method]


class Fleet:
    """1 prefill-only loop + ``n_decode`` decode loops under one
    router, all sharing ONE radix store (vanilla has no store: the
    handoff still works, the adopter just re-prefills from scratch)."""

    def __init__(self, method="streaming", n_decode=1, tracer=None,
                 steal=True, max_slots=2):
        self.store = (PrefixKVCache(chunk_tokens=CHUNK, shared=True,
                                    placement=PLACEMENT)
                      if method != "vanilla" else None)
        self.engines = [make_engine(method, self.store,
                                    prefill_only=True,
                                    max_slots=max_slots)]
        self.engines += [make_engine(method, self.store,
                                     max_slots=max_slots)
                         for _ in range(n_decode)]
        self.loops = [EngineLoop(e, max_pending=64, idle_poll_s=0.005,
                                 tracer=tracer, index=i,
                                 role="prefill" if i == 0 else "decode")
                      for i, e in enumerate(self.engines)]
        self.router = EngineRouter(self.loops, steal=steal)

    def __enter__(self):
        for lp in self.loops:
            lp.start()
        return self

    def __exit__(self, *exc):
        self.router.close(drain=False, timeout_s=60)

    def submit(self, prompt, via=None):
        """Submit through the router, or straight to one loop (``via``)
        to force the prefill path regardless of routing policy."""
        done = threading.Event()
        results = []

        def deliver(event, results=results, done=done):
            results.append(event)
            if event[0] == "done":
                done.set()

        req = ServerRequest(prompt=prompt, max_tokens=MAX_TOKENS)
        if via is None:
            t = self.router.submit(req, deliver)
        else:
            t = via.submit(req, deliver)
            t.loop = via
        return prompt, t, done, results


def _assert_matches(comp, ref, method):
    """Token identity vs the co-located reference; dkv is asserted per
    its documented structural (non-batch-invariant) policy."""
    if method == "dkv":
        assert comp.n_tokens == ref.n_tokens
        assert comp.n_blocks == ref.n_blocks
        toks = np.asarray(comp.tokens)
        assert toks.size == 0 or (0 <= toks.min()
                                  and toks.max() < CFG.vocab_size)
    else:
        assert comp.text == ref.text, "handoff changed tokens"


def _no_leaked_pins(store):
    return store is None or all(n.refs == 0 for n in store.tree.nodes)


# --------------------------------------------------- token identity

@pytest.mark.parametrize("method", METHODS)
def test_handoff_tokens_identical(method):
    ref = ref_comps(method)
    with Fleet(method) as fl:
        recs = [fl.submit(p, via=fl.loops[0]) for p in PROMPTS]
        for p, t, done, results in recs:
            assert done.wait(timeout=240), f"never finished: {p}"
        # every row went prefill pool -> decode pool exactly once...
        assert fl.engines[0].metrics.handoffs_out == len(PROMPTS)
        assert fl.engines[1].metrics.handoffs_in == len(PROMPTS)
        # ...and the prefill engine never decoded a block
        assert fl.engines[0].metrics.decode_busy_s == 0.0
        assert fl.engines[0].scheduler.decode_wall_s == 0.0
        for p, t, done, results in recs:
            assert results[-1][0] == "done"
            comp = results[-1][1]
            assert not comp.cancelled
            assert comp.handed_off
            _assert_matches(comp, ref[p], method)
        assert _no_leaked_pins(fl.store)


def test_router_routes_cold_to_prefill_warm_to_decode():
    """A cache-miss prompt routes to the prefill pool; once its chunks
    are in the shared store, the same prompt bypasses straight to the
    decode pool (handoff counters stay put) and still reuses the KV."""
    with Fleet("streaming") as fl:
        req = ServerRequest(prompt=PROMPTS[0], max_tokens=MAX_TOKENS)
        assert fl.router._needs_prefill(req)
        p, t, done, results = fl.submit(PROMPTS[0])
        assert done.wait(timeout=240)
        assert t.loop is fl.loops[1]          # migrated to the adopter
        assert results[-1][1].handed_off
        out_before = fl.engines[0].metrics.handoffs_out
        assert out_before == 1
        # warm: the prefill pass published both aligned chunks
        assert not fl.router._needs_prefill(req)
        p, t, done, results = fl.submit(PROMPTS[0])
        assert done.wait(timeout=240)
        comp = results[-1][1]
        assert not comp.handed_off
        assert fl.engines[0].metrics.handoffs_out == out_before
        assert comp.cache_hit_tokens > 0      # ...but the KV was reused
        assert comp.text == ref_comps("streaming")[PROMPTS[0]].text
        assert _no_leaked_pins(fl.store)


# --------------------------------------------------- churn

def test_prefill_crash_reroutes_without_orphans():
    """A prefill engine whose step explodes mid-stream sheds its queue:
    already-primed rows are dispatched (store-backed, safe), the rest
    re-route via the steal machinery to healthy loops, every request
    still completes, span trees stay well-formed, and the shared store
    ends with zero pinned chunks."""
    tracer = Tracer()
    with Fleet("streaming", n_decode=2, tracer=tracer) as fl:
        real_step = fl.engines[0].step
        calls = []

        def flaky_step():
            if calls:
                raise RuntimeError("injected prefill failure")
            calls.append(1)
            return real_step()

        fl.engines[0].step = flaky_step
        recs = [fl.submit(p, via=fl.loops[0]) for p in PROMPTS]
        for p, t, done, results in recs:
            assert done.wait(timeout=240), f"never concluded: {p}"
        comps = [r[3][-1][1] for r in recs]
        # the first step primed a gang (handed off); the crash re-routed
        # the rest to the decode pool, which primed for itself — so
        # everything completes, nothing is error-cancelled
        assert all(not c.cancelled for c in comps), \
            [c.cancelled for c in comps]
        ref = ref_comps("streaming")
        for (p, t, done, results), comp in zip(recs, comps):
            assert comp.text == ref[p].text
        assert fl.engines[0].metrics.handoffs_out >= 1
        assert _no_leaked_pins(fl.store)
        for p, t, done, results in recs:
            events = tracer.request_events(t.trace_id)
            if events:
                request_tree(events)          # raises if malformed


def test_cancel_during_handoff_concludes_exactly_once():
    """Cancels fired while rows migrate prefill->decode land on exactly
    one side: either the prefill scheduler's handoff_ready sweep or the
    forwarded cancel on the adopter — never both, never neither."""
    tracer = Tracer()
    with Fleet("streaming", tracer=tracer) as fl:
        recs = [fl.submit(p, via=fl.loops[0]) for p in PROMPTS]
        for p, t, done, results in recs[::2]:
            fl.router.cancel(t, "test-cancel")
        for p, t, done, results in recs:
            assert done.wait(timeout=240), f"never concluded: {p}"
        for p, t, done, results in recs:
            dones = [e for e in results if e[0] == "done"]
            assert len(dones) == 1, f"{p!r} concluded {len(dones)} times"
        for p, t, done, results in recs[1::2]:
            comp = results[-1][1]
            assert not comp.cancelled
            assert comp.text == ref_comps("streaming")[p].text
        assert _no_leaked_pins(fl.store)
        traced = 0
        for p, t, done, results in recs:
            events = tracer.request_events(t.trace_id) if t.trace_id \
                else []
            if events:
                request_tree(events)
                traced += 1
        assert traced >= 1


def test_drain_close_completes_inflight_handoffs():
    """close(drain=True) on the fleet: prefill loops drain first (their
    tails are handoffs the decode pool must outlive to adopt)."""
    with Fleet("streaming") as fl:
        recs = [fl.submit(p, via=fl.loops[0]) for p in PROMPTS[:2]]
        assert fl.router.close(drain=True, timeout_s=120)
        for p, t, done, results in recs:
            assert done.wait(timeout=1), f"drain dropped: {p}"
            assert not results[-1][1].cancelled


# --------------------------------------------------- routing policy

def _stub_loop(role, live=0, waiting=0, paused=0, pending=0, free=2,
               running=True, index=0):
    sched = types.SimpleNamespace(
        live_rows=live, waiting=[None] * waiting,
        paused=[None] * paused, max_slots=2, slots_used=2 - free)
    return types.SimpleNamespace(
        role=role, running=running, index=index, inflight=0,
        _pending=[None] * pending, engine=types.SimpleNamespace(
            scheduler=sched, prefix_cache=None))


def test_pick_victim_never_crosses_roles():
    prefill = _stub_loop("prefill", pending=8, free=0, index=0)
    decode_a = _stub_loop("decode", waiting=2, free=0, index=1)
    decode_b = _stub_loop("decode", index=2)
    r = EngineRouter([prefill, decode_a, decode_b], steal=True)
    victim, backlog = r.pick_victim(decode_b)
    assert victim is decode_a            # not the loaded prefill loop
    assert backlog == 2
    # and a prefill thief only sees prefill victims
    thief = _stub_loop("prefill", index=3)
    r2 = EngineRouter([prefill, decode_a, thief], steal=True)
    victim, backlog = r2.pick_victim(thief)
    assert victim is prefill
    assert backlog == 8


def test_victim_ranking_weights_queued_below_parked():
    """A deep-but-cheap queue (prefill-pending rows) must not outbid a
    sibling whose parked rows represent live decode work."""
    deep_queue = _stub_loop("decode", pending=8, free=0, index=0)
    parked = _stub_loop("decode", paused=3, free=0, index=1)
    thief = _stub_loop("decode", index=2)
    r = EngineRouter([deep_queue, parked, thief], steal=True)
    victim, backlog = r.pick_victim(thief)
    assert victim is parked              # 3*1.0 beats 8*WEIGHT
    assert backlog == 3                  # raw count, for the steal size
    assert 8 * PREFILL_PENDING_WEIGHT < 3


def test_loop_load_weights_prefill_pending_rows():
    lp = _stub_loop("decode", live=2, waiting=3, pending=1, paused=1)
    sole = _stub_loop("decode", index=1)
    r = EngineRouter([lp, sole], steal=False)
    assert r._loop_load(lp) == pytest.approx(
        2 + 1 + PREFILL_PENDING_WEIGHT * 4)
    assert r._loop_load(sole) == 0.0
    # submit ordering prefers genuinely-idle over deeply-queued
    assert r._by_load([lp, sole]) == [sole, lp]


# --------------------------------------------------- observability

def test_metrics_split_prefill_vs_decode():
    with Fleet("streaming") as fl:
        recs = [fl.submit(p, via=fl.loops[0]) for p in PROMPTS[:2]]
        for p, t, done, results in recs:
            assert done.wait(timeout=240)
        pre, dec = fl.engines[0].metrics, fl.engines[1].metrics
        assert pre.prefill_busy_s > 0 and pre.decode_busy_s == 0.0
        assert dec.decode_busy_s > 0
        assert pre.handoffs_out == dec.handoffs_in == 2
        assert dec.handoff_wait_s > 0
        snap = pre.snapshot()
        for key in ("prefill_busy_s", "decode_busy_s", "handoffs_out",
                    "handoffs_in", "handoff_wait_s"):
            assert key in snap
        dv = fl.loops[0].debug_vars()
        assert dv["role"] == "prefill" and dv["handoffs_out"] == 2
        assert fl.loops[1].debug_vars()["role"] == "decode"
        text = HttpFrontend(fl.router)._metrics_text()
        assert "repro_prefill_busy_seconds_total" in text
        assert "repro_decode_busy_seconds_total" in text
        assert "repro_handoffs_total 2" in text
        assert 'repro_pool_engines{role="prefill"} 1' in text
        assert 'repro_pool_engines{role="decode"} 1' in text
        assert 'repro_engine_handoffs_in_total{engine="1"} 2' in text
        assert 'repro_engine_handoffs_out_total{engine="0"} 2' in text
        assert "repro_handoff_wait_seconds" in text
