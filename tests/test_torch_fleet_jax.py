"""The port's fleets against the JAX package, on ``tiny`` on the CPU with
the same weights (JAX ``PRNGKey(3)``, carried across by
``repro_torch.bridge.params_from_jax``).

For each of the five methods, every request that the port's steal fleet
(two loops, everything submitted to loop 0, so loop 1 can only steal)
and pool fleet (``prefill:1,decode:1`` over one shared prefix store)
serve, and a row stolen while parked (from an engine that shares the
thief's store), has the tokens and the NFE of the
JAX package's single-engine decode, exactly. Every engine serves gangs
of one row (``max_slots=1``), as the reference does, so dkv's batch
dependence does not enter. Then the JAX package's own steal and pool
fleets serve the same prompts: their tokens equal the port's."""
import functools
import importlib
import threading

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MAX_TOKENS = 16
CHUNK = 8
WAIT_S = 240
METHODS = ["vanilla", "dkv", "prefix", "fast", "streaming"]
# 16 bytes = two cache chunks, one shape bucket, distinct first chunks
PROMPTS = [f"Q:{i}{(i + 3) % 10}+{(i + 5) % 10}{i}=? Answer"
           for i in range(4)]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@functools.lru_cache(maxsize=None)
def _jparams():
    from repro.models import get_config, init_params
    return jax.tree.map(np.asarray, jax.jit(
        init_params, static_argnums=0)(get_config("tiny"),
                                        jax.random.PRNGKey(3)))


@functools.lru_cache(maxsize=None)
def _tparams():
    from repro_torch.bridge import params_from_jax
    return params_from_jax(_jparams(), "cpu")


def _engine(pkg, method, store=None, prefill_only=False):
    cfg = _mod(pkg, "models").get_config("tiny")
    dcfg = _mod(pkg, "core.decoder").DecodeConfig(
        method=method, gen_len=MAX_TOKENS, block_size=8, window=4,
        tau0=0.5, prefix_cache=method != "vanilla", cache_chunk=CHUNK)
    kw = dict(max_slots=1, prefix_cache=store, prefill_only=prefill_only)
    if pkg == "repro":
        return _mod(pkg, "serving").ContinuousEngine(cfg, _jparams(), dcfg,
                                                     **kw)
    return _mod(pkg, "serving").ContinuousEngine(cfg, _tparams(), dcfg,
                                                 device="cpu", **kw)


def _store(pkg, method, shared=False):
    if method == "vanilla":
        return None
    cache = _mod(pkg, "cache")
    if pkg == "repro":
        return cache.PrefixKVCache(chunk_tokens=CHUNK, shared=shared)
    return cache.PrefixKVCache(chunk_tokens=CHUNK, shared=shared,
                               placement=cache.device_placement("cpu"))


@functools.lru_cache(maxsize=None)
def _reference(method):
    """The JAX package's single engine: prompt -> (tokens, nfe)."""
    eng = _engine("repro", method, _store("repro", method))
    uids = {eng.submit(p, max_tokens=MAX_TOKENS): p for p in PROMPTS}
    comps = eng.run_to_completion()
    assert len(comps) == len(PROMPTS)
    return {uids[c.uid]: (np.asarray(c.tokens).tolist(), c.nfe)
            for c in comps}


def _fleet(pkg, method, pool: bool):
    """Serve PROMPTS through a two-loop fleet of ``pkg``, everything
    submitted to loop 0: a steal fleet, or (``pool``) a prefill:1,
    decode:1 fleet over one shared store. Returns prompt -> Completion
    and the engines."""
    server = _mod(pkg, "server")
    if pool:
        store = _store(pkg, method, shared=True)
        engines = [_engine(pkg, method, store, prefill_only=True),
                   _engine(pkg, method, store)]
        roles = ["prefill", "decode"]
    else:
        engines = [_engine(pkg, method, _store(pkg, method))
                   for _ in range(2)]
        roles = ["both", "both"]
    loops = [server.EngineLoop(e, max_pending=64, idle_poll_s=0.005,
                               index=i, role=r)
             for i, (e, r) in enumerate(zip(engines, roles))]
    router = server.EngineRouter(loops, steal=True)
    for lp in loops:
        lp.start()
    recs = []
    try:
        for p in PROMPTS:
            done, results = threading.Event(), []

            def deliver(event, results=results, done=done):
                results.append(event)
                if event[0] == "done":
                    done.set()

            t = loops[0].submit(_mod(pkg, "server.types").ServerRequest(
                prompt=p, max_tokens=MAX_TOKENS), deliver)
            t.loop = loops[0]
            recs.append((p, done, results))
        for p, done, results in recs:
            assert done.wait(timeout=WAIT_S), f"never finished: {p}"
    finally:
        router.close(drain=False, timeout_s=60)
    comps = {}
    for p, done, results in recs:
        assert [e[0] for e in results].count("done") == 1
        comps[p] = results[-1][1]
        assert not comps[p].cancelled
    return comps, engines


def _assert_reference(comps, ref):
    for p, comp in comps.items():
        assert np.asarray(comp.tokens).tolist() == ref[p][0], p
        assert comp.nfe == ref[p][1], (p, comp.nfe, ref[p][1])


@pytest.mark.parametrize("method", METHODS)
def test_port_fleets_equal_jax_single_engine(method):
    ref = _reference(method)
    comps, engines = _fleet("repro_torch", method, pool=False)
    assert engines[1].metrics.steals_in >= 1
    _assert_reference(comps, ref)

    comps, engines = _fleet("repro_torch", method, pool=True)
    assert engines[0].metrics.handoffs_out == len(PROMPTS)
    assert engines[1].metrics.handoffs_in == len(PROMPTS)
    assert engines[0].scheduler.decode_wall_s == 0.0
    assert engines[0].graph_cache_size() == 0
    assert all(c.handed_off for c in comps.values())
    _assert_reference(comps, ref)

    if method == "dkv":
        return                      # parked dkv rows never leave
    # a parked row stolen after its first block resumes on the thief; the
    # two share one store, so the resume re-primes from the victim's
    # chunks and computes nothing more (with a store each, the thief
    # would compute the prompt's two chunks again: NFE + 2)
    store = _store("repro_torch", method, shared=True)
    victim = _engine("repro_torch", method, store)
    thief = _engine("repro_torch", method, store)
    uid = victim.submit(PROMPTS[1], max_tokens=MAX_TOKENS)
    victim.step()
    victim.preempt(uid)
    victim.scheduler._compact()
    req, state = victim.steal_paused()
    new_uid = thief.adopt_paused(req, state)
    comp = {c.uid: c for c in thief.run_to_completion()}[new_uid]
    assert comp.stolen
    _assert_reference({PROMPTS[1]: comp}, ref)


@pytest.mark.parametrize("pool", [False, True], ids=["steal", "pool"])
def test_jax_fleets_equal_the_port_fleets(pool):
    jax_comps, jax_engines = _fleet("repro", "streaming", pool)
    port_comps, _ = _fleet("repro_torch", "streaming", pool)
    if pool:
        assert jax_engines[0].metrics.handoffs_out == len(PROMPTS)
    for p in PROMPTS:
        assert np.asarray(port_comps[p].tokens).tolist() == \
            np.asarray(jax_comps[p].tokens).tolist(), p
        assert port_comps[p].nfe == jax_comps[p].nfe
        assert port_comps[p].handed_off == jax_comps[p].handed_off
