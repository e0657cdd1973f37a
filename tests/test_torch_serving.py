"""The port's continuous-batching subsystem (``repro_torch.serving``) and
the decoder's resumable-state contract it stands on, mirroring
``tests/test_serving.py`` inside the port: ``tiny`` on the CPU with JAX
``PRNGKey(3)`` weights carried across by ``repro_torch.bridge``.

On the CPU the port is deterministic and batch-invariant for every
method (torch on one thread), so dkv's resumption is asserted exactly
here, where the JAX package's XLA:CPU can only check its structure. The
graph binding rule (non-dkv states run on the decoder's bound KV buffer
and take nothing from the pool) is asserted on the buffers themselves.
The port against the JAX scheduler is ``tests/test_torch_serving_jax.py``;
the card's graphs of new batch sizes are ``tests/test_torch_cuda.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro_torch.bridge import params_from_jax
from repro_torch.core.decoder import METHODS, DecodeConfig, DiffusionDecoder
from repro_torch.core.engine import ServingEngine
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.config import get_config
from repro_torch.serving import (BlockChunk, BlockScheduler, ContinuousEngine,
                                 PrefixKVPool, StreamRouter, round_up_blocks)

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = params_from_jax(jax.tree.map(np.asarray, jax.jit(
    jinit_params, static_argnums=0)(jget_config("tiny"),
                                     jax.random.PRNGKey(3))), "cpu")
TOK = ByteTokenizer(CFG.vocab_size)
RNG = np.random.default_rng(0)
PROMPTS = RNG.integers(0, 200, (4, 10)).astype(np.int32)
NON_DKV = [m for m in METHODS if m != "dkv"]


def _dcfg(method="streaming", **kw):
    kw.setdefault("gen_len", 16)
    kw.setdefault("block_size", 8)
    kw.setdefault("window", 8)
    return DecodeConfig(method=method, **kw)


def _dec(d, cfg=CFG):
    return DiffusionDecoder(cfg, PARAMS, d, device="cpu")


def _engine(d, cfg=CFG, **kw):
    return ContinuousEngine(cfg, PARAMS, d, device="cpu", **kw)


def _fake_eos_cfg(method="streaming", gen_len=32):
    """A config whose eos_token_id is the token the untrained model
    emits most — guarantees early exits (as ``tests/test_serving.py``
    builds it)."""
    d = _dcfg(method, gen_len=gen_len, early_exit=False)
    r = _dec(d).generate(PROMPTS.copy())
    vals, counts = np.unique(r.tokens, return_counts=True)
    return dataclasses.replace(CFG, eos_token_id=int(vals[counts.argmax()]))


# ------------------------------------------------------------ decoder API


@pytest.mark.parametrize("method", NON_DKV)
def test_decode_block_interleaved_matches_generate(method):
    d = _dcfg(method)
    dec = _dec(d)
    ref_a = dec.generate(PROMPTS[:2].copy())
    ref_b = dec.generate(PROMPTS[2:].copy())
    sa = dec.prefill(PROMPTS[:2].copy())
    sb = dec.prefill(PROMPTS[2:].copy())
    while not (sa.finished and sb.finished):
        dec.decode_block(sa)
        dec.decode_block(sb)
    ra, rb = dec.finalize(sa), dec.finalize(sb)
    assert (ra.tokens == ref_a.tokens).all()
    assert (rb.tokens == ref_b.tokens).all()
    assert ra.nfe == ref_a.nfe and rb.nfe == ref_b.nfe


@pytest.mark.parametrize("method", NON_DKV)
def test_batch_invariance(method):
    d = _dcfg(method)
    dec = _dec(d)
    assert dec.batch_invariant
    full = dec.generate(PROMPTS.copy())
    for b in range(PROMPTS.shape[0]):
        one = _dec(d).generate(PROMPTS[b:b + 1].copy())
        assert (one.tokens[0] == full.tokens[b]).all()


def test_state_rows_and_total_len():
    dec = _dec(_dcfg(gen_len=16))
    st = dec.prefill(PROMPTS[:2].copy())
    assert st.total_len == 26
    assert not st.row_finished(0)
    st.done[1] = True
    assert st.row_finished(1) and not st.finished
    st.block_idx = st.n_blocks
    assert st.row_finished(0) and st.finished


@pytest.mark.parametrize("method", ["streaming", "dkv"])
def test_take_rows_resumes_mid_generation(method):
    """Compaction to B=2 after block 0 gives the rows they get
    uninterrupted. dkv gathers the rows' KV and masks into a buffer of
    its own; the others take the bound buffer of the new (B, T)."""
    d = _dcfg(method, gen_len=32)
    dec = _dec(d)
    ref = dec.generate(PROMPTS.copy())
    st = dec.prefill(PROMPTS.copy())
    dec.decode_block(st)                       # block 0 done at B=4
    sub = dec.take_rows(st, [1, 3])            # compact to B=2
    bound = dec._block_buffers(2, st.total_len).cache
    if method == "dkv":
        assert sub.cache is not bound and sub.cache is not st.cache
        for (k, v), (k0, v0) in zip(sub.cache, st.cache):
            assert torch.equal(k, k0[[1, 3]]) and torch.equal(v, v0[[1, 3]])
        assert (sub.valid_mask == st.valid_mask[[1, 3]]).all()
        assert (sub.cached_mask == st.cached_mask[[1, 3]]).all()
    else:
        assert sub.cache is bound
    while not sub.finished:
        dec.decode_block(sub)
    out = dec.finalize(sub)
    assert (out.tokens == ref.tokens[[1, 3]]).all()


@pytest.mark.parametrize("method", ["prefix", "streaming"])
def test_parked_state_holds_no_kv_and_adopts_the_bound_buffer(method):
    """``alloc_cache=False`` (a preempted state parked off-slot) holds no
    KV; at its next block it decodes on the bound buffer of (1, T), on
    the device loop and on the host loop alike, and resumes exactly."""
    for fused in (True, False):
        d = _dcfg(method, gen_len=32, fused=fused)
        dec = _dec(d)
        ref = dec.generate(PROMPTS.copy())
        st = dec.prefill(PROMPTS.copy())
        dec.decode_block(st)
        sub = dec.take_rows(st, [2], alloc_cache=False)
        assert sub.cache is None and sub.block_idx == 1
        dec.decode_block(sub)
        assert sub.cache is dec._block_buffers(1, st.total_len).cache
        while not sub.finished:
            dec.decode_block(sub)
        assert (dec.finalize(sub).tokens[0] == ref.tokens[2]).all()


def test_merge_rows_fuses_rows_of_two_states():
    """Rows of two states at one block boundary merge into one state on
    the bound buffer of the merged (B, T), and each finishes as it
    would alone."""
    d = _dcfg("streaming", gen_len=32)
    dec = _dec(d)
    ref = dec.generate(PROMPTS.copy())
    sa = dec.prefill(PROMPTS[:2].copy())
    sb = dec.prefill(PROMPTS[2:].copy())
    dec.decode_block(sa)
    dec.decode_block(sb)
    m = dec.merge_rows([(sa, [1]), (sb, [0, 1])])
    assert m.batch == 3 and m.block_idx == 1
    assert m.cache is dec._block_buffers(3, sa.total_len).cache
    while not m.finished:
        dec.decode_block(m)
    assert (dec.finalize(m).tokens == ref.tokens[[1, 2, 3]]).all()


def test_merge_rows_refuses_dkv_and_buffers_for_bound_methods():
    dkv = _dec(_dcfg("dkv"))
    st = dkv.prefill(PROMPTS[:2].copy())
    with pytest.raises(AssertionError):
        dkv.merge_rows([(st, [0]), (st, [1])])
    dec = _dec(_dcfg("streaming"))
    st = dec.prefill(PROMPTS[:2].copy())
    own = PrefixKVPool(CFG, device="cpu").acquire(1, st.total_len)
    for call in (lambda: dec.take_rows(st, [0], cache=own),
                 lambda: dec.merge_rows([(st, [0])], cache=own),
                 lambda: dec.prefill(PROMPTS[:1].copy(), cache=own)):
        with pytest.raises(ValueError, match="bound KV buffer"):
            call()


# ------------------------------------------------------------ KV pool


def test_pool_reuse_and_eviction():
    pool = PrefixKVPool(CFG, max_free=2, device="cpu")
    a = pool.acquire(2, 24)
    b = pool.acquire(2, 24)
    assert pool.misses == 2 and pool.hits == 0
    pool.release(2, 24, a)
    pool.release(2, 24, b)
    got = pool.acquire(2, 24)
    assert pool.hits == 1 and got is b          # most recently released
    pool.release(2, 24, got)                    # free: [a, b]
    pool.release(4, 24, pool.acquire(4, 24))    # evicts a (oldest)
    pool.release(2, 48, pool.acquire(2, 48))    # evicts b
    assert pool.evictions == 2
    assert pool.free_buffers == 2
    assert pool.free_bytes() > 0
    assert pool.acquire(8, 24) is not None      # miss allocates fresh
    assert pool.stats()["misses"] == 5


def test_pool_reused_across_dkv_requests():
    """Sequential same-bucket dkv requests reuse one KV buffer instead of
    allocating per request."""
    eng = _engine(_dcfg("dkv"), max_slots=2)
    eng.submit(PROMPTS[0], max_tokens=16)
    eng.run_to_completion()
    misses0 = eng.pool.misses
    assert misses0 == 1
    eng.submit(PROMPTS[0], max_tokens=16)
    eng.run_to_completion()
    assert eng.pool.misses == misses0          # no new allocation
    assert eng.pool.hits >= 1


@pytest.mark.parametrize("method", NON_DKV)
def test_bound_methods_allocate_nothing_from_the_pool(method):
    """Gangs of every method but dkv run on the decoders' bound buffers:
    admission, compaction, preemption, merges and backfill take nothing
    from the pool and put nothing in it."""
    d = _dcfg(method, gen_len=24, early_exit=False)
    eng = _engine(d, max_slots=4, max_gang=2, tokenizer=TOK)
    uids = [eng.submit(PROMPTS[i % 4], max_tokens=24 if i < 4 else 16)
            for i in range(6)]
    eng.step()
    eng.cancel(uids[1])
    eng.preempt(uids[2])
    eng.run_to_completion()
    assert eng.pool.stats()["hits"] == eng.pool.stats()["misses"] == 0
    assert eng.pool.free_buffers == 0
    bound = [b.cache for dec in eng.scheduler._decoders.values()
             for b in dec._buffers.values() if b.cache is not None]
    assert len({id(c) for c in bound}) == len(bound)   # one per (B, T)
    assert (len(bound) > 0) == (method != "vanilla")


# ------------------------------------------------------------ scheduler


def test_backfill_on_early_exit_trace():
    """With every slot taken, the scheduler's per-tick gang sizes on the
    fake-EOS workload of ``tests/test_serving.py::
    test_backfill_on_early_exit``; the JAX scheduler's trace on the same
    input is held equal to this one in ``test_torch_serving_jax.py``.
    Here: every request finishes and no tick exceeds the slots."""
    cfg_eos = _fake_eos_cfg(gen_len=32)
    d = _dcfg("streaming", gen_len=32)
    sched = BlockScheduler(cfg_eos, PARAMS, d, max_slots=2, tokenizer=TOK,
                           device="cpu")
    for b in range(3):
        sched.submit(PROMPTS[b], 32, 32)
    done, guard = [], 0
    while not sched.idle and guard < 100:
        guard += 1
        _, comps = sched.tick()
        done.extend(comps)
        assert sched.slots_used <= 2
    assert guard < 100
    assert sorted(c.uid for c in done) == [1, 2, 3]


def test_early_exit_frees_compute():
    cfg_eos = _fake_eos_cfg(gen_len=32)
    d = _dcfg("streaming", gen_len=32)
    sync = ServingEngine(cfg_eos, PARAMS, d, max_batch=4, mode="batch",
                         device="cpu")
    cont = ServingEngine(cfg_eos, PARAMS, d, max_batch=4, mode="continuous",
                         device="cpu")
    texts = [TOK.decode(PROMPTS[b])[:10].ljust(10, "x") for b in range(4)]
    for t in texts:
        sync.submit(t, max_tokens=32)
    for t in texts:
        cont._continuous.scheduler.submit(sync.tok.encode(t), 32, 32)
    sync_done = sync.run_to_completion()
    cont_done = cont._continuous.run_to_completion()
    assert len(sync_done) == len(cont_done) == 4
    assert max(c.nfe for c in cont_done) <= sync_done[0].nfe


@pytest.mark.parametrize("method", NON_DKV)
def test_continuous_matches_batch_tokens(method):
    d = _dcfg(method)
    prompts = [TOK.decode(p) for p in
               np.random.default_rng(1).integers(32, 126, (6, 9))
               .astype(np.int32)]
    budgets = [16, 8, 16, 8, 16, 8]
    sync = ServingEngine(CFG, PARAMS, d, max_batch=2, mode="batch",
                         device="cpu")
    cont = ServingEngine(CFG, PARAMS, d, max_batch=2, mode="continuous",
                         device="cpu")
    us = [sync.submit(p, mt) for p, mt in zip(prompts, budgets)]
    uc = [cont.submit(p, mt) for p, mt in zip(prompts, budgets)]
    ds_ = {c.uid: c for c in sync.run_to_completion()}
    dc = {c.uid: c for c in cont.run_to_completion()}
    for a, b in zip(us, uc):
        assert (ds_[a].tokens == dc[b].tokens).all(), method


def test_dkv_equivalence_structural():
    """dkv on the resumable API and through the continuous engine: the
    schedule is fixed with early exit off (1 prefill + 8 steps a block),
    and the port's CPU path is deterministic, so the tokens are exact
    too."""
    d = _dcfg("dkv", early_exit=False)
    dec = _dec(d)
    ref = dec.generate(PROMPTS[:2].copy())
    st = dec.prefill(PROMPTS[:2].copy())
    while not st.finished:
        dec.decode_block(st)
    out = dec.finalize(st)
    assert out.nfe == ref.nfe == 1 + 2 * 8
    assert out.steps_per_block == ref.steps_per_block
    assert (out.tokens != CFG.mask_token_id).all()
    assert (out.tokens == ref.tokens).all()
    prompts = [TOK.decode(p) for p in
               np.random.default_rng(2).integers(32, 126, (3, 9))
               .astype(np.int32)]
    sync = ServingEngine(CFG, PARAMS, d, max_batch=4, mode="batch",
                         device="cpu")
    cont = ServingEngine(CFG, PARAMS, d, max_batch=4, mode="continuous",
                         device="cpu")
    us = [sync.submit(p, 16) for p in prompts]
    uc = [cont.submit(p, 16) for p in prompts]
    ds_ = {c.uid: c for c in sync.run_to_completion()}
    dc = {c.uid: c for c in cont.run_to_completion()}
    assert len(ds_) == len(dc) == 3
    for a, b in zip(us, uc):
        assert (ds_[a].tokens == dc[b].tokens).all()


def test_pad_pow2_admits_groups_larger_than_pow2_capacity():
    eng = _engine(_dcfg(), max_slots=6, pad_pow2=True)
    uids = [eng.submit(PROMPTS[b % 4], max_tokens=16) for b in range(5)]
    sizes = set()
    while not eng.scheduler.idle:
        eng.step()
        sizes |= {g.batch for g in eng.scheduler.gangs}
    assert sizes <= {1, 2, 4}
    assert eng.metrics.snapshot()["requests"] == len(uids)


def test_admission_control():
    sched = BlockScheduler(CFG, PARAMS, _dcfg(), max_slots=2,
                           max_waiting=2, tokenizer=TOK, device="cpu")
    sched.submit(PROMPTS[0], 16, 16)
    sched.submit(PROMPTS[1], 16, 16)
    with pytest.raises(RuntimeError, match="admission rejected"):
        sched.submit(PROMPTS[2], 16, 16)


@pytest.mark.parametrize("method", ["streaming", "dkv"])
def test_preemption_resumes_exactly(method):
    d = _dcfg(method, gen_len=32)
    ref = _dec(d).generate(PROMPTS[:1].copy())
    eng = _engine(d, max_slots=4)
    uid = eng.submit(PROMPTS[0], max_tokens=32)
    eng.step()                                  # block 0 decoded
    eng.preempt(uid)
    eng.step()                                  # vacated + re-admitted
    assert eng.scheduler.paused or eng.scheduler.gangs
    done = eng.run_to_completion()
    assert len(done) == 1
    assert (done[0].tokens == ref.tokens[0]).all()


def test_resumed_row_pads_to_batch_multiple():
    """With ``batch_multiple`` a resumed row decodes in a gang of that
    size (pad lanes replicate it), so every gang is one size; its tokens
    are those of an uninterrupted decode."""
    d = _dcfg("streaming", gen_len=32, early_exit=False)
    ref = _dec(d).generate(PROMPTS.copy())
    eng = _engine(d, max_slots=4, batch_multiple=4)
    uids = [eng.submit(PROMPTS[b], max_tokens=32) for b in range(4)]
    eng.step()
    eng.preempt(uids[1])
    sizes = set()
    while not eng.scheduler.idle:
        done = eng.step()
        sizes |= {g.batch for g in eng.scheduler.gangs}
        for c in done:
            b = uids.index(c.uid)
            assert (c.tokens == ref.tokens[b]).all()
    assert sizes == {4}
    assert eng.metrics.snapshot()["requests"] == 4


# ------------------------------------------------------------ cancellation


def test_cancel_mid_gang_frees_slot_and_preserves_survivors():
    d = _dcfg("streaming", gen_len=32, early_exit=False)
    ref = _dec(d).generate(PROMPTS.copy())
    eng = _engine(d, max_slots=4)
    uids = [eng.submit(PROMPTS[b], max_tokens=32) for b in range(4)]
    eng.step()                                  # block 0 at B=4
    assert eng.scheduler.slots_used == 4
    assert eng.cancel(uids[1]) is None          # active -> deferred
    comps = eng.step()                          # cancel applies first
    cancelled = [c for c in comps if c.cancelled]
    assert [c.uid for c in cancelled] == [uids[1]]
    assert cancelled[0].n_blocks == 1           # paid for exactly 1 block
    assert len(cancelled[0].tokens) == 8        # the committed block only
    assert eng.scheduler.slots_used == 3        # slot freed for good
    comps += eng.run_to_completion()
    done = {c.uid: c for c in comps}
    for b in (0, 2, 3):                         # survivors untouched
        assert (done[uids[b]].tokens == ref.tokens[b]).all()
    assert (cancelled[0].tokens == ref.tokens[1][:8]).all()
    assert eng.metrics.cancelled == 1


def test_cancel_before_admit_drains_waiting_queue():
    d = _dcfg("streaming", gen_len=16, early_exit=False)
    eng = _engine(d, max_slots=2)
    uids = [eng.submit(PROMPTS[b], max_tokens=16) for b in range(3)]
    eng.step()                                  # 2 admitted, 1 waiting
    assert len(eng.scheduler.waiting) == 1
    comp = eng.cancel(uids[2])
    assert comp is not None and comp.cancelled and comp.n_tokens == 0
    assert not eng.scheduler.waiting
    rest = eng.run_to_completion()
    assert sorted(c.uid for c in rest) == sorted(uids[:2])
    assert not any(c.cancelled for c in rest)


def test_cancel_unknown_or_finished_uid_is_noop():
    eng = _engine(_dcfg(), max_slots=2)
    uid = eng.submit(PROMPTS[0], max_tokens=16)
    assert eng.cancel(999) is None
    assert not eng.scheduler._cancel            # no stale flag parked
    done = eng.run_to_completion()
    assert len(done) == 1 and not done[0].cancelled
    assert eng.cancel(uid) is None              # finished: ignored
    assert not eng.scheduler._cancel


def test_completion_trims_to_requested_max_tokens():
    d = _dcfg("streaming", gen_len=16, early_exit=False)
    eng = _engine(d, max_slots=2)
    uid = eng.submit(PROMPTS[0], max_tokens=11)   # rounds up to 16
    got = []
    eng.on_chunk(uid, got.append)
    comp = eng.run_to_completion()[0]
    assert comp.max_tokens == 11
    assert len(comp.tokens) == 11 and comp.n_tokens <= 11
    assert comp.text == TOK.decode(comp.tokens)
    assert "".join(c.text for c in got) == comp.text


# ------------------------------------------------------------ streaming


def test_stream_chunks_ordered_and_complete():
    d = _dcfg("streaming", gen_len=16, early_exit=False)
    eng = _engine(d, max_slots=4)
    uids = [eng.submit(PROMPTS[b], max_tokens=16) for b in range(3)]
    seen = {}
    for chunk in eng.stream():
        seen.setdefault(chunk.uid, []).append(chunk)
    assert set(seen) == set(uids)
    for uid in uids:
        blocks = [c.block_idx for c in seen[uid]]
        assert blocks == list(range(len(blocks)))      # in order, gapless
        assert [c.finished for c in seen[uid]].count(True) == 1
        assert seen[uid][-1].finished


def test_generate_stream_yields_one_request():
    eng = _engine(_dcfg("streaming", gen_len=16, early_exit=False),
                  max_slots=2)
    eng.submit(PROMPTS[1], max_tokens=16)
    chunks = list(eng.generate_stream(PROMPTS[0], max_tokens=16))
    assert {c.uid for c in chunks} == {2}
    assert [c.block_idx for c in chunks] == [0, 1] and chunks[-1].finished


def test_stream_callbacks_fire_per_block():
    d = _dcfg("streaming", gen_len=16, early_exit=False)
    eng = _engine(d, max_slots=2)
    uid = eng.submit(PROMPTS[0], max_tokens=16)
    got = []
    eng.on_chunk(uid, got.append)
    stream = eng.open_stream(uid)
    eng.run_to_completion()
    assert [c.block_idx for c in got] == [0, 1]
    assert got[-1].finished
    assert [c.block_idx for c in stream.drain()] == [0, 1]
    assert stream.exhausted


def test_stream_router_unsubscribes_finished():
    router = StreamRouter()
    router.subscribe(7, lambda c: None)
    router.publish([BlockChunk(7, 0, np.zeros(2, np.int32), "", True, False)])
    assert 7 not in router._subs


def test_stream_router_hygiene():
    def chunk(uid, finished=False):
        return BlockChunk(uid, 0, np.zeros(1, np.int32), "", finished,
                          False)

    router = StreamRouter()
    good, wild = [], []

    def bad(c):
        raise RuntimeError("boom")

    router.subscribe(1, bad)
    router.subscribe(1, good.append)
    router.subscribe(None, wild.append)
    router.publish([chunk(1), chunk(1)])
    assert len(good) == 2 and len(wild) == 2    # bad didn't block anyone
    assert bad not in router._subs.get(1, [])   # bad was dropped
    router.unsubscribe(None, wild.append)
    assert None not in router._subs
    router.subscribe(None, bad)
    router.publish([chunk(2)])
    assert None not in router._subs


# ------------------------------------------------------------ metrics


def test_metrics_snapshot():
    eng = _engine(_dcfg(), max_slots=2)
    for b in range(3):
        eng.submit(PROMPTS[b], max_tokens=16)
    done = eng.run_to_completion()
    snap = eng.metrics.snapshot()
    assert snap["requests"] == 3 == len(done)
    assert snap["throughput_tok_s"] >= 0
    assert 0 < snap["mean_occupancy"] <= 1
    assert snap["host_syncs_per_block"] == 1.0    # one sync a block
    for c in done:
        assert c.ttfb_s <= c.latency_s
        assert c.queue_s <= c.ttfb_s
    assert snap["ttfb_p50_s"] <= snap["latency_p50_s"]
    assert round_up_blocks(13, 8) == 16
    assert eng.telemetry.totals()["blocks"] > 0
    assert eng.metrics.hist_block_wall.count == eng.telemetry.blocks


def test_prewarm_leaves_no_capture_for_serving():
    """Every (bucket, gang size, block) program is built before admission
    opens; serving a mixed workload after that builds none (the card's
    'no capture after prewarm')."""
    d = _dcfg("streaming", gen_len=16, early_exit=False)
    eng = _engine(d, max_slots=2, tokenizer=TOK)
    rep = eng.prewarm([(10, 16), (10, 8)])
    assert rep["batch_sizes"] == [1, 2]
    assert rep["graphs"] == eng.graph_cache_size() == 2 * 2 + 2 * 1
    uids = [eng.submit(PROMPTS[b % 4], max_tokens=16 if b < 3 else 8)
            for b in range(5)]
    eng.step()
    eng.preempt(uids[0])
    eng.run_to_completion()
    snap = eng.metrics.snapshot()
    assert snap["requests"] == 5 and snap["prewarmed"] == 1
    assert snap["post_warm_compiles"] == 0
    assert eng.scheduler.compile_watch.counters()["post_warm"] == 0


def test_legacy_engine_api_continuous_default():
    eng = ServingEngine(CFG, PARAMS, _dcfg(), max_batch=4, device="cpu")
    assert eng.mode == "continuous"
    for i in range(3):
        eng.submit(f"Q:{i}{i}+11=? A:", max_tokens=16)
    done = eng.run_to_completion()
    assert len(done) == 3
    assert all(isinstance(c.text, str) for c in done)
    assert eng.throughput > 0
    assert eng.stats is eng._continuous.stats


def test_gang_sizes_round_to_batch_multiple():
    sched = BlockScheduler(CFG, PARAMS, _dcfg(), max_slots=8,
                           batch_multiple=4, device="cpu")
    assert sched._pad_batch(1) == 4 and sched._pad_batch(5) == 8
    for b in range(3):
        sched.submit(PROMPTS[b], 16, 16)
    sched.tick()
    assert len(sched.gangs) == 1
    gang = sched.gangs[0]
    assert gang.batch == 4
    assert sum(r is not None for r in gang.requests) == 3
    sched2 = BlockScheduler(CFG, PARAMS, _dcfg(), max_slots=8,
                            batch_multiple=3, device="cpu")
    n, padded = sched2._gang_target(8, 8, sched2._decoder(16))
    assert n > 0 and padded <= 8 and padded % 3 == 0


# ------------------------------------------------------ cross-gang merge


def test_cross_gang_merge_of_stragglers():
    d = _dcfg("streaming", gen_len=24, early_exit=False)
    ref = _dec(d).generate(PROMPTS.copy())
    eng = _engine(d, max_slots=4, max_gang=2, tokenizer=TOK)
    uids = [eng.submit(PROMPTS[i], max_tokens=24) for i in range(4)]
    eng.step()                            # two gangs of 2 decode block 0
    assert len(eng.scheduler.gangs) == 2
    eng.cancel(uids[1])
    eng.cancel(uids[3])
    eng.step()          # cancels vacate -> stragglers merge -> block 1
    assert eng.scheduler.merges == 1
    assert len(eng.scheduler.gangs) == 1
    assert eng.scheduler.gangs[0].batch == 2
    comps = {c.uid: c for c in eng.run_to_completion()}
    assert (comps[uids[0]].tokens == ref.tokens[0]).all()
    assert (comps[uids[2]].tokens == ref.tokens[2]).all()
    assert eng.metrics.snapshot()["gang_merges"] == 1
    assert eng.scheduler.debug_state()["merges"] == 1


def test_merge_respects_max_gang_and_skips_dkv():
    d = _dcfg("streaming", gen_len=24, early_exit=False)
    eng = _engine(d, max_slots=4, max_gang=2, tokenizer=TOK)
    for i in range(4):
        eng.submit(PROMPTS[i], max_tokens=24)
    eng.step()
    eng.step()                            # 2+2 > max_gang: no merge
    assert eng.scheduler.merges == 0 and len(eng.scheduler.gangs) == 2
    dv = _dcfg("dkv", gen_len=24)
    eng2 = _engine(dv, max_slots=4, max_gang=1, tokenizer=TOK)
    for i in range(2):
        eng2.submit(PROMPTS[i], max_tokens=24)
    eng2.step()                           # two 1-row dkv gangs
    assert len(eng2.scheduler.gangs) == 2
    eng2.scheduler.max_gang = 2           # merge would now fit...
    eng2.step()
    assert eng2.scheduler.merges == 0     # ...but dkv is never merged
    eng2.run_to_completion()
    assert eng2.pool.misses == 2 and eng2.pool.free_buffers == 2


def test_serve_cli_continuous_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tiny", "--device", "cpu", "--dtype",
                      "float32", "--n", "3", "--gen-len", "16",
                      "--mode", "continuous", "--max-slots", "2",
                      "--stream", "--prewarm", "12:16", "--pad-pow2"])
    assert out["mode"] == "continuous" and out["served"] == 3
    assert out["prewarm"]["batch_sizes"] == [1, 2]
    assert out["host_syncs_per_block"] == 1.0
    assert out["post_warm_captures"] == 0


def test_serving_modules_are_walked_by_the_isolation_test():
    """``test_torch_decode.py``'s import and AST checks walk every module
    of the port; the serving and observability modules are among them."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("serving.scheduler", "serving.engine", "serving.pool",
                "serving.stream", "serving.metrics", "serving.types",
                "obs.trace", "obs.log", "obs.metrics", "obs.compile",
                "obs.telemetry"):
        assert f"repro_torch.{mod}" in names
