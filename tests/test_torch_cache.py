"""The port's cross-request prefix KV cache (``repro_torch.cache`` and the
decoder's and scheduler's prefix-cache paths), mirroring
``tests/test_cache.py`` inside the port: ``tiny`` on the CPU with the
port's own seeded weights.

On the CPU the port is deterministic and batch-invariant for every
method, so cached against cold is asserted bit for bit for all of them,
dkv included (the JAX package's XLA:CPU can only check dkv's structure),
on the device loop and on the host loop. The port against the JAX
package's prefix cache is ``tests/test_torch_cache_jax.py``; the
``/metrics`` cache series is in ``tests/test_torch_server.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cache import (PrefixKVCache, RadixTree, assemble_batch,
                               assemble_rows, device_placement, extract_row,
                               slice_nbytes)
from repro_torch.core.decoder import METHODS, DecodeConfig, DiffusionDecoder
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_config, init_params
from repro_torch.models.config import MLSTM, LayerSpec
from repro_torch.serving import BlockScheduler, ContinuousEngine

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
TOK = ByteTokenizer(CFG.vocab_size)
RNG = np.random.default_rng(7)
CHUNK = 8
PROMPTS = RNG.integers(0, 200, (4, 20)).astype(np.int32)   # 2 chunks + 4
CPU = device_placement("cpu")
CACHED = [m for m in METHODS if m != "vanilla"]


def _dcfg(method="streaming", **kw):
    kw.setdefault("gen_len", 16)
    kw.setdefault("block_size", 8)
    kw.setdefault("window", 8)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("cache_chunk", CHUNK)
    return DecodeConfig(method=method, **kw)


def _store():
    return PrefixKVCache(chunk_tokens=CHUNK, placement=CPU)


def _decoder(d, store, cfg=CFG):
    return DiffusionDecoder(cfg, PARAMS, d, device="cpu", prompt_cache=store)


def _engine(d=None, store=None, max_slots=4, cfg=CFG):
    return ContinuousEngine(cfg, PARAMS, d or _dcfg(), max_slots=max_slots,
                            tokenizer=TOK, prefix_cache=store, device="cpu")


def _fake_kv(nbytes=64):
    return [(torch.zeros(nbytes // 8), torch.zeros(nbytes // 8))]


def _run(dec, st):
    while not st.finished:
        dec.decode_block(st)
    return dec.finalize(st)


# ------------------------------------------------------------ radix tree


def test_radix_match_is_chunk_aligned_longest_prefix():
    store = PrefixKVCache(chunk_tokens=4, max_bytes=1 << 20)
    toks = np.arange(13, dtype=np.int32)          # 3 chunks + remainder
    store.insert(toks, 0, [_fake_kv() for _ in range(3)])
    assert store.nodes == 3
    assert store.match_len(toks) == 12            # remainder never cached
    other = toks.copy()
    other[9] = 99
    assert store.match_len(other) == 8
    store.insert(other, 2, [_fake_kv()])          # shared chain: one node
    assert store.nodes == 4
    chain = store.match(other)
    assert len(chain) == 3 and chain[1] is store.match(toks)[1]
    ids = {n.node_id for n in store.tree.nodes}
    assert len(ids) == store.nodes


def test_pinned_chunks_survive_eviction_pressure():
    kv = _fake_kv(256)
    assert slice_nbytes(kv) == 256
    store = PrefixKVCache(chunk_tokens=2, max_bytes=4 * slice_nbytes(kv))
    hot = np.asarray([1, 2, 3, 4], np.int32)
    store.insert(hot, 0, [_fake_kv(256), _fake_kv(256)])
    pinned = store.match(hot)
    assert len(pinned) == 2
    for i in range(8):
        store.insert(np.asarray([50 + i, 60 + i], np.int32), 0,
                     [_fake_kv(256)])
    assert store.evictions > 0
    assert store.bytes <= store.max_bytes
    assert store.match_len(hot) == 4
    store.unpin(pinned)
    for i in range(8):
        store.insert(np.asarray([80 + i, 90 + i], np.int32), 0,
                     [_fake_kv(256)])
    assert store.bytes <= store.max_bytes


def test_clear_drops_every_unpinned_chunk():
    store = _store()
    toks = np.arange(4 * CHUNK, dtype=np.int32)
    store.insert(toks, 0, [_fake_kv() for _ in range(4)])
    other = toks + 100
    store.insert(other, 0, [_fake_kv() for _ in range(2)])
    pinned = store.match(toks[:2 * CHUNK])         # two chunks pinned
    assert store.clear() == 4                       # 2 + 2 unpinned
    assert store.nodes == 2 and store.bytes == 2 * 64
    assert store.match_len(toks) == 2 * CHUNK
    assert store.max_bytes == 256 << 20             # budget put back
    store.unpin(pinned)
    assert store.clear() == 2 and store.nodes == 0 and store.bytes == 0
    assert store.stats()["evictions"] == 6


def test_eviction_is_leaf_only_lru():
    tree = RadixTree(2)
    toks = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
    a = tree.extend(None, toks[:2], None, 8)
    b = tree.extend(a, toks[2:4], None, 8)
    tree.extend(b, toks[4:6], None, 8)
    assert [n.depth for n in tree.evictable_leaves()] == [3], \
        "interior nodes must never be eviction candidates"


def test_chunks_are_byte_copies_in_their_own_dtype():
    """A stored chunk is the cache's bytes, bf16 included (no cast)."""
    cache = [(torch.randn(2, 12, 4, 8).to(torch.bfloat16),
              torch.randn(2, 12, 4, 8).to(torch.bfloat16))]
    kv = extract_row(cache, 1, 4, 8)
    assert kv[0][0].dtype == torch.bfloat16 and kv[0][0].shape == (4, 4, 8)
    assert torch.equal(kv[0][0], cache[0][0][1, 4:8])
    assert torch.equal(kv[0][1], cache[0][1][1, 4:8])
    cache[0][0][1, 4:8] = 0                       # a copy, not a view
    assert not torch.equal(kv[0][0], cache[0][0][1, 4:8])


def test_assemble_writes_each_rows_chain_at_time_zero():
    """``assemble_rows`` (a chain per row, any depth) and
    ``assemble_batch`` (one depth for the gang) write the chunks'
    bytes back at slots 0.. of their rows, in place."""
    cache = [(torch.randn(3, 12, 2, 4), torch.randn(3, 12, 2, 4))]
    chunks = [extract_row(cache, r, 0, 4) for r in range(3)] + \
        [extract_row(cache, r, 4, 8) for r in range(3)]
    out = [(torch.zeros(3, 12, 2, 4), torch.zeros(3, 12, 2, 4))]
    assert assemble_rows(out, {2: [chunks[2], chunks[5]], 0: [chunks[0]]}) \
        is out
    assert torch.equal(out[0][0][2, :8], cache[0][0][2, :8])
    assert torch.equal(out[0][1][0, :4], cache[0][1][0, :4])
    assert not out[0][0][1].any() and not out[0][0][0, 4:].any()
    out = [(torch.zeros(3, 12, 2, 4), torch.zeros(3, 12, 2, 4))]
    assemble_batch(out, [[chunks[r], chunks[3 + r]] for r in range(3)])
    assert torch.equal(out[0][0][:, :8], cache[0][0][:, :8])
    assert torch.equal(out[0][1][:, :8], cache[0][1][:, :8])
    assert not out[0][0][:, 8:].any()


# ------------------------------------------------------ prefill identity


@pytest.mark.parametrize("fused", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("method", METHODS)
def test_cached_prefill_token_identity(method, fused):
    """A warm store reproduces the cold run bit for bit: the prompt KV
    bytes after prefill, the tokens, the step schedule and the commit
    confidences, for every method (dkv too) on both loops."""
    d = _dcfg(method, fused=fused)
    store = _store()
    cold_dec = _decoder(d, store)
    cold_state = cold_dec.prefill(PROMPTS.copy())
    warm_dec = _decoder(d, store)
    warm_state = warm_dec.prefill(PROMPTS.copy())
    if method != "vanilla":
        assert (cold_state.prefix_hit_tokens == 0).all()
        assert (warm_state.prefix_hit_tokens == 16).all()
        for (ck, cv), (wk, wv) in zip(cold_state.cache, warm_state.cache):
            assert torch.equal(ck[:, :20], wk[:, :20])
            assert torch.equal(cv[:, :20], wv[:, :20])
    cold = _run(cold_dec, cold_state)
    warm = _run(warm_dec, warm_state)
    assert warm.nfe <= cold.nfe
    assert cold.steps_per_block == warm.steps_per_block
    np.testing.assert_array_equal(cold.tokens, warm.tokens)
    for a, b in zip(cold.block_stats, warm.block_stats):
        np.testing.assert_array_equal(a.commit_conf, b.commit_conf)
    if method == "vanilla":
        assert store.nodes == 0                   # the cache is a no-op
    else:
        assert store.stats()["lookup_hit_tokens"] >= 4 * 16
        assert warm.nfe == cold.nfe - 2           # two chunk passes saved


def test_partial_hit_computes_only_the_novel_tail():
    d = _dcfg()
    store = _store()
    _decoder(d, store).generate(PROMPTS[:1].copy())   # warm chunks 0-1
    diverged = PROMPTS[:1].copy()
    diverged[0, CHUNK:] = RNG.integers(0, 200, 12)    # novel after chunk 0
    cold = _decoder(d, _store()).generate(diverged.copy())
    dec = _decoder(d, store)
    st = dec.prefill(diverged.copy())
    assert st.prefix_hit_tokens[0] == CHUNK           # exactly one chunk
    # one chunk pass + the 4-token remainder, each over its own tokens
    assert st.nfe == 2 and st.q_tokens == CHUNK + 4
    np.testing.assert_array_equal(_run(dec, st).tokens, cold.tokens)


@pytest.mark.parametrize("method", CACHED)
def test_fused_and_host_loops_agree_under_prefix_cache(method):
    """The tail refresh exists in both loops; the host loop stays the
    oracle of the device loop, counters included."""
    d = _dcfg(method)
    fused = _decoder(d, _store()).generate(PROMPTS.copy())
    host = _decoder(dataclasses.replace(d, fused=False),
                    _store()).generate(PROMPTS.copy())
    np.testing.assert_array_equal(fused.tokens, host.tokens)
    for name in ("nfe", "steps_per_block", "query_tokens_processed",
                 "kv_tokens_attended"):
        assert getattr(fused, name) == getattr(host, name), name


def test_prefix_cache_requires_attention_only_layout():
    bad = dataclasses.replace(CFG, pattern=(LayerSpec(MLSTM),), reps=0,
                              tail=())
    with pytest.raises(AssertionError):
        DiffusionDecoder(bad, PARAMS, _dcfg(), device="cpu")
    with pytest.raises(AssertionError, match="mutually exclusive"):
        _dcfg(frozen_suffix=True)


def test_prefix_cached_state_owns_its_buffer():
    """The graph binding rule: the prompt KV is never rewritten by a
    refresh, so a prefix-cached state owns its buffer (the bound one is
    copied through) and the pool serves it."""
    d = _dcfg()
    dec = _decoder(d, _store())
    assert dec.cache_carries_state and dec.batch_invariant
    st = dec.prefill(PROMPTS.copy())
    dec.decode_block(st)
    bound = dec._bound_cache(st.batch, st.total_len)
    assert st.cache is not bound
    assert st.cache[0][0].data_ptr() != bound[0][0].data_ptr()
    eng = _engine(d)
    eng.submit(PROMPTS[0], max_tokens=16)
    eng.run_to_completion()
    assert eng.pool.misses >= 1


# ------------------------------------------------------ engine integration


def test_engine_warm_requests_match_cold_and_report_hits():
    d = _dcfg()
    eng = _engine(d)
    uids = [eng.submit(PROMPTS[i % 2], max_tokens=16) for i in range(6)]
    comps = {c.uid: c for c in eng.run_to_completion()}
    ref = _decoder(d, _store()).generate(PROMPTS[:2].copy())
    for i in range(6):
        np.testing.assert_array_equal(comps[uids[i]].tokens,
                                      ref.tokens[i % 2][:16])
    hits = [comps[uids[i]].cache_hit_tokens for i in range(6)]
    assert any(h >= 2 * CHUNK for h in hits), hits
    assert eng.expected_prefix_hit(PROMPTS[0]) == 2 * CHUNK
    snap = eng.metrics.snapshot()
    assert snap["prefix_cache_hits"] >= 1
    assert snap["prefix_cache_hit_tokens"] >= 2 * CHUNK
    assert snap["prefix_cache_bytes"] > 0
    assert snap["prefix_cache_nodes"] == 4
    assert snap["prefix_cache_evictions"] == 0


def test_admission_groups_by_hit_depth():
    """Warm and cold requests of the same shape bucket must not share a
    gang (a cold row would drag the gang's common hit to zero)."""
    eng = _engine()
    eng.submit(PROMPTS[0], max_tokens=16)
    eng.run_to_completion()                        # warm template 0
    eng.submit(PROMPTS[0], max_tokens=16)          # warm (2-chunk hit)
    eng.submit(PROMPTS[1], max_tokens=16)          # cold, same bucket
    sched = eng.scheduler
    keys = {sched._group_key(r) for r in sched.waiting}
    assert len(keys) == 2, "hit depth must split the admission group"
    assert sorted(r.expected_hit_tokens for r in sched.waiting) == [0, 16]
    comps = eng.run_to_completion()
    assert sorted(c.cache_hit_tokens for c in comps) == [0, 16]
    assert sorted(c.expected_hit_tokens for c in comps) == [0, 16]


def _fake_eos_cfg():
    d0 = _dcfg(early_exit=False, gen_len=32)
    r = DiffusionDecoder(CFG, PARAMS, d0, device="cpu").generate(
        PROMPTS.copy())
    vals, counts = np.unique(r.tokens, return_counts=True)
    return dataclasses.replace(CFG, eos_token_id=int(vals[counts.argmax()]))


def test_compaction_preserves_prompt_kv():
    """Early-exited rows shrink the gang; survivors' prompt KV travels
    with the compacted state (the tail refresh never recomputes it)."""
    cfg = _fake_eos_cfg()
    d = _dcfg(gen_len=32)
    refs = [_decoder(d, _store(), cfg).generate(PROMPTS[i:i + 1].copy())
            for i in range(4)]
    eng = _engine(d, cfg=cfg)
    uids = [eng.submit(PROMPTS[i], max_tokens=32) for i in range(4)]
    dec = eng.scheduler.decoder_for(32)
    batches, block = [], dec.decode_block
    dec.decode_block = lambda st: (batches.append(st.batch), block(st))[1]
    comps = {c.uid: c for c in eng.run_to_completion()}
    assert len(set(batches)) > 1, f"no compaction happened: {batches}"
    for i in range(4):
        np.testing.assert_array_equal(comps[uids[i]].tokens,
                                      refs[i].tokens[0][:32])


def test_merge_gathers_prompt_kv():
    """A cross-gang merge of prefix-cached states gathers each part's
    prompt KV into the merged state's own buffer."""
    d = _dcfg(gen_len=32)
    dec = _decoder(d, _store())
    a = dec.prefill(PROMPTS[:2].copy())
    b = dec.prefill(PROMPTS[2:].copy())
    dec.decode_block(a)
    dec.decode_block(b)
    merged = dec.merge_rows([(a, [1]), (b, [0, 1])])
    for (mk, _), (ak, _), (bk, _) in zip(merged.cache, a.cache, b.cache):
        assert torch.equal(mk[0, :20], ak[1, :20])
        assert torch.equal(mk[1:, :20], bk[:, :20])
    np.testing.assert_array_equal(merged.prefix_hit_tokens,
                                  np.concatenate([a.prefix_hit_tokens[[1]],
                                                  b.prefix_hit_tokens]))
    ref = _decoder(d, _store()).generate(PROMPTS.copy())
    out = _run(dec, merged)
    np.testing.assert_array_equal(out.tokens, ref.tokens[[1, 2, 3]])


def test_preempt_resume_reprimes_prompt_kv():
    d = _dcfg(gen_len=32)
    ref = _decoder(d, _store()).generate(PROMPTS[:2].copy())
    eng = _engine(d, max_slots=4)
    ua = eng.submit(PROMPTS[0], max_tokens=32)
    ub = eng.submit(PROMPTS[1], max_tokens=32)
    eng.step()
    eng.preempt(ub)
    comps = {c.uid: c for c in eng.run_to_completion()}
    np.testing.assert_array_equal(comps[ua].tokens, ref.tokens[0][:32])
    np.testing.assert_array_equal(comps[ub].tokens, ref.tokens[1][:32])
    st = eng.prefix_cache.stats()
    # the initial gang prefill: 2 cold lookups; the resume re-prime is a
    # third lookup that hits its own chunks (16 of 20 prompt tokens)
    assert st["lookups"] >= 3
    assert st["lookup_hit_tokens"] == 16, \
        "the resumed row must re-prime its dropped prompt KV from the store"


def test_scheduler_rejects_mismatched_store():
    with pytest.raises(ValueError, match="device"):
        BlockScheduler(CFG, PARAMS, _dcfg(), device="cpu",
                       prefix_cache=PrefixKVCache(chunk_tokens=CHUNK,
                                                  placement=("elsewhere",)))
    with pytest.raises(ValueError, match="chunk"):
        BlockScheduler(CFG, PARAMS, _dcfg(), device="cpu",
                       prefix_cache=PrefixKVCache(chunk_tokens=CHUNK + 1,
                                                  placement=CPU))
    with pytest.raises(ValueError, match="prefix_cache"):
        BlockScheduler(CFG, PARAMS, _dcfg(prefix_cache=False), device="cpu",
                       prefix_cache=_store())
    sched = BlockScheduler(CFG, PARAMS, _dcfg(), device="cpu")
    assert sched.prefix_cache.placement == CPU


def test_cache_affinity_routes_to_warm_engine():
    """The router prefers the engine whose store holds the longest
    matching prefix, and falls back to least-loaded when all are
    cold."""
    from repro_torch.server import EngineLoop, EngineRouter, ServerRequest
    prompt = "".join(chr(c) for c in RNG.integers(48, 123, 24))
    engines = [_engine(store=_store()) for _ in range(2)]
    engines[1].submit(prompt, max_tokens=16)
    engines[1].run_to_completion()                 # warm engine 1 only
    assert engines[1].expected_prefix_hit(prompt) >= 2 * CHUNK
    assert engines[0].expected_prefix_hit(prompt) == 0
    router = EngineRouter([EngineLoop(e) for e in engines])
    req = ServerRequest.from_json({"prompt": prompt, "max_tokens": 16})
    ticket = router.submit(req, lambda e: None)
    assert ticket.loop is router.loops[1], "warm engine must win"
    # cold prompt: affinity is moot, least-loaded (index ties) wins
    cold = ServerRequest.from_json({"prompt": "Z" * 24, "max_tokens": 16})
    t2 = router.submit(cold, lambda e: None)
    assert t2.loop is router.loops[0]


def test_serve_cli_prefix_cache_on_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tiny", "--device", "cpu", "--dtype",
                      "float32", "--train-steps", "0", "--n", "3",
                      "--gen-len", "16", "--prefix-cache", "--cache-chunk",
                      "4"])
    assert out["served"] == 3 and out["prefix_cache_nodes"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--arch", "tiny", "--device", "cpu", "--method",
                    "vanilla", "--prefix-cache"])
