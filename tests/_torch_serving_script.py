"""Shared by ``test_torch_serving_jax*.py``: one submission script
(staggered arrivals in two gen_len buckets, a preempt, a cancel, a
fake-EOS config that makes rows exit early) driven through
``repro.serving.BlockScheduler`` and ``repro_torch.serving.BlockScheduler``
on ``tiny`` with the same ``PRNGKey(3)`` weights (bridged into the port).

Each side is computed once per process (the JAX compiles dominate); the
tests are split over two files to keep each file's run short.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.models import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.serving import BlockScheduler as JBlockScheduler
from repro_torch.bridge import params_from_jax
from repro_torch.core.decoder import DecodeConfig, DiffusionDecoder
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.config import get_config
from repro_torch.serving import BlockScheduler

torch.set_num_threads(1)

JCFG = jget_config("tiny")
JPARAMS = jax.jit(jinit_params, static_argnums=0)(JCFG, jax.random.PRNGKey(3))
CFG = get_config("tiny")
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")
PROMPTS = np.random.default_rng(0).integers(0, 200, (6, 10)).astype(np.int32)
BASE = dict(block_size=8, window=8)


def untrained_tokens(n_rows: int) -> np.ndarray:
    """The port's decode of the first ``n_rows`` prompts, early exit off:
    the tokens the JAX package gives on these weights too
    (``test_torch_decode.py``), computed here without a JAX compile."""
    d = DecodeConfig(method="streaming", gen_len=32, early_exit=False,
                     **BASE)
    return DiffusionDecoder(CFG, PARAMS, d, device="cpu").generate(
        PROMPTS[:n_rows].copy()).tokens


@functools.lru_cache(maxsize=None)
def eos_id() -> int:
    """The token the untrained model emits most (as ``tests/
    test_serving.py::_fake_eos_cfg`` picks it on its 4 prompts)."""
    vals, counts = np.unique(untrained_tokens(4), return_counts=True)
    return int(vals[counts.argmax()])


@functools.lru_cache(maxsize=None)
def late_eos_id() -> int:
    """The same trick for the script: the most frequent token that no row
    commits in its first block, so rows exit early at different blocks
    and some run to their last."""
    tokens = untrained_tokens(6)
    first = set(tokens[:, :8].ravel().tolist())
    vals, counts = np.unique(tokens, return_counts=True)
    late = [(c, v) for v, c in zip(vals.tolist(), counts.tolist())
            if v not in first]
    return max(late)[1]


def script(sched, max_ticks: int = 60):
    """Drive a scheduler through the submission script; return its
    per-tick trace, chunks and completions. At tick 0 four 32-token
    requests (uids 1-4; the prompts of uids 1 and 2 never meet the fake
    EOS, those of 3 and 4 do early) and two 8-token ones (uids 5-6, a
    second bucket); max_gang 2 and 4 slots make two gangs of uids 1-4
    and leave 5-6 waiting. After tick 0: preempt uid 1. After tick 1: two
    more requests (32 and 6 tokens). After tick 2: cancel uid 2. On the
    way (streaming): backfill as uids 3-4 exit early, uid 1 resuming at
    the block where the rest of its old gang is and merging with it,
    compaction after the cancel."""
    trace, chunks, comps = [], [], []
    for p, mt in ((3, 32), (4, 32), (0, 32), (1, 32), (2, 8), (5, 8)):
        sched.submit(PROMPTS[p], -(-mt // 8) * 8, mt)
    tick = 0
    while not sched.idle and tick < max_ticks:
        c, done = sched.tick()
        chunks += [(ch.uid, ch.block_idx, tuple(ch.tokens.tolist()),
                    ch.text, ch.finished, ch.eos) for ch in c]
        comps += done
        trace.append([(g.batch, g.state.block_idx,
                       tuple(r.uid if r is not None else 0
                             for r in g.requests)) for g in sched.gangs])
        if tick == 0:
            sched.preempt(1)
        if tick == 1:
            sched.submit(PROMPTS[5], 32, 32)
            sched.submit(PROMPTS[0], 8, 6)
        if tick == 2:
            got = sched.cancel(2)
            if got is not None:
                comps.append(got)
        tick += 1
    comps = sorted(((c.uid, tuple(c.tokens.tolist()), c.nfe, c.n_blocks,
                     c.cancelled, c.early_exited) for c in comps))
    return trace, chunks, comps


def _kw(method):
    return dict(method=method, gen_len=32, **BASE)


@functools.lru_cache(maxsize=None)
def jax_run(method: str, max_ticks: int = 60):
    cfg = dataclasses.replace(JCFG, eos_token_id=late_eos_id())
    sched = JBlockScheduler(cfg, JPARAMS, JDecodeConfig(**_kw(method)),
                            max_slots=4, max_gang=2,
                            tokenizer=JByteTokenizer(cfg.vocab_size))
    return script(sched, max_ticks)


@functools.lru_cache(maxsize=None)
def port_run(method: str):
    cfg = dataclasses.replace(CFG, eos_token_id=late_eos_id())
    sched = BlockScheduler(cfg, PARAMS, DecodeConfig(**_kw(method)),
                           max_slots=4, max_gang=2,
                           tokenizer=ByteTokenizer(cfg.vocab_size),
                           device="cpu")
    return script(sched)


def backfill_trace(sched_cls, cfg, params, tok, **kw):
    """``tests/test_serving.py::test_backfill_on_early_exit``'s input:
    3 requests, 2 slots, fake EOS; the gang sizes before and after each
    tick."""
    d = kw.pop("dcfg")
    sched = sched_cls(cfg, params, d, max_slots=2, tokenizer=tok, **kw)
    for b in range(3):
        sched.submit(PROMPTS[b], 32, 32)
    sizes, guard = [], 0
    while not sched.idle and guard < 100:
        guard += 1
        before = [g.batch for g in sched.gangs]
        sched.tick()
        sizes.append((before, [g.batch for g in sched.gangs]))
    return sizes
