"""The port's continuous scheduler against the JAX package's, continued
from ``test_torch_serving_jax.py`` (the same script,
``_torch_serving_script.py``): ``fast`` exactly; dkv on its structure,
since XLA:CPU is not run-to-run deterministic for it (``SKILL.md``) and
its tokens, and the early exits that follow from them, are not
comparable; and the reference's ``test_backfill_on_early_exit`` input."""
import dataclasses

from repro.core.decoder import DecodeConfig as JDecodeConfig
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.serving import BlockScheduler as JBlockScheduler
from repro_torch.core.decoder import DecodeConfig
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving import BlockScheduler

import _torch_serving_script as S


def test_fast_trace_chunks_and_completions_match_jax():
    trace, chunks, comps = S.port_run("fast")
    jtrace, jchunks, jcomps = S.jax_run("fast")
    assert trace == jtrace
    assert chunks == jchunks
    assert comps == jcomps
    assert any(c[4] for c in comps) and any(c[5] for c in comps)
    assert [c[0] for c in comps] == list(range(1, 9))


def test_dkv_structure_matches_jax():
    """dkv gangs keep their admitted batch (no compaction, no merge):
    the two schedulers form the same gangs and advance them the same
    way over the first two ticks, before any token decides an early
    exit; the port then serves every request, a dkv gang's size never
    changes, and the preempted and cancelled rows come out as such."""
    trace, _, comps = S.port_run("dkv")
    jtrace, _, _ = S.jax_run("dkv", max_ticks=2)
    assert trace[:2] == jtrace
    assert [c[0] for c in comps] == list(range(1, 9))
    assert [c[0] for c in comps if c[4]] == [2]
    first = {lanes: batch for t in trace for batch, _, lanes in t}
    assert all(batch == len(lanes) for lanes, batch in first.items())
    assert S.port_run("dkv")[0] == trace       # one process, one answer


def test_backfill_on_early_exit_trace_matches_jax():
    """The reference's ``test_backfill_on_early_exit`` fails on its own
    premise (its fake-EOS rows do not exit inside the 2-slot window, so
    no second gang forms and no gang shrinks). The
    port does not copy that assertion; it gives the JAX scheduler's
    trace on that exact input, tick for tick."""
    eos = S.eos_id()
    d = dict(method="streaming", gen_len=32, **S.BASE)
    jt = S.backfill_trace(JBlockScheduler,
                          dataclasses.replace(S.JCFG, eos_token_id=eos),
                          S.JPARAMS, JByteTokenizer(S.JCFG.vocab_size),
                          dcfg=JDecodeConfig(**d))
    pt = S.backfill_trace(BlockScheduler,
                          dataclasses.replace(S.CFG, eos_token_id=eos),
                          S.PARAMS, ByteTokenizer(S.CFG.vocab_size),
                          dcfg=DecodeConfig(**d), device="cpu")
    assert pt == jt
    assert len(pt) < 100
