"""Block-boundary work stealing in the port (``repro_torch.server.
EngineRouter`` / ``EngineLoop`` / ``ContinuousEngine``), mirroring
``tests/test_steal.py`` on ``tiny`` on the CPU with the port's seeded
weights.

The contract: a stolen request produces the SAME tokens it would have
produced unstolen. Streaming decode is batch-invariant, stolen waiting
requests are prefilled from scratch by the thief, and stolen paused rows
resume through the preempt/resume path, so token identity is exact. On
top of it: cancels racing the steal conclude every ticket once, and the
span trees stay well-formed. The port against the JAX package's fleet
is ``tests/test_torch_fleet_jax.py``."""
import threading

import torch

from repro_torch.core.decoder import DecodeConfig
from repro_torch.models import get_config, init_params
from repro_torch.obs import Tracer
from repro_torch.obs.trace import request_tree
from repro_torch.server import EngineLoop, EngineRouter
from repro_torch.server.types import ServerRequest
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)

CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
MAX_TOKENS = 16
WAIT_S = 180
# one shape bucket: equal-length prompts gang-batch cleanly
PROMPTS = [f"Q:{i}{(i + 3) % 10}+{(i + 5) % 10}{i}=? A:" for i in range(8)]


def make_engine(max_slots=2):
    dcfg = DecodeConfig(method="streaming", gen_len=MAX_TOKENS,
                        block_size=8, window=16)
    return ContinuousEngine(CFG, PARAMS, dcfg, max_slots=max_slots,
                            device="cpu")


_REF = {}


def _ref():
    """Every prompt decoded on one engine, no stealing: prompt -> text."""
    if not _REF:
        eng = make_engine(max_slots=2)
        uids = {eng.submit(p, max_tokens=MAX_TOKENS): p for p in PROMPTS}
        comps = eng.run_to_completion()
        assert len(comps) == len(PROMPTS)
        _REF.update({uids[c.uid]: c.text for c in comps})
    return _REF


class Fleet:
    """Two EngineLoops under one router, everything submitted to loop 0
    so loop 1 has nothing to do but steal."""

    def __init__(self, steal=True, tracer=None):
        self.engines = [make_engine(max_slots=2) for _ in range(2)]
        self.loops = [EngineLoop(e, max_pending=64, idle_poll_s=0.005,
                                 tracer=tracer, index=i)
                      for i, e in enumerate(self.engines)]
        self.router = EngineRouter(self.loops, steal=steal)

    def __enter__(self):
        for lp in self.loops:
            lp.start()
        return self

    def __exit__(self, *exc):
        self.router.close(drain=False, timeout_s=60)

    def submit_all(self, prompts):
        """Submit everything to the victim (loop 0); per-ticket
        (prompt, ticket, done_event, results) records."""
        out = []
        for p in prompts:
            done = threading.Event()
            results = []

            def deliver(event, results=results, done=done):
                results.append(event)
                if event[0] == "done":
                    done.set()

            t = self.loops[0].submit(
                ServerRequest(prompt=p, max_tokens=MAX_TOKENS), deliver)
            t.loop = self.loops[0]
            out.append((p, t, done, results))
        return out


def test_stolen_tokens_bit_identical():
    ref = _ref()
    with Fleet(steal=True) as fl:
        recs = fl.submit_all(PROMPTS)
        for p, t, done, results in recs:
            assert done.wait(timeout=WAIT_S), f"request never finished: {p}"
        # the idle sibling actually took work...
        assert fl.engines[1].metrics.steals_in >= 1
        total = sum(e.metrics.steals_in for e in fl.engines)
        assert total == sum(e.metrics.steals_out for e in fl.engines)
        # ...and every request, stolen or not, matches the unstolen run
        for p, t, done, results in recs:
            comp = results[-1][1]
            assert results[-1][0] == "done"
            assert not comp.cancelled
            assert comp.text == ref[p], f"steal changed tokens for {p!r}"


def test_steal_under_cancel_concludes_every_ticket_once():
    tracer = Tracer()
    with Fleet(steal=True, tracer=tracer) as fl:
        recs = fl.submit_all(PROMPTS)
        # cancel every other ticket at once: some are still pending on
        # the victim, some already stolen (the cancel must forward to the
        # ticket's current owner), some decoding
        for p, t, done, results in recs[::2]:
            fl.router.cancel(t, "test-cancel")
        for p, t, done, results in recs:
            assert done.wait(timeout=WAIT_S), f"never concluded: {p}"
        for p, t, done, results in recs:
            dones = [e for e in results if e[0] == "done"]
            assert len(dones) == 1, f"{p!r} concluded {len(dones)} times"
        # request_tree raises on unbalanced or unclosed nesting; a ticket
        # cancelled before reaching any engine opened no spans
        traced = 0
        for p, t, done, results in recs:
            events = tracer.request_events(t.trace_id) if t.trace_id \
                else []
            if events:
                request_tree(events)
                traced += 1
        assert traced >= 1


def test_paused_row_steal_resumes_identically():
    """Engine-level lifecycle: decode one block, preempt, steal the
    parked row, adopt it on a second engine, finish there, and get the
    tokens an unbroken single-engine run gives."""
    ref = _ref()
    victim = make_engine(max_slots=1)
    thief = make_engine(max_slots=1)
    target = PROMPTS[0]

    uid = victim.submit(target, max_tokens=MAX_TOKENS)
    assert victim.step() == []            # prefill + block 0 of 2
    victim.preempt(uid)
    # inside a full tick a parked row is resumed at once (admission
    # takes paused rows first); the scheduler's compaction alone freezes
    # the block boundary a loop-level steal command sees
    victim.scheduler._compact()
    assert any(r.uid == uid for r, _, _ in victim.scheduler.paused)

    stolen = victim.steal_paused()
    assert stolen is not None
    req, state = stolen
    assert req.uid == uid and state.cache is None   # host arrays only
    assert victim.metrics.steals_out == 1
    assert not victim.scheduler.paused

    new_uid = thief.adopt_paused(req, state)
    assert thief.metrics.steals_in == 1
    comps = {c.uid: c for c in thief.run_to_completion()}
    assert comps[new_uid].text == ref[target]
    assert comps[new_uid].stolen
    assert victim.run_to_completion() == []          # nothing left behind


def test_dkv_paused_rows_are_never_stolen():
    """A dkv parked row carries its gathered KV (and dkv is not
    batch-invariant): ``steal_paused`` refuses it."""
    dcfg = DecodeConfig(method="dkv", gen_len=MAX_TOKENS, block_size=8)
    eng = ContinuousEngine(CFG, PARAMS, dcfg, max_slots=1, device="cpu")
    uid = eng.submit(PROMPTS[0], max_tokens=MAX_TOKENS)
    eng.step()
    eng.preempt(uid)
    eng.scheduler._compact()              # freeze the parked instant
    assert eng.scheduler.paused
    assert eng.steal_paused() is None
    assert eng.metrics.steals_out == 0
    eng.run_to_completion()
