"""The steal of a parked row as a race between two ``EngineLoop``
threads (``chip_smoke.py``'s fleet phase), with its interleavings forced.

A parked row can be stolen only between two of the victim's ticks. The
tick that parks it (``BlockScheduler._compact``) ends in ``_admit``,
which resumes parked rows first whenever slots are free, and the victim
serves a thief's ask only at the top of its loop. So whether a sibling
steals the row is decided by when the thief's ask reaches the victim,
not by the handshake (``steal_waiting`` / ``steal_paused`` /
``adopt_paused``): an ask served after the victim resumed the row is an
empty grant, and every ticket still concludes once with the tokens of
an undisturbed decode. The first two tests drive one loop iteration at
a time on the test's thread and pin both outcomes; the last runs the
fleet phase's own ``run_fleet`` on two loop threads with the thief
slowed so that, unheld, it would come too late: the victim holds its
parked row at the block boundary (``preempt_after_first_block``), and
the thief steals it by construction."""
import importlib.util
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.decoder import DecodeConfig
from repro_torch.models import get_config, init_params
from repro_torch.server import EngineLoop, EngineRouter
from repro_torch.server.types import ServerRequest
from repro_torch.serving import ContinuousEngine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = get_config("tiny")
PARAMS = init_params(CFG, torch.Generator().manual_seed(5), "cpu")
GEN = 32                     # 4 blocks of 8: a row parks after block 2
# one shape bucket: equal-length prompts gang-batch cleanly
PROMPTS = [f"Q:{i}{(i + 3) % 10}+{(i + 5) % 10}{i}=? A:" for i in range(8)]
WAIT_S = 120


def engine():
    """The fleet phase's engine shape: 4 slots, gangs of 2, padded to 2."""
    dcfg = DecodeConfig(method="streaming", gen_len=GEN, block_size=8,
                        window=16)
    return ContinuousEngine(CFG, PARAMS, dcfg, max_slots=4, max_gang=2,
                            batch_multiple=2, device="cpu")


_REF = {}


def reference():
    """Each prompt decoded alone: prompt -> tokens."""
    if not _REF:
        eng = engine()
        for p in PROMPTS:
            uid = eng.submit(p, max_tokens=GEN)
            comps = {c.uid: c for c in eng.run_to_completion()}
            _REF[p] = comps[uid].tokens
    return _REF


@pytest.fixture
def fleet(monkeypatch):
    """Two loops under a stealing router, never started: the test runs
    each loop's iterations itself (``iterate``), on its own thread. The
    router only considers running loops as victims."""
    monkeypatch.setattr(EngineLoop, "running", property(lambda self: True))
    loops = [EngineLoop(engine(), max_pending=16, idle_poll_s=0.002,
                        index=i) for i in range(2)]
    EngineRouter(loops, steal=True)
    return loops


def iterate(lp) -> None:
    """One pass of ``EngineLoop._run_loop``'s body: serve the commands,
    feed the scheduler, ask for a steal, tick once."""
    lp._drain_commands(block=False)
    lp._feed()
    lp._maybe_steal()
    if not lp.engine.scheduler.idle:
        for comp in lp.engine.step():
            lp._finish(comp)


def submit(lp, prompts):
    """Submit to ``lp``; per ticket (prompt, done events)."""
    out = []
    for p in prompts:
        events = []
        t = lp.submit(ServerRequest(prompt=p, max_tokens=GEN),
                      events.append)
        t.loop = lp
        out.append((p, events))
    return out


def run_out(loops, recs, limit=400):
    for _ in range(limit):
        if all(any(e[0] == "done" for e in ev) for _, ev in recs):
            return
        for lp in loops:
            iterate(lp)
    raise AssertionError("the loops did not finish every request")


def check_done(recs):
    ref = reference()
    for p, events in recs:
        dones = [e[1] for e in events if e[0] == "done"]
        assert len(dones) == 1, f"{p!r} concluded {len(dones)} times"
        assert not dones[0].cancelled
        np.testing.assert_array_equal(dones[0].tokens, ref[p])
    return [e[1] for _, ev in recs for e in ev if e[0] == "done"]


def parked_uid(lp):
    """Preempt the first live row of a gang past its first block."""
    for g in lp.engine.scheduler.gangs:
        rows = g.live_rows()
        if g.state.block_idx >= 1 and rows:
            uid = g.requests[rows[0]].uid
            lp.engine.preempt(uid)
            return uid
    raise AssertionError("no gang past its first block")


def test_a_late_ask_finds_the_parked_row_resumed(fleet):
    """Lost race: the victim's only gang holds one row, so the tick that
    parks it frees both slots and resumes it before the tick ends. The
    row is never parked between ticks: no backlog to steal, and an ask
    served then is an empty grant. Nothing is lost or duplicated."""
    victim, thief = fleet
    recs = submit(victim, PROMPTS[:1])
    iterate(victim)                       # prefill + block 0
    parked_uid(victim)
    iterate(victim)                       # parks the row, then resumes it
    sched = victim.engine.scheduler
    assert not sched.paused and sched.live_rows == 1
    assert victim.router.pick_victim(thief) == (None, 0)
    victim._cmds.put(("steal", (thief, 1), None))     # a late ask
    iterate(victim)
    grants = []
    thief._exec = lambda cmd, ex=thief._exec: (grants.append(cmd[:2]),
                                                ex(cmd))
    iterate(thief)
    assert ("steal_done", 0) in grants
    run_out(fleet, recs)
    comps = check_done(recs)
    assert thief.engine.metrics.steals_in == 0
    assert not any(c.stolen for c in comps)


def test_an_ask_between_ticks_steals_the_parked_row(fleet):
    """Won race: the victim's two gangs of two fill its four slots, so the
    parked row waits; the thief, holding the queued request it stole
    first, asks between two of the victim's ticks and adopts the row.
    Both steals land, and every request decodes as it would alone."""
    victim, thief = fleet
    recs = submit(victim, PROMPTS[:5])
    iterate(victim)                       # two gangs of 2, one queued
    assert len(victim.engine.scheduler.gangs) == 2
    assert victim.router.pick_victim(thief)[0] is victim
    iterate(thief)                        # asks
    iterate(victim)                       # grants the queued request
    iterate(thief)                        # takes it; asks again on no
    assert thief.engine.metrics.steals_in == 1
    parked_uid(victim)
    iterate(victim)                       # parks the row; no free slot
    sched = victim.engine.scheduler
    assert len(sched.paused) == 1 and sched.slots_used == 4
    iterate(thief)                        # asks for the parked row
    iterate(victim)                       # grants it at the boundary
    iterate(thief)                        # adopts it
    assert thief.engine.metrics.steals_in == 2
    assert not sched.paused
    run_out(fleet, recs)
    comps = check_done(recs)
    assert sum(bool(c.stolen) for c in comps) == 1


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_phase_steals_by_construction(monkeypatch):
    """``chip_smoke.run_fleet`` as the fleet phase runs its steal fleet,
    on two loop threads, with every thief tick slowed to 0.3 s (its
    first stolen request keeps it ticking): the victim's parked window,
    a few milliseconds of tiny ticks, would close long before the
    thief's next ask. The victim holds instead, and the phase's check
    (``steals_in_ge_2_one_paused``) holds with its threshold."""
    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "FLEET_GEN", GEN)
    engines = [engine(), engine()]
    victim_eng, thief_eng = engines
    step = thief_eng.step

    def slow_step():
        time.sleep(0.3)
        return step()

    thief_eng.step = slow_step
    loops = [EngineLoop(e, max_pending=16, idle_poll_s=0.002, index=i)
             for i, e in enumerate(engines)]
    router = EngineRouter(loops, steal=True)
    prompts = [(f"P{i}", p) for i, p in enumerate(PROMPTS)]

    def after_paused_steal(t_wave1):
        while thief_eng.metrics.steals_in < 2 and loops[0].inflight \
                and time.perf_counter() - t_wave1 < WAIT_S:
            time.sleep(0.005)

    try:
        run, _ = cs.run_fleet(loops, loops[0], prompts,
                              cs.DeviceSpans(False), after_paused_steal,
                              victim_eng, thief=thief_eng)
    finally:
        assert router.close(drain=True, timeout_s=WAIT_S)
        del thief_eng.step
    recs = run["client"].recs
    assert len(run["preempted"]) == 1
    assert thief_eng.metrics.steals_in >= 2
    assert sum(bool(r["comp"].stolen) for r in recs) >= 1
    ref = reference()
    for r in recs:
        assert r["dones"] == 1
        np.testing.assert_array_equal(r["comp"].tokens, ref[r["prompt"]])
    assert threading.active_count() < 50
