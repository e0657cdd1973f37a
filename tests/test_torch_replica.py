"""The op log (``repro_torch.serving.replica``) on two gloo CPU ranks.

One world of two ranks runs this file as a program (``_rank_main``: a
file rendezvous in a temporary directory, as
``tests/test_torch_sharded_decode.py`` does); each rank prints one JSON
report, which the tests assert over. Three scenes, every group made by
both ranks in the same order:

* (A) one engine on mesh (2, 1): rank 0 the leader, driving it through
  an ``EngineProxy`` over its own ``Replica``; rank 1 ``follow``s;
* (B) two engines on meshes (1, 1): engine 0 on rank 0, engine 1 on rank
  1, whose proxy rank 0 holds and drives beside a plain engine given the
  same calls; a waiting request and a parked row stolen from engine 1
  and adopted by engine 0 (the row's host state pickled across ranks);
* (C) mesh (2, 1) again, rank 1's engine one uid ahead (a request
  submitted to it alone): its first replayed ``submit`` raises
  ``ReplicaDivergence`` and the rank leaves; rank 0's proxy breaks.

Held: the follower's ops are the leader's, in order; after every op the
proxy's reads (scheduler, metrics, stats, histograms, telemetry, graph
count) equal the engine's it stands for; every completion equals its
prompt's decode alone on one rank (tiny, float32, bit for bit); a
broken proxy hands back the requests it knew were waiting and fails the
rest."""
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT = 240
PROMPTS = ["Q:12+34=? A:", "Q:56+11=? A:", "Q:07-42=? A:", "Q:99+01=? A:",
           "Q:31-13=? A:"]
GEN = 32
_REPORTS = []


def _reports():
    if not _REPORTS:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       WORLD_SIZE=str(WORLD),
                       REPRO_TORCH_INIT="file://" + os.path.join(tmp, "rdv"))
            logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                    for r in range(WORLD)]
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve())],
                env=dict(env, RANK=str(r)), cwd=ROOT, stdout=logs[r],
                stderr=subprocess.STDOUT) for r in range(WORLD)]
            try:
                codes = [p.wait(timeout=TIMEOUT) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            out = []
            for f in logs:
                f.seek(0)
                out.append(f.read())
                f.close()
        assert codes == [0] * WORLD, "\n".join(
            f"rank {r}: {c}\n{o[-3000:]}" for r, (c, o)
            in enumerate(zip(codes, out)))
        _REPORTS.extend(json.loads(o.strip().splitlines()[-1]) for o in out)
    return _REPORTS


def test_followers_replay_the_leaders_ops_in_order():
    lead, fol = _reports()
    # rank 1 replays every op of engine A but the queries, in sequence
    assert fol["A"] == [h for h in lead["A_history"]
                        if h[1] not in ("state", "expected_prefix_hit")]
    names = [h[1] for h in fol["A"]]
    for op in ("submit", "step", "cancel", "preempt", "stop"):
        assert op in names
    # and engine 1's ops of scene B, on the rank that leads it
    assert [h[1] for h in fol["B"]][0] == "state"
    assert {"submit", "step", "steal_waiting", "steal_paused",
            "return_waiting", "preempt", "stop"} <= {h[1] for h in fol["B"]}


def test_proxy_reads_equal_the_engine_after_each_op():
    lead, _ = _reports()
    assert lead["A_reads"] and all(ok for _, ok in lead["A_reads"]), \
        [t for t, ok in lead["A_reads"] if not ok]
    assert lead["B_reads"] and all(ok for _, ok in lead["B_reads"]), \
        [t for t, ok in lead["B_reads"] if not ok]


def test_completions_equal_decodes_alone():
    lead, _ = _reports()
    for scene in ("A", "B"):
        got = lead[f"{scene}_tokens"]
        assert got, scene
        for prompt, toks in got.items():
            assert toks == lead["alone"][prompt], (scene, prompt)
    assert lead["A_cancelled"] == 1


def test_stolen_rows_cross_ranks_exactly():
    """engine 1 (rank 1) gives up a waiting request and a parked row;
    engine 0 (rank 0) adopts both and finishes them as decoded alone;
    a request taken back (``return_waiting``) finishes where it was."""
    lead, _ = _reports()
    b = lead["B_steal"]
    assert b["waiting_uid"] is not None and b["paused_uid"] is not None
    assert b["adopted_prompt"] in lead["B_tokens"]
    assert b["engine0_steals_in"] == 1 and b["engine1_steals_out"] == 3
    assert lead["B_same_as_plain"]


def test_forced_uid_mismatch_raises():
    _, fol = _reports()
    assert "ReplicaDivergence" in fol["C"]
    assert "op 2 (submit) gave 2, its leader rank 0 1" in fol["C"], fol["C"]


def test_broken_proxy_reroutes_waiting_and_fails_the_rest():
    lead, _ = _reports()
    c = lead["C"]
    assert c["broken"] and c["on_break"] == 1
    assert c["stub_uid"] in c["waiting_before"]
    assert c["cancel"] == {"cancelled": True, "n_tokens": 0}
    assert c["idle"] and c["steal_paused"] is None
    assert c["probe"] == 0


def test_mirror_keeps_the_loops_own_counters():
    """The mirror adds what changed on the leader's engine to what rank
    0's loop wrote itself (admission rejects, front-end cancels)."""
    from repro_torch.serving.metrics import RequestMetrics, ServeMetrics
    from repro_torch.serving.replica import _Deltas, apply_deltas

    class Eng:
        metrics = ServeMetrics(max_slots=4)
        stats = {"tokens": 0.0}
    d = _Deltas(Eng)
    mirror, stats = ServeMetrics(), {}
    apply_deltas(mirror, stats, d.take())
    mirror.admission_rejects += 2            # the loop's own
    mirror.cancelled += 1
    Eng.metrics.cancelled += 3               # the engine's
    Eng.metrics.wall_time_s = 0.1 + 0.2
    Eng.metrics.add_request(RequestMetrics(0, 0.1, 0.2, 0.3, 8, 16, 1))
    Eng.stats["tokens"] = 8.0
    apply_deltas(mirror, stats, d.take())
    assert mirror.admission_rejects == 2 and mirror.cancelled == 4
    assert mirror.max_slots == 4 and mirror.wall_time_s == 0.1 + 0.2
    assert mirror.total_nfe == 16 and len(mirror.requests) == 1
    assert [h.snapshot() for h in mirror.histograms] == \
        [h.snapshot() for h in Eng.metrics.histograms]
    assert stats == {"tokens": 8.0}
    assert d.take() == {"add": {}, "put": {}, "requests": [], "hist": {},
                        "stats": {}}


# ------------------------------------------------------------ one rank

def _view(e, exact=True):
    """What the loop, router and front end read of an engine. Timings
    are compared only between an engine and its own proxy."""
    s = e.scheduler
    snap = e.metrics.snapshot()
    tel = e.telemetry.totals()
    out = {"idle": s.idle, "waiting": len(s.waiting),
           "paused": len(s.paused), "slots_used": s.slots_used,
           "live_rows": s.live_rows, "max_slots": s.max_slots,
           "max_waiting": s.max_waiting, "graphs": e.graph_cache_size(),
           "audit_pending": e.audit_pending}
    if exact:
        out.update(debug=s.debug_state(), telemetry=tel, metrics=snap,
                   stats=dict(e.stats),
                   hist=[h.snapshot() for h in e.metrics.histograms])
    else:
        out.update({k: snap[k] for k in (
            "requests", "tokens", "total_nfe", "total_host_syncs",
            "cancelled", "gang_merges", "steals_in", "steals_out")})
        out["blocks"] = tel["blocks"]
    return out


def _rank_main():
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=os.environ["REPRO_TORCH_INIT"],
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()
    from repro_torch.core.decoder import DecodeConfig
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch.mesh import make_submeshes
    from repro_torch.models.config import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import (ContinuousEngine, DecodeExecutor,
                                     EngineProxy, Replica, ReplicaDivergence,
                                     follow, make_control_groups)
    from repro_torch.serving.replica import EngineBroken

    cfg = get_config("tiny", dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    # no early exit: every row decodes all its blocks, so a row
    # preempted after its first block is still parked after the next
    dcfg = DecodeConfig(method="streaming", gen_len=GEN,
                        block_size=cfg.block_size, window=16,
                        early_exit=False)
    tok = ByteTokenizer(cfg.vocab_size)

    def engine(mesh=None, **kw):
        ex = DecodeExecutor(cfg, params, mesh, device="cpu") \
            if mesh is not None else None
        kw.setdefault("max_slots", 4)
        return ContinuousEngine(cfg, params, dcfg, tokenizer=tok,
                                device="cpu", executor=ex, **kw)

    def proxy(ctl, rep=None):
        return EngineProxy(ctl, cfg=cfg, dcfg=dcfg, tokenizer=tok,
                           replica=rep)

    out = {}
    prompt_of = {}

    # (A) one engine on (2, 1), rank 0 leads it through its proxy
    meshes = make_submeshes(1, 2, 1)
    ctl = make_control_groups(meshes)[0]
    rep = Replica(engine(meshes[0]))
    if rank == 0:
        p = proxy(ctl, rep)
        reads, done = [], []

        def check(tag):
            reads.append((tag, _view(p) == _view(rep.engine)))
        check("state")
        uids = []
        for pr in PROMPTS[:3]:
            uids.append(p.submit(pr, GEN))
            prompt_of[("A", uids[-1])] = pr
            check("submit")
        done += p.step()
        check("step")
        assert p.cancel(uids[1]) is None      # active: ends at a boundary
        check("cancel")
        p.preempt(uids[2])
        check("preempt")
        while not p.scheduler.idle:
            done += p.step()
            check("step")
        p.stop()
        out["A_reads"] = reads
        out["A_history"] = [list(h) for h in rep.history]
        out["A_tokens"] = {prompt_of[("A", c.uid)]: c.tokens.tolist()
                           for c in done if not c.cancelled}
        out["A_cancelled"] = sum(c.cancelled for c in done)
    else:
        follow(rep, ctl)
        out["A"] = [list(h) for h in rep.history]
    del rep

    # (B) engine 0 on rank 0, engine 1 on rank 1; rank 0 drives engine
    # 1's proxy beside a plain engine given the same calls. Engine 1
    # pads gangs to 2 rows in 2 slots, so a row preempted beside a live
    # one stays parked (its padded resume does not fit)
    meshes = make_submeshes(2, 1, 1)
    ctls = make_control_groups(meshes)
    one = dict(max_slots=2, batch_multiple=2)
    rep = Replica(engine(meshes[rank], **(one if rank == 1 else {})))
    if rank == 0:
        p0, p1, ref = proxy(ctls[0], rep), proxy(ctls[1]), engine(**one)
        reads, done = [], []

        def both(name, *args):
            a, b = getattr(p1, name)(*args), getattr(ref, name)(*args)
            reads.append((name, _view(p1, False) == _view(ref, False)))
            return a, b
        uids = []
        for pr in PROMPTS[:4]:
            u, _ = both("submit", pr, GEN)
            uids.append(u)
            prompt_of[("B1", u)] = pr
        # a waiting request moves to engine 0; another goes back
        req, _ = both("steal_waiting")
        u0 = p0.submit(req.prompt_tokens, req.max_tokens)
        prompt_of[("B0", u0)] = prompt_of[("B1", req.uid)]
        back, rback = both("steal_waiting")
        p1.return_waiting(back)
        ref.return_waiting(rback)
        reads.append(("return", _view(p1, False) == _view(ref, False)))
        a, b = both("step")
        done += [("B1", c) for c in a]
        refdone = list(b)
        # a parked row moves to engine 0 with its host state
        both("preempt", uids[0])
        a, b = both("step")
        done += [("B1", c) for c in a]
        refdone += b
        stolen, _ = both("steal_paused")
        paused_uid = stolen[0].uid          # adoption gives a fresh uid
        u1 = p0.adopt_paused(*stolen)
        prompt_of[("B0", u1)] = prompt_of[("B1", paused_uid)]
        reads.append(("adopt", _view(p0) == _view(rep.engine)))
        while not (p0.scheduler.idle and p1.scheduler.idle):
            if not p1.scheduler.idle:
                a, b = both("step")
                done += [("B1", c) for c in a]
                refdone += b
            if not p0.scheduler.idle:
                done += [("B0", c) for c in p0.step()]
                reads.append(("step0", _view(p0) == _view(rep.engine)))
        out["B_steal"] = {
            "waiting_uid": req.uid, "paused_uid": paused_uid,
            "adopted_prompt": prompt_of[("B1", paused_uid)],
            "engine0_steals_in": p0.metrics.steals_in,
            "engine1_steals_out": p1.metrics.steals_out}
        p0.stop()
        p1.stop()
        out["B_reads"] = reads
        # engine 1 gives the plain engine's tokens too
        out["B_same_as_plain"] = sorted(
            (c.uid, c.tokens.tolist()) for e, c in done if e == "B1") == \
            sorted((c.uid, c.tokens.tolist()) for c in refdone)
        out["B_tokens"] = {prompt_of[(e, c.uid)]: c.tokens.tolist()
                           for e, c in done}
        # every prompt decoded alone on one rank
        alone = {}
        for pr in PROMPTS:
            eng = engine()
            eng.submit(pr, GEN)
            alone[pr] = eng.run_to_completion()[0].tokens.tolist()
        out["alone"] = alone
    else:
        follow(rep, ctls[1])
        out["B"] = [list(h) for h in rep.history]
    del rep

    # (C) rank 1's engine is one uid ahead: it diverges at the first
    # submit and leaves; rank 0's proxy breaks
    meshes = make_submeshes(1, 2, 1)
    ctl = make_control_groups(meshes)[0]
    rep = Replica(engine(meshes[0]))
    if rank == 1:
        rep.engine.submit(PROMPTS[0], GEN)
        try:
            follow(rep, ctl)
            out["C"] = "no divergence"
        except ReplicaDivergence as e:
            out["C"] = f"ReplicaDivergence: {e}"
        print(json.dumps(out), flush=True)
        os._exit(0)
    p = proxy(ctl, rep)
    breaks = []
    p.on_break = breaks.append
    waiting = []
    for _ in range(200):
        try:
            p.submit(PROMPTS[1], GEN)
            waiting = list(p.scheduler.waiting)
        except EngineBroken:
            break
        time.sleep(0.05)
    stub = p.steal_waiting() if p.broken is not None else None
    comp = p.cancel(waiting[0]) if waiting else None
    out["C"] = {"broken": p.broken is not None, "on_break": len(breaks),
                "waiting_before": waiting,
                "stub_uid": stub.uid if stub is not None else None,
                "cancel": {"cancelled": comp.cancelled,
                           "n_tokens": int(comp.n_tokens)} if comp else None,
                "idle": p.scheduler.idle, "steal_paused": p.steal_paused(),
                "probe": p.expected_prefix_hit(PROMPTS[0])}
    print(json.dumps(out), flush=True)
    os._exit(0)


if __name__ == "__main__":
    _rank_main()
