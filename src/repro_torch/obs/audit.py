"""Online quality auditing: shadow-oracle re-decode, confidence
calibration, SLO watchdog, and flight-recorder post-mortems (the
PyTorch counterpart of ``repro.obs.audit``).

On the card the oracle lanes are ``repro_torch.core.decoder.
DiffusionDecoder``s over the engine's own ``params`` (never a copy):
the ``host`` lane runs the per-step host loop, the ``cold`` lane the
CUDA-graph block loop with its own graph cache, so its first audit of a
shape captures that shape's block graphs (counted in ``lane_graphs``,
apart from the serving scheduler's capture ledger). Both run on the
engine's decode thread, inside ``tick``, like every other CUDA call of
the serving stack. A decode state's tokens are host arrays between
blocks, so the comparison reads no device memory.

Every fast path this stack has grown — the fused device loop, Pallas
kernels, chunk-causal prefix-cache prefill, gang compaction, work
stealing — asserts its correctness through *offline* bit-identity
tests. Nothing watches live traffic. This module closes that gap with
three always-on pieces:

* :class:`ShadowAuditor` samples a configurable fraction of completed
  requests and re-decodes them on a **low-priority lane**: the
  host-loop oracle (``fused`` flipped) and/or a cold, cache-bypass
  decoder (``prompt_cache=None``). Tokens are compared bit-for-bit;
  the first diverging position is attributed to its diffusion block
  and the divergence classified by source — ``fused-vs-host``,
  ``cached-vs-cold``, ``stolen-vs-resident``, or ``dkv-structural``
  (dkv is documented as not batch-invariant, so its divergences are
  expected structure, not alarms). A B=1 re-decode is a valid oracle
  for every *other* method precisely because they are batch-invariant
  (the PR 1 contract the compaction and steal tests already rely on).

* **Confidence calibration + early-exit regret.** The fused loop's
  carry now returns each committed token's commit-time confidence
  (``BlockStats.commit_conf`` — same single host sync per block).
  When an audited request matches its oracle, every token agrees; on a
  divergence the matching prefix agrees and the rest does not. Both
  are binned by commit confidence into ``CONF_BUCKETS`` agree/total
  counters, so Eq. 4 thresholds become monitorable: a low-confidence
  bucket whose agreement decays flags a τ schedule that commits too
  eagerly. Early-exited requests whose audit diverged increment a
  **regret** counter — the EOS that truncated the schedule was not the
  EOS the oracle decoded.

* :class:`SLOWatchdog` + :class:`FlightRecorder`. The watchdog keeps a
  rolling window of completions and evaluates configured TTFB /
  per-token-latency / goodput targets (``repro_slo_*`` metrics). On a
  breach, an audit divergence, or a decode-thread crash, the flight
  recorder dumps the trace ring buffers (Perfetto-loadable), a metrics
  snapshot, and the scheduler/gang state to ``--flight-dir`` — also
  triggerable via ``GET /debug/flight``.

Threading: ``on_completion`` and ``tick`` run on the owning engine's
decode thread (the EngineLoop calls them between scheduler ticks), so
the auditor's counters follow the same single-writer contract as
``ServeMetrics`` mirrors. ``tick`` advances at most **one** decoder
call (one prefill or one block) per invocation and only when the
scheduler's admission signals say paying traffic is idle — the audit
lane can never starve a real request, it decodes in the gaps.

Hot-path discipline (lint-enforced, like the tracer): nothing in this
module may raise out of the serving path. Failures are logged and the
job dropped.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.log import get_logger
from repro_torch.obs.telemetry import CONF_BUCKETS

log = get_logger("repro_torch.obs.audit")

# divergence source classes (label values of
# repro_audit_divergences_total)
SOURCES = ("fused-vs-host", "cached-vs-cold", "stolen-vs-resident",
           "dkv-structural")


@dataclasses.dataclass
class AuditConfig:
    """Shadow-audit policy. ``sample_rate`` is the fraction of
    completions re-decoded (deterministic stride sampling — every
    ``round(1/rate)``-th completion — so runs are reproducible and two
    engines at the same rate audit the same request indices).
    ``oracle`` picks the re-decode lane(s): ``"host"`` (flip the
    fused/host loop), ``"cold"`` (same loop, prefix cache bypassed),
    ``"both"``, or ``"auto"`` (host always; cold too when the prefix
    cache is on)."""
    sample_rate: float = 0.05
    oracle: str = "auto"
    max_backlog: int = 8         # queued audit jobs before dropping
    max_results: int = 256       # retained AuditResult records

    def __post_init__(self):
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(f"sample_rate {self.sample_rate} not in [0,1]")
        if self.oracle not in ("host", "cold", "both", "auto"):
            raise ValueError(f"unknown oracle {self.oracle!r}")


@dataclasses.dataclass
class AuditResult:
    """Outcome of one (request, lane) shadow re-decode."""
    uid: int
    trace_id: str
    lane: str                    # "host" | "cold"
    matched: bool
    source: str = ""             # divergence class ("" when matched)
    position: int = -1           # first diverging token (gen-relative)
    block: int = -1              # position // block_size
    span: str = ""               # span-tree node the block decoded in
    n_tokens: int = 0
    expected: int = -1           # oracle token at the divergence
    got: int = -1                # served token at the divergence

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ShadowAuditor:
    """Samples completions and re-decodes them in traffic gaps.

    One auditor per :class:`~repro_torch.serving.ContinuousEngine`. The
    audit decoders are deliberately *not* registered in the scheduler's
    decoder map: the graphs the cold lane captures must not trip the
    post-warm capture watchdog or pollute the serving capture ledger
    (an audit lane building its own block programs is expected, not a
    pre-warm gap); ``lane_graphs`` counts them apart.
    """

    def __init__(self, engine, config: Optional[AuditConfig] = None,
                 tracer=None, flight: Optional["FlightRecorder"] = None):
        from repro_torch.core.decoder import DiffusionDecoder

        self._decoder_cls = DiffusionDecoder
        self.engine = engine
        self.config = config or AuditConfig()
        self.tracer = tracer if tracer is not None else engine.tracer
        self.flight = flight
        # test hook: called with (tokens, lane) right before compare;
        # returns (possibly corrupted) tokens. Lets fault-injection
        # tests flip a served token without touching the decode path.
        self.inject: Optional[Callable] = None
        # single-writer counters (decode thread); mirrored into
        # ServeMetrics each engine step like the compile ledger
        self.seen = 0                # completions offered
        self.sampled = 0             # completions picked for audit
        self.completed = 0           # audits finished (all lanes)
        self.dropped = 0             # jobs dropped at a full backlog
        self.errors = 0              # audit attempts that failed
        self.regret = 0              # early-exited requests whose audit
                                     # diverged (the EOS was wrong)
        self.divergences: Dict[str, int] = {s: 0 for s in SOURCES}
        self.conf_agree = [0] * CONF_BUCKETS
        self.conf_total = [0] * CONF_BUCKETS
        self._jobs: deque = deque()
        # in-flight job: (completion, remaining lanes, lane, state)
        self._active = None
        self._lane_decoders: Dict[tuple, object] = {}
        self.results: deque = deque(maxlen=self.config.max_results)

    # ------------------------------------------------------ intake

    def on_completion(self, comp) -> None:
        """Decide whether ``comp`` gets audited. Decode thread; never
        raises (log-and-drop)."""
        try:
            self._on_completion(comp)
        except Exception:
            self.errors += 1
            log.exception("audit intake failed (uid=%s)",
                          getattr(comp, "uid", "?"))

    def _on_completion(self, comp) -> None:
        if self.config.sample_rate <= 0.0:
            return
        if comp.cancelled or comp.prompt_tokens is None \
                or comp.n_blocks == 0:
            return   # partial results have no oracle to agree with
        self.seen += 1
        stride = max(1, round(1.0 / self.config.sample_rate))
        if (self.seen - 1) % stride:
            return
        self.sampled += 1
        if len(self._jobs) >= self.config.max_backlog:
            self.dropped += 1
            return
        self._jobs.append(comp)

    @property
    def pending(self) -> bool:
        return bool(self._jobs or self._active is not None)

    @property
    def backlog(self) -> int:
        return len(self._jobs) + (1 if self._active is not None else 0)

    # ------------------------------------------------------ audit lane

    def tick(self) -> bool:
        """Advance the audit lane by at most one decoder call (one
        prefill or one block). Runs only when the engine's scheduler
        reports no waiting paying traffic and a free slot — the same
        admission signals real requests use, so the audit lane yields
        at every block boundary. Returns True when it did work. Never
        raises."""
        try:
            return self._tick()
        except Exception:
            self.errors += 1
            self._active = None   # drop the poisoned job, keep serving
            log.exception("audit tick failed")
            return False

    def _tick(self) -> bool:
        if self._active is None and not self._jobs:
            return False
        sched = self.engine.scheduler
        if sched.waiting or sched.slots_used >= sched.max_slots:
            return False   # paying traffic owns the engine right now
        if self._active is None:
            comp = self._jobs.popleft()
            lanes = self._lanes(comp)
            if not lanes:
                return False
            self._active = [comp, lanes, None, None]
        comp, lanes, lane, state = self._active
        if lane is None:
            lane = lanes.pop(0)
            dec = self._decoder(lane, comp)
            t0 = time.perf_counter_ns()
            state = dec.prefill(
                np.asarray(comp.prompt_tokens, np.int32)[None])
            self._trace_step("audit_prefill", t0, comp, lane)
            self._active = [comp, lanes, lane, state]
            return True
        dec = self._decoder(lane, comp)
        t0 = time.perf_counter_ns()
        dec.decode_block(state)
        self._trace_step("audit_block", t0, comp, lane,
                         block=state.block_idx - 1)
        if state.finished:
            self._compare(comp, lane, state)
            self._active = [comp, lanes, None, None]
            if not lanes:
                self._active = None
                self.completed += 1
        return True

    def _lanes(self, comp) -> List[str]:
        oracle = self.config.oracle
        cold_ok = (self.engine.dcfg.prefix_cache
                   and self.engine.prefix_cache is not None)
        lanes = []
        if oracle in ("host", "both", "auto"):
            lanes.append("host")
        if oracle == "both" or (oracle == "auto" and cold_ok):
            if oracle == "both" and not cold_ok:
                log.warning("audit oracle 'both' requested but the "
                            "prefix cache is off; skipping cold lane")
            else:
                lanes.append("cold")
        if oracle == "cold":
            lanes = ["cold"] if cold_ok else []
            if not lanes:
                log.warning("audit oracle 'cold' requested but the "
                            "prefix cache is off; nothing to audit")
        return lanes

    def _decoder(self, lane: str, comp):
        """Build (and cache) the oracle decoder for one lane. The
        ``host`` lane flips the fused/host loop and *shares* the
        engine's prefix-cache store — cache effects are held constant,
        so a host-lane divergence isolates the loop implementation. The
        ``cold`` lane keeps the production loop but bypasses the store
        (``prompt_cache=None`` with ``prefix_cache`` still set runs the
        chunked prefill with nothing shared — the documented cache-off
        path), so a cold-lane divergence isolates cached KV content."""
        sched = self.engine.scheduler
        gen_len = len(comp.tokens) if comp.commit_conf is None \
            else len(comp.commit_conf)
        from repro_torch.core.decoder import round_up_blocks
        gen_len = round_up_blocks(max(gen_len, comp.max_tokens),
                                  sched.dcfg.block_size)
        key = (lane, gen_len)
        dec = self._lane_decoders.get(key)
        if dec is None:
            d = dataclasses.replace(sched.dcfg, gen_len=gen_len)
            cache = sched.prefix_cache
            if lane == "host":
                d = dataclasses.replace(d, fused=not d.fused)
            else:
                cache = None
            dec = self._decoder_cls(
                sched.cfg, sched.params, d, device=sched.device,
                prompt_cache=cache)
            self._lane_decoders[key] = dec
        return dec

    # ------------------------------------------------------ compare

    def _compare(self, comp, lane: str, state) -> None:
        from repro_torch.core.decoder import eos_truncate

        P = state.prompt_len
        gen = np.asarray(state.x[0, P:], np.int32)
        gen, _ = eos_truncate(gen, self.engine.cfg.eos_token_id)
        oracle = gen[:comp.max_tokens]
        served = np.asarray(comp.tokens, np.int32)
        if self.inject is not None:
            served = np.asarray(self.inject(served.copy(), lane), np.int32)
        n = min(len(served), len(oracle))
        neq = np.nonzero(served[:n] != oracle[:n])[0]
        if len(neq):
            pos = int(neq[0])
        elif len(served) != len(oracle):
            pos = n
        else:
            pos = -1
        self._calibrate(comp, n if pos < 0 else pos)
        if pos < 0:
            self.results.append(AuditResult(
                uid=comp.uid, trace_id=comp.trace_id, lane=lane,
                matched=True, n_tokens=len(served)))
            return
        K = self.engine.dcfg.block_size
        block = pos // K
        source = self._classify(lane, comp)
        self.divergences[source] += 1
        if comp.early_exited:
            self.regret += 1
        res = AuditResult(
            uid=comp.uid, trace_id=comp.trace_id, lane=lane,
            matched=False, source=source, position=pos, block=block,
            span=self._span_for_block(comp, block),
            n_tokens=len(served),
            expected=int(oracle[pos]) if pos < len(oracle) else -1,
            got=int(served[pos]) if pos < len(served) else -1)
        self.results.append(res)
        if source == "dkv-structural":
            # documented contract: dkv is not batch-invariant, a B=1
            # re-decode legitimately differs — record, don't alarm
            log.info("audit: dkv structural divergence uid=%s block=%d",
                     comp.uid, block)
        else:
            log.error("audit DIVERGENCE uid=%s lane=%s source=%s "
                      "block=%d pos=%d served=%d oracle=%d span=%r",
                      comp.uid, lane, source, block, pos, res.got,
                      res.expected, res.span)
        if self.tracer is not None:
            self.tracer.instant(
                "audit_divergence", pid=self.engine.obs_pid,
                uid=comp.uid, lane=lane, source=source, block=block,
                position=pos, span=res.span)
        if self.flight is not None and source != "dkv-structural":
            self.flight.dump(f"audit-{source}")

    def _classify(self, lane: str, comp) -> str:
        if self.engine.dcfg.method == "dkv":
            return "dkv-structural"
        if lane == "cold":
            return "cached-vs-cold"
        if comp.stolen:
            return "stolen-vs-resident"
        return "fused-vs-host"

    def _span_for_block(self, comp, block: int) -> str:
        """Attribute the divergence to the span-tree node that decoded
        the block — the ``block N`` async span the scheduler emitted on
        the request's track."""
        name = f"block {block}"
        if self.tracer is None or not comp.trace_id:
            return name
        for ev in self.tracer.request_events(comp.trace_id):
            if ev.get("name") == name:
                return name
        return f"{name} (span evicted)"

    def _calibrate(self, comp, agree_upto: int) -> None:
        """Bin each audited token's commit-time confidence; tokens
        before the first divergence agree with the oracle."""
        cc = comp.commit_conf
        if cc is None:
            return
        n = min(len(cc), len(comp.tokens))
        if n <= 0:
            return
        b = np.clip((np.asarray(cc[:n]) * CONF_BUCKETS).astype(np.int32),
                    0, CONF_BUCKETS - 1)
        for i in range(n):
            self.conf_total[b[i]] += 1
            if i < agree_upto:
                self.conf_agree[b[i]] += 1

    def _trace_step(self, name: str, t0_ns: int, comp, lane: str,
                    **kw) -> None:
        if self.tracer is not None:
            self.tracer.complete(name, t0_ns, time.perf_counter_ns(),
                                 pid=self.engine.obs_pid, uid=comp.uid,
                                 lane=lane, **kw)

    # ------------------------------------------------------ export

    def divergences_total(self) -> int:
        return sum(self.divergences.values())

    def lane_graphs(self) -> int:
        """Block programs the audit lanes built (on the card, CUDA graphs
        the cold lane captured), kept apart from the serving scheduler's
        ``graph_cache_size``."""
        return sum(d.graph_cache_size()
                   for d in list(self._lane_decoders.values()))

    def stats(self) -> dict:
        return {
            "seen": self.seen,
            "sampled": self.sampled,
            "completed": self.completed,
            "dropped": self.dropped,
            "errors": self.errors,
            "backlog": self.backlog,
            "regret": self.regret,
            "divergences": dict(self.divergences),
            "conf_agree": list(self.conf_agree),
            "conf_total": list(self.conf_total),
            "lane_graphs": self.lane_graphs(),
        }


class SLOWatchdog:
    """Rolling SLO evaluation over recent completions. Decode-thread
    writer (``observe`` from EngineLoop's completion funnel); the
    metrics endpoint reads ``current()`` under the same lock. A target
    of ``None`` disables that objective. Breaches latch a counter and
    trigger one debounced flight dump per evaluation window — never an
    exception."""

    def __init__(self, *, ttfb_p50_s: Optional[float] = None,
                 token_latency_s: Optional[float] = None,
                 goodput_tok_s: Optional[float] = None,
                 window: int = 64, min_requests: int = 8,
                 flight: Optional["FlightRecorder"] = None):
        self.targets = {"ttfb_p50_s": ttfb_p50_s,
                        "token_latency_s": token_latency_s,
                        "goodput_tok_s": goodput_tok_s}
        self.window = window
        self.min_requests = min_requests
        self.flight = flight
        self.breaches: Dict[str, int] = {k: 0 for k in self.targets}
        self._breached: Dict[str, bool] = {k: False for k in self.targets}
        self._recent: deque = deque(maxlen=window)
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return any(v is not None for v in self.targets.values())

    def observe(self, comp) -> None:
        """Register one completion and re-evaluate. Never raises."""
        try:
            self._observe(comp)
        except Exception:
            log.exception("SLO watchdog observe failed")

    def _observe(self, comp) -> None:
        if not self.enabled or comp.cancelled:
            return
        with self._lock:
            self._recent.append(
                (time.perf_counter(), comp.ttfb_s,
                 comp.latency_s / max(comp.n_tokens, 1), comp.n_tokens))
            state = self._evaluate()
        for key, (value, breach) in state.items():
            was = self._breached[key]
            self._breached[key] = breach
            if breach and not was:
                self.breaches[key] += 1
                log.warning("SLO breach: %s=%.4f vs target %.4f",
                            key, value, self.targets[key])
                if self.flight is not None:
                    self.flight.dump(f"slo-{key}")

    def _evaluate(self) -> Dict[str, tuple]:
        if len(self._recent) < self.min_requests:
            return {}
        rows = list(self._recent)
        out: Dict[str, tuple] = {}
        t = self.targets
        if t["ttfb_p50_s"] is not None:
            v = float(np.percentile([r[1] for r in rows], 50))
            out["ttfb_p50_s"] = (v, v > t["ttfb_p50_s"])
        if t["token_latency_s"] is not None:
            v = float(np.percentile([r[2] for r in rows], 50))
            out["token_latency_s"] = (v, v > t["token_latency_s"])
        if t["goodput_tok_s"] is not None:
            span_s = max(rows[-1][0] - rows[0][0], 1e-9)
            v = sum(r[3] for r in rows[1:]) / span_s
            out["goodput_tok_s"] = (v, v < t["goodput_tok_s"])
        return out

    def current(self) -> dict:
        """Gauge snapshot for ``repro_slo_*`` exposition."""
        with self._lock:
            state = self._evaluate()
        return {
            "targets": {k: v for k, v in self.targets.items()
                        if v is not None},
            "values": {k: v for k, (v, _) in state.items()},
            "breached": {k: int(b) for k, (_, b) in state.items()},
            "breaches_total": dict(self.breaches),
            "window": len(self._recent),
        }


class FlightRecorder:
    """Post-mortem dump sink. ``dump(reason)`` writes one
    ``flight-NNN-<reason>/`` directory under ``flight_dir`` holding

    * ``trace.json`` — the tracer's ring buffers as Perfetto-loadable
      Chrome trace JSON (whatever survived eviction);
    * ``metrics.json`` — every engine's metrics snapshot, telemetry
      rollup, audit stats, and SLO state;
    * ``state.json`` — per-engine scheduler/gang occupancy
      (``BlockScheduler.debug_state``).

    Debounced (``min_interval_s``) and capped (``max_dumps``) so a
    flapping SLO can't fill the disk. Never raises — a failed dump is
    logged and dropped, the serving path continues."""

    def __init__(self, flight_dir: str, tracer=None, *,
                 min_interval_s: float = 10.0, max_dumps: int = 32):
        self.flight_dir = flight_dir
        self.tracer = tracer
        self.min_interval_s = min_interval_s
        self.max_dumps = max_dumps
        self.dumps = 0
        self.suppressed = 0          # debounced / over-cap requests
        self._last_dump = -float("inf")
        self._lock = threading.Lock()
        # () -> dict of JSON-safe state; wired by the server front end
        # (engine metrics + scheduler debug_state + audit/SLO stats)
        self.state_provider: Optional[Callable[[], dict]] = None

    def dump(self, reason: str, force: bool = False) -> Optional[str]:
        """Write one dump; returns its directory or None when debounced
        or failed. Safe from any thread."""
        try:
            return self._dump(reason, force)
        except Exception:
            log.exception("flight dump failed (reason=%s)", reason)
            return None

    def _dump(self, reason: str, force: bool) -> Optional[str]:
        with self._lock:
            now = time.monotonic()
            if not force and (now - self._last_dump < self.min_interval_s
                              or self.dumps >= self.max_dumps):
                self.suppressed += 1
                return None
            self._last_dump = now
            seq = self.dumps
            self.dumps += 1
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:64]
        path = os.path.join(self.flight_dir, f"flight-{seq:03d}-{safe}")
        os.makedirs(path, exist_ok=True)
        if self.tracer is not None:
            self.tracer.export(os.path.join(path, "trace.json"))
        state = {}
        if self.state_provider is not None:
            try:
                state = self.state_provider()
            except Exception:
                log.exception("flight state provider failed")
                state = {"error": "state provider failed"}
        meta = {"reason": reason, "seq": seq,
                "unix_time": time.time(),
                "dumps": self.dumps, "suppressed": self.suppressed}
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump({"meta": meta,
                       "engines": state.get("engines", []),
                       "slo": state.get("slo")}, f, indent=1)
        with open(os.path.join(path, "state.json"), "w") as f:
            json.dump({"meta": meta,
                       "schedulers": state.get("schedulers", []),
                       "loops": state.get("loops", [])}, f, indent=1)
        if state.get("timeline") is not None:
            # repro_torch.obs.series: the breach window's rate series — the
            # minutes leading up to the trigger, not just its instant
            with open(os.path.join(path, "timeline.json"), "w") as f:
                json.dump({"meta": meta,
                           "timeline": state["timeline"]}, f, indent=1)
        log.warning("flight dump written: %s (reason=%s)", path, reason)
        return path
