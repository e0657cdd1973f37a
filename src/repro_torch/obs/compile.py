"""Graph-capture accounting: the PyTorch counterpart of
``repro.obs.compile``'s per-engine ledger.

On the card every new (B, T, Sq, block start) shape is a block program
whose CUDA graph is captured at its first use (about 1.6 s per block at
llada-8b full depth), so a capture inside a timed decode stalls every
gang the same way an XLA compile does in the JAX package. The ledger is
the same:

* ``CompileWatch`` — one per ``BlockScheduler``. Every call site that
  can build a block program (prefill, decode_block, the engine's
  pre-warm) is wrapped so the scheduler-wide ``graph_cache_size()``
  delta (the sum of ``DiffusionDecoder.graph_cache_size()`` over its
  decoders) attributes new graphs to the call that captured them, with
  its wall time. After ``mark_warm()`` (the startup pre-warm finished),
  any further capture is a *post-warmup capture*: counted, logged
  loudly, and mirrored into ``ServeMetrics.post_warm_compiles``.

The JAX module's process-wide listeners on jax's persistent
compilation-cache events (``_on_event``, ``watch_persistent_cache``,
``persistent_cache_counters``) have no counterpart: the port keeps no
on-disk cache of graphs, so there is nothing to count.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.obs.log import get_logger

log = get_logger("obs.compile")


class CompileWatch:
    """Single-writer ledger (the owning engine's decode thread); the
    plain-int counters are mirrored into ``ServeMetrics`` each engine
    step, so cross-thread readers go through the metrics snapshot."""

    def __init__(self) -> None:
        self.misses = 0          # new block graphs (the graph cache grew)
        self.hits = 0            # calls served by graphs already captured
        self.seconds = 0.0       # wall attributed to capturing calls
        self.warm = False        # pre-warm declared complete
        self.post_warm = 0       # graphs captured after mark_warm()

    def mark_warm(self) -> None:
        self.warm = True

    def counters(self) -> dict:
        """JSON-safe ledger snapshot (debug_state / flight dumps)."""
        return {"misses": self.misses, "hits": self.hits,
                "seconds": self.seconds, "warm": self.warm,
                "post_warm": self.post_warm}

    def watched(self, thunk: Callable, sizer: Callable[[], int],
                what: str, tracer=None, pid: int = 0):
        """Run ``thunk``; attribute any graph-cache growth (measured via
        ``sizer``) to it. Emits a retrospective ``compile`` span on the
        engine's thread track when graphs were captured, so warm vs cold
        calls are visually distinct in the trace."""
        before = sizer()
        t0_ns = time.perf_counter_ns()
        out = thunk()
        t1_ns = time.perf_counter_ns()
        self.observe(sizer() - before, (t1_ns - t0_ns) / 1e9, what,
                     tracer=tracer, pid=pid, t0_ns=t0_ns, t1_ns=t1_ns)
        return out

    def observe(self, delta: int, wall_s: float, what: str, *,
                tracer=None, pid: int = 0,
                t0_ns: Optional[int] = None,
                t1_ns: Optional[int] = None) -> None:
        if delta <= 0:
            self.hits += 1
            return
        self.misses += delta
        self.seconds += wall_s
        if tracer is not None and t0_ns is not None:
            tracer.complete("compile", t0_ns, t1_ns, pid=pid,
                            variants=delta, what=what)
        if self.warm:
            self.post_warm += delta
            log.warning(
                "post-warmup capture: %d new block graph(s) in %s (%.2fs) — "
                "pre-warm missed a (bucket, batch, block) shape",
                delta, what, wall_s)
