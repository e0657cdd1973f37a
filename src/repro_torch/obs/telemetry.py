"""Per-block diffusion-dynamics telemetry (the decoder's ``BlockStats``).

Per decoded block the decoder appends one :class:`BlockStats` to
``DecodeState.block_stats``:

* ``committed_per_step[s]`` — tokens committed by confidence/rate
  selection at device step ``s`` (non-done rows only);
* ``straggler_fill`` — tokens force-committed by the end-of-schedule
  straggler finalize (so ``sum(committed_per_step) + straggler_fill ==
  live_rows * block_size`` always holds);
* ``conf_hist`` — histogram of the confidences of committed tokens
  over :data:`CONF_BUCKETS` equal buckets spanning [0, 1];
* ``steps`` vs ``steps_cap`` — device steps used vs the schedule max;
* ``window`` — suffix/query window size (``Sq``); ``early_exits`` —
  rows that hit the early-exit test.

:class:`TelemetryAggregator` accumulates those records per
``(method, block_index)`` under a lock (the decode thread writes, a
metrics reader snapshots). The series recorder and the auditor that
consume these records in the JAX package wait for ROADMAP A9.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# Confidence-histogram bucket count over [0, 1). Bucket i covers
# [i/CONF_BUCKETS, (i+1)/CONF_BUCKETS); conf == 1.0 clamps into the
# last bucket.
CONF_BUCKETS = 10


@dataclass
class BlockStats:
    """Dynamics of one decoded block (one ``decode_block`` call)."""
    method: str
    block_idx: int
    batch: int                    # gang batch lanes (incl. padding)
    live_rows: int                # rows not done at block start
    steps: int                    # device steps actually run
    steps_cap: int                # τ-schedule maximum for this block
    committed_per_step: List[int]
    straggler_fill: int           # force-committed at finalize
    conf_hist: List[int]          # len == CONF_BUCKETS
    window: int                   # suffix/query window Sq
    early_exits: int              # rows that early-exited this block
    wall_s: float                 # host wall time of the block call
    # (B, block_size) float32: the confidence each lane's token carried
    # when it was committed (straggler fills record the last step's
    # confidence).
    commit_conf: object = None

    @property
    def tokens_committed(self) -> int:
        return sum(self.committed_per_step) + self.straggler_fill

    @property
    def nfe(self) -> int:
        return self.steps * self.live_rows


@dataclass
class _Agg:
    """Accumulated dynamics for one (method, block index) key."""
    blocks: int = 0
    live_rows: int = 0
    steps: int = 0
    steps_cap: int = 0
    tokens: int = 0
    straggler_fill: int = 0
    early_exits: int = 0
    wall_s: float = 0.0
    window: int = 0
    committed_per_step: List[int] = field(default_factory=list)
    conf_hist: List[int] = field(
        default_factory=lambda: [0] * CONF_BUCKETS)

    def add(self, bs: BlockStats) -> None:
        self.blocks += 1
        self.live_rows += bs.live_rows
        self.steps += bs.steps
        self.steps_cap += bs.steps_cap
        self.tokens += bs.tokens_committed
        self.straggler_fill += bs.straggler_fill
        self.early_exits += bs.early_exits
        self.wall_s += bs.wall_s
        self.window = bs.window
        if len(bs.committed_per_step) > len(self.committed_per_step):
            self.committed_per_step.extend(
                [0] * (len(bs.committed_per_step)
                       - len(self.committed_per_step)))
        for i, c in enumerate(bs.committed_per_step):
            self.committed_per_step[i] += c
        for i, c in enumerate(bs.conf_hist):
            self.conf_hist[i] += c

    def row(self) -> dict:
        return {
            "blocks": self.blocks,
            "steps_mean": self.steps / max(self.blocks, 1),
            "steps_cap_mean": self.steps_cap / max(self.blocks, 1),
            "tokens": self.tokens,
            "straggler_fill": self.straggler_fill,
            "early_exits": self.early_exits,
            "wall_s": self.wall_s,
            "window": self.window,
            "committed_per_step": list(self.committed_per_step),
            "conf_hist": list(self.conf_hist),
        }


class TelemetryAggregator:
    """Thread-safe per-(method, block index) accumulator of
    :class:`BlockStats`. ``add`` is called from the decode thread per
    block; ``summary``/``totals`` snapshot under the same lock from
    the metrics reader."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_key: Dict[Tuple[str, int], _Agg] = {}
        self.blocks = 0

    def add(self, bs: BlockStats) -> None:
        with self._lock:
            agg = self._by_key.get((bs.method, bs.block_idx))
            if agg is None:
                agg = self._by_key[(bs.method, bs.block_idx)] = _Agg()
            agg.add(bs)
            self.blocks += 1

    def extend(self, stats: List[BlockStats]) -> None:
        for bs in stats:
            self.add(bs)

    def summary(self) -> dict:
        """``{"method/block_idx": row}`` snapshot, key-sorted."""
        with self._lock:
            items = sorted(self._by_key.items())
            return {f"{m}/{b}": agg.row() for (m, b), agg in items}

    def totals(self) -> dict:
        """Cross-key rollup (drives /metrics gauges)."""
        with self._lock:
            aggs = list(self._by_key.values())
        steps = sum(a.steps for a in aggs)
        caps = sum(a.steps_cap for a in aggs)
        tokens = sum(a.tokens for a in aggs)
        hist = [0] * CONF_BUCKETS
        for a in aggs:
            for i, c in enumerate(a.conf_hist):
                hist[i] += c
        return {
            "blocks": sum(a.blocks for a in aggs),
            "steps": steps,
            "steps_cap": caps,
            "steps_saved_frac": 1.0 - steps / caps if caps else 0.0,
            "tokens": tokens,
            "straggler_fill": sum(a.straggler_fill for a in aggs),
            "early_exits": sum(a.early_exits for a in aggs),
            "wall_s": sum(a.wall_s for a in aggs),
            "conf_hist": hist,
        }
