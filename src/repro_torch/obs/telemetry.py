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

The aggregator, the series recorder and the auditor that consume these
records in the JAX package are ported with the observability layer
(ROADMAP A9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

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
