"""Spatial component of Streaming-dLLM: attenuation-guided suffix
modeling (Eq. 7-8).

When decoding block ``c`` of a generation of ``L`` tokens starting at
``gen_start`` (= prompt length), the model's query region is

    [ current block (K tokens) | suffix window (w_c tokens) | trailing ]

where ``w_c = min(w, remaining_suffix)`` and the trailing slot carries
the *final* position id ``gen_start + L - 1`` (the paper's termination /
length cue, Table 6) — included only when the window does not already
reach the end. All positions are explicit so RoPE keeps the logical
ordering (paper: "maintaining the logical ordering of tokens via RoPE
position IDs").

These are host-side index computations (ints), so each block's query
shape is exact; the compiled steady-state shape used by the production
``serve_step`` is K + w + 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class QueryRegion:
    block_idx: int
    block_start: int          # absolute position of the block's first token
    block_size: int
    suffix_start: int
    suffix_len: int           # w_c
    trailing_pos: int         # -1 if absent
    positions: np.ndarray     # (Sq,) absolute position ids

    @property
    def query_len(self) -> int:
        return self.positions.shape[0]


def suffix_query_region(*, gen_start: int, gen_len: int, block_size: int,
                        block_idx: int, window: int) -> QueryRegion:
    """window: suffix tokens retained (paper's w, in tokens). window < 0
    means "no pruning" (full suffix — the Fast-dLLM/vanilla layout)."""
    n_blocks = gen_len // block_size
    assert 0 <= block_idx < n_blocks
    bs = gen_start + block_idx * block_size
    suffix_start = bs + block_size
    end = gen_start + gen_len
    remaining = end - suffix_start
    w = remaining if window < 0 else min(window, remaining)
    trailing = -1
    if w < remaining:
        trailing = end - 1
    pos = list(range(bs, bs + block_size)) + list(range(suffix_start,
                                                        suffix_start + w))
    if trailing >= 0:
        pos.append(trailing)
    return QueryRegion(block_idx, bs, block_size, suffix_start, w, trailing,
                       np.asarray(pos, np.int32))


def steady_state_query_len(block_size: int, window: int) -> int:
    """Static query length for the compiled production serve_step."""
    return block_size + max(window, 0) + 1
