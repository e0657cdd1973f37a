"""GQA head-padding for tensor parallelism.

Megatron-style TP requires head counts divisible by the TP degree.
Several assigned architectures have 24/56/4 heads with tp=16. We pad to
the smallest semantically-equivalent layout:

  * q heads are zero-padded (zero q/o weights -> the padded heads emit
    exactly zero through the output projection; softmax over zero scores
    is uniform and harmless).
  * kv heads are duplicated (exact for GQA: splitting a group's queries
    among identical kv copies is a no-op) and/or zero-group padded.

``plan_heads`` returns the padded layout; ``models.layers`` builds
weights at the padded sizes with the real sub-block initialized.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    n_q: int            # nominal query heads
    n_kv: int           # nominal kv heads
    pad_q: int          # padded query heads (divisible by tp)
    pad_kv: int         # padded kv heads (divisible by tp or == nominal)
    kv_dup: int         # duplication factor applied to each kv head
    kv_zero_groups: int  # zero-padded kv groups appended
    tp: int

    @property
    def group(self) -> int:
        """Padded q heads per padded kv head."""
        return self.pad_q // self.pad_kv


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_heads(n_q: int, n_kv: int, tp: int) -> HeadPlan:
    assert n_q % n_kv == 0, (n_q, n_kv)
    if tp <= 1 or (n_q % tp == 0 and n_kv % tp == 0):
        return HeadPlan(n_q, n_kv, n_q, n_kv, 1, 0, tp)
    p = n_q // n_kv
    if tp % n_kv == 0:
        g_pad, dup = n_kv, tp // n_kv
    elif n_kv % tp == 0:
        g_pad, dup = n_kv, 1
    else:
        g_pad, dup = _ceil_to(n_kv, tp), 1  # append zero groups
    # pad q-per-group so q splits evenly among duplicated kv heads and tp
    pp = p
    while pp % dup != 0 or (g_pad * pp) % tp != 0:
        pp += 1
    return HeadPlan(n_q, n_kv, g_pad * pp, g_pad * dup, dup, g_pad - n_kv, tp)
