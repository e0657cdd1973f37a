"""Request/response records shared across the serving subsystem (copy
of ``repro.serving.types``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.decoder import round_up_blocks  # re-export; single def

__all__ = ["ServeRequest", "BlockChunk", "Completion", "round_up_blocks"]


@dataclasses.dataclass
class ServeRequest:
    """One queued generation request plus its lifecycle timestamps."""
    uid: int
    prompt_tokens: np.ndarray          # (P,) int32
    gen_len: int                       # rounded up to a block multiple
    max_tokens: int
    submit_time: float
    admit_time: float = -1.0
    first_block_time: float = -1.0     # TTFB anchor
    finish_time: float = -1.0
    nfe: int = 0                       # batch steps while this row was live
    blocks_decoded: int = 0
    preempted: int = 0                 # times kicked back to the queue
    eos_seen: bool = False             # a streamed chunk contained EOS
    host_syncs: int = 0                # device->host sync points attributed
    logit_syncs: int = 0               # ... of which full-logit copies
    expected_hit_tokens: int = 0       # prefix-cache match at submit time
    cache_hit_tokens: int = 0          # prompt tokens whose prefill KV was
                                       # assembled from the cross-request
                                       # prefix cache (0 = cold)
    trace_id: str = ""                 # obs correlation id ("" = off)
    stolen: int = 0                    # times adopted mid-decode by another
                                       # engine (adopt_paused)
    handoffs: int = 0                  # times migrated prefill→decode pool
                                       # (disaggregated serving; KV travels
                                       # through the shared radix store)
    commit_conf: list = dataclasses.field(default_factory=list)
                                       # per harvested block: (K,) float32
                                       # commit-time confidences for this
                                       # row (repro.obs.audit calibration)

    @property
    def bucket(self):
        """Shape bucket: requests sharing it can decode in one batch."""
        return (int(self.prompt_tokens.shape[0]), self.gen_len)


@dataclasses.dataclass
class BlockChunk:
    """One streamed block of committed tokens for a request. ``tokens``
    are the raw block tokens (may extend past EOS); ``text`` is the
    EOS-truncated decoded piece. ``finished`` marks the request's last
    chunk."""
    uid: int
    block_idx: int
    tokens: np.ndarray
    text: str
    finished: bool
    eos: bool                          # this block decoded an EOS


@dataclasses.dataclass
class Completion:
    """Terminal record for a request (superset of the legacy
    ``repro_torch.core.engine.Completion`` field names). ``tokens`` and
    ``text`` are trimmed to the *requested* ``max_tokens``, not the
    block-rounded ``gen_len`` — network front ends must never
    over-return. Cancelled
    requests (explicit cancel, client disconnect, deadline expiry)
    carry whatever was committed before the cancel took effect."""
    uid: int
    text: str
    tokens: np.ndarray                 # (<= max_tokens,) EOS-truncated
    latency_s: float                   # submit -> finish
    nfe: int
    ttfb_s: float = 0.0                # submit -> first block committed
    queue_s: float = 0.0               # submit -> admitted to a slot
    n_tokens: int = 0                  # non-EOS tokens generated
    n_blocks: int = 0
    max_tokens: int = 0                # requested budget (pre-rounding)
    cancelled: bool = False            # partial result: freed early
    host_syncs: int = 0                # host sync points while live
    logit_syncs: int = 0               # (B, K, V) logit copies while live
    cache_hit_tokens: int = 0          # prefix-cache tokens reused at
                                       # prefill (repro.cache)
    expected_hit_tokens: int = 0       # router/admission-time estimate
    trace_id: str = ""                 # obs correlation id ("" = off)
    prompt_tokens: Optional[np.ndarray] = None
                                       # (P,) int32 — kept so the shadow
                                       # auditor can re-decode the request
    commit_conf: Optional[np.ndarray] = None
                                       # (n_blocks*K,) float32 commit-time
                                       # confidences (untrimmed gen axis)
    stolen: bool = False               # decoded partly on an adopting engine
    handed_off: bool = False           # primed on a prefill-pool engine,
                                       # decoded on a decode-pool engine
    early_exited: bool = False         # an EOS block skipped later blocks

    @property
    def tokens_per_s(self) -> float:
        return self.n_tokens / max(self.latency_s, 1e-9)
