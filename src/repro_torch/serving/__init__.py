"""Continuous-batching serving subsystem at diffusion-block granularity
(the PyTorch counterpart of ``repro.serving``).

Layering:
    ContinuousEngine  — user API: submit / step / stream / metrics /
                        prewarm (captures the block graphs up front)
    BlockScheduler    — gangs, admission control, compaction, preemption,
                        cross-gang straggler merge
    PrefixKVPool      — shape-bucketed KV buffers for the states that own
                        one (dkv); every other method runs on the
                        decoder's bound buffer
    StreamRouter      — per-block chunk callbacks / iterators
    ServeMetrics      — TTFB, latency percentiles, occupancy, NFE

Built on the resumable ``DiffusionDecoder.prefill`` / ``decode_block`` /
``take_rows`` / ``merge_rows`` API in ``repro_torch.core.decoder``. The
synchronous path is ``repro_torch.core.engine.ServingEngine(mode="batch")``.
The JAX package's ``DecodeExecutor`` (ROADMAP A11) and ``PrefixKVCache``
(A7) are not ported yet.
"""
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.metrics import RequestMetrics, ServeMetrics, percentile
from repro_torch.serving.pool import PrefixKVPool
from repro_torch.serving.scheduler import BlockScheduler, Gang
from repro_torch.serving.stream import RequestStream, StreamRouter
from repro_torch.serving.types import (BlockChunk, Completion, ServeRequest,
                                       round_up_blocks)

__all__ = [
    "ContinuousEngine", "BlockScheduler", "Gang", "PrefixKVPool",
    "StreamRouter", "RequestStream", "ServeMetrics", "RequestMetrics",
    "percentile", "BlockChunk", "Completion", "ServeRequest",
    "round_up_blocks",
]
