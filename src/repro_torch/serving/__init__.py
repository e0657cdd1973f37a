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
    DecodeExecutor    — placement on a mesh of ranks: sharded params and
                        caches, this rank's rows of each gang

Built on the resumable ``DiffusionDecoder.prefill`` / ``decode_block`` /
``take_rows`` / ``merge_rows`` API in ``repro_torch.core.decoder``. The
synchronous path is ``repro_torch.core.engine.ServingEngine(mode="batch")``.
The prefix KV store is ``repro_torch.cache``; fleets of engines (work
stealing, prefill/decode pools) are ``repro_torch.server.EngineRouter``.
"""
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.executor import DecodeExecutor
from repro_torch.serving.metrics import RequestMetrics, ServeMetrics, percentile
from repro_torch.serving.pool import PrefixKVPool
from repro_torch.serving.scheduler import BlockScheduler, Gang
from repro_torch.serving.stream import RequestStream, StreamRouter
from repro_torch.serving.types import (BlockChunk, Completion, ServeRequest,
                                       round_up_blocks)

__all__ = [
    "ContinuousEngine", "DecodeExecutor", "BlockScheduler", "Gang", "PrefixKVPool",
    "StreamRouter", "RequestStream", "ServeMetrics", "RequestMetrics",
    "percentile", "BlockChunk", "Completion", "ServeRequest",
    "round_up_blocks",
]
