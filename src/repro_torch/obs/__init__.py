"""Observability of the port (counterpart of ``repro.obs``):

    trace      — request span trees and per-thread timelines, exported
                 as Chrome-trace JSON (``Tracer``, ``span``).
    telemetry  — per-block decode dynamics (``BlockStats``) harvested in
                 the block's one host sync, aggregated per (method,
                 block index) (``TelemetryAggregator``).
    metrics    — bucketed ``Histogram`` counters and the CUDA
                 allocator's memory stats.
    log        — JSON-lines structured logging under ``repro_torch``.
    compile    — the ledger of CUDA-graph captures (``CompileWatch``).

The profiler hooks, the shadow auditor and the metric time series are
ROADMAP A9.
"""
from repro_torch.obs.compile import CompileWatch
from repro_torch.obs.log import get_logger, setup_logging
from repro_torch.obs.metrics import Histogram, device_memory_stats
from repro_torch.obs.telemetry import (CONF_BUCKETS, BlockStats,
                                       TelemetryAggregator)
from repro_torch.obs.trace import Tracer, TraceFlusher, span

__all__ = [
    "Tracer", "TraceFlusher", "span", "BlockStats", "TelemetryAggregator",
    "CONF_BUCKETS", "Histogram", "device_memory_stats", "CompileWatch",
    "get_logger", "setup_logging",
]
