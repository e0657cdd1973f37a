"""Observability of the port (counterpart of ``repro.obs``):

    trace      — request span trees and per-thread timelines, exported
                 as Chrome-trace JSON (``Tracer``, ``span``).
    telemetry  — per-block decode dynamics (``BlockStats``) harvested in
                 the block's one host sync, aggregated per (method,
                 block index) (``TelemetryAggregator``).
    metrics    — bucketed ``Histogram`` counters and the CUDA
                 allocator's memory stats under the reference's keys.
    log        — JSON-lines structured logging under ``repro_torch``.
    compile    — the ledger of CUDA-graph captures (``CompileWatch``).
    profiler   — ``torch.profiler`` start/stop around the first N
                 decoded blocks (``--profile-blocks N``).
    audit      — shadow-oracle re-decode of sampled completions (host
                 loop and cache-bypass lanes), confidence calibration,
                 the SLO watchdog and the flight recorder.
    series     — per-engine ``MetricsRecorder`` rate series behind
                 ``GET /debug/timeline`` and ``GET /console``, with
                 optional ``--metrics-log`` JSONL persistence.

The JAX package's persistent compilation-cache counters have no
counterpart: the port's CUDA graphs are not persisted.
"""
from repro_torch.obs.audit import (AuditConfig, AuditResult, FlightRecorder,
                                   ShadowAuditor, SLOWatchdog)
from repro_torch.obs.compile import CompileWatch
from repro_torch.obs.log import get_logger, setup_logging
from repro_torch.obs.metrics import Histogram, device_memory_stats
from repro_torch.obs.profiler import BlockProfiler
from repro_torch.obs.series import (JsonlSink, MetricsRecorder, fleet_series,
                                    timeline_doc)
from repro_torch.obs.telemetry import (CONF_BUCKETS, BlockStats,
                                       TelemetryAggregator)
from repro_torch.obs.trace import Tracer, TraceFlusher, span

__all__ = [
    "Tracer", "TraceFlusher", "span", "BlockStats", "TelemetryAggregator",
    "CONF_BUCKETS", "Histogram", "device_memory_stats", "BlockProfiler",
    "CompileWatch", "get_logger", "setup_logging",
    "AuditConfig", "AuditResult", "ShadowAuditor", "SLOWatchdog",
    "FlightRecorder",
    "MetricsRecorder", "JsonlSink", "fleet_series", "timeline_doc",
]
