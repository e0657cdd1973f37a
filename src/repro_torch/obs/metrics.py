"""Bucketed histograms and device memory gauges (the PyTorch counterpart
of ``repro.obs.metrics``).

``Histogram`` follows the Prometheus model: cumulative bucket counters
(``le`` upper bounds, a ``+Inf`` catch-all), a running sum, and a
count. ``observe`` is lock-guarded — the decode thread observes while
a reader renders the exposition — and cheap enough for the
per-request/per-block call rates here (a bisect plus three int adds).

``device_memory_stats`` reads ``torch.cuda.memory_stats`` for every CUDA
device and reports it under the JAX package's keys (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``) beside PyTorch's own; with no
CUDA device it returns ``{}`` rather than raising, so a metrics reader
works everywhere.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Tuple

import torch

# Default bounds (seconds) tuned to the latencies this stack sees on
# CPU: sub-ms queue waits up to multi-second block decodes.
LATENCY_BUCKETS_S = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# NFE per generated token is bounded by steps_per_block (≤ block size).
NFE_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


class Histogram:
    """Thread-safe cumulative histogram with Prometheus exposition."""

    def __init__(self, name: str, help_text: str,
                 buckets: Iterable[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help_text = help_text
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        # counts[i] = observations <= bounds[i]; counts[-1] = +Inf
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. +Inf, sum, count) — consistent."""
        with self._lock:
            return list(self._counts), self._sum, self._n

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same bounds) into this one — used
        to pool per-engine histograms into an aggregate series."""
        if other.bounds != self.bounds:
            raise ValueError("histogram bucket bounds differ")
        counts, s, n = other.snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += s
            self._n += n

    def prometheus(self, labels: str = "") -> List[str]:
        """Exposition lines. ``labels`` is a pre-rendered label body
        (e.g. ``engine="0"``) merged with the ``le`` label."""
        counts, s, n = self.snapshot()
        lines = [f"# HELP {self.name} {self.help_text}",
                 f"# TYPE {self.name} histogram"]
        sep = "," if labels else ""
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{self.name}_bucket{{{labels}{sep}le="{bound}"}}'
                         f' {cum}')
        lines.append(f'{self.name}_bucket{{{labels}{sep}le="+Inf"}} {n}')
        body = f"{{{labels}}}" if labels else ""
        lines.append(f"{self.name}_sum{body} {s}")
        lines.append(f"{self.name}_count{body} {n}")
        return lines


# the card's total memory per device index, read once: a device
# property, so /metrics needs no CUDA API call to report it
_BYTES_LIMIT: Dict[int, int] = {}


def _bytes_limit(i: int) -> int:
    if i not in _BYTES_LIMIT:
        _BYTES_LIMIT[i] = int(torch.cuda.get_device_properties(i)
                              .total_memory)
    return _BYTES_LIMIT[i]


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device allocator stats keyed ``"cuda:<index>"``, under the
    keys the front end's ``repro_device_*`` series read (the JAX
    package's names): ``bytes_in_use`` and ``peak_bytes_in_use`` from the
    caching allocator's ``allocated_bytes.all.current`` / ``.peak``,
    ``bytes_limit`` the card's total memory; beside them every numeric
    ``torch.cuda.memory_stats`` entry under PyTorch's own key. Reads the
    allocator's host-side counters only (no ``mem_get_info``, no
    synchronize), so a metrics scrape on another thread cannot disturb a
    graph capture on the decode thread. Empty without a CUDA device."""
    if not torch.cuda.is_available():
        return {}
    out: Dict[str, Dict[str, float]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        row = {k: float(v) for k, v in stats.items()
               if isinstance(v, (int, float))}
        row["bytes_in_use"] = row.get("allocated_bytes.all.current", 0.0)
        row["peak_bytes_in_use"] = row.get("allocated_bytes.all.peak", 0.0)
        row["bytes_limit"] = float(_bytes_limit(i))
        out[f"cuda:{i}"] = row
    return out
