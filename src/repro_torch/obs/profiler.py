"""``torch.profiler`` start/stop around the first N decoded blocks (the
PyTorch counterpart of ``repro.obs.profiler``).

``--profile-blocks N`` captures a host + device profile of exactly the
steady-state region that matters (skipping graph captures is the
caller's job — prewarm before serving). The capture records the CPU
activity and, when a CUDA device is present, the card's kernels (CUPTI;
kernels replayed inside a block's CUDA graph appear under their own
names), and is written as a Chrome trace (Perfetto-loadable) under
``<trace_dir>/torch_profile/``; it complements the host-side span trace
the :class:`~repro_torch.obs.trace.Tracer` exports.

Failure to start the profiler (no CUPTI, a second profiler already
live) degrades to a no-op with a warning — observability must never
take down serving.
"""
from __future__ import annotations

import os

from repro_torch.obs.log import get_logger

log = get_logger(__name__)


class BlockProfiler:
    """Counts decoded blocks; profiles the first ``n_blocks`` of them.

    Call ``tick(k)`` with the number of blocks decoded since the last
    tick (0 is fine and cheap). The first tick with work starts the
    capture; the tick that crosses ``n_blocks`` stops it and writes
    ``trace_path``. ``close()`` stops a capture left running at
    shutdown. Start, stop and export all run on the thread that ticks
    (the engine's decode thread).
    """

    def __init__(self, trace_dir: str, n_blocks: int):
        self.trace_dir = os.path.join(trace_dir, "torch_profile")
        self.trace_path = os.path.join(self.trace_dir, "trace.json")
        self.n_blocks = n_blocks
        self.seen = 0
        self.active = False
        self.done = n_blocks <= 0
        self._prof = None

    def tick(self, blocks_decoded: int) -> None:
        if self.done:
            return
        if not self.active and blocks_decoded > 0:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                os.makedirs(self.trace_dir, exist_ok=True)
                self._prof = profile(activities=activities)
                self._prof.start()
                self.active = True
                log.info("torch profiler started",
                         extra={"trace_dir": self.trace_dir,
                                "profile_blocks": self.n_blocks})
            except Exception as e:
                log.warning("torch profiler unavailable: %s", e)
                self._prof = None
                self.done = True
                return
        self.seen += blocks_decoded
        if self.active and self.seen >= self.n_blocks:
            self._stop()

    def _stop(self) -> None:
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(self.trace_path)
            log.info("torch profiler stopped",
                     extra={"blocks": self.seen,
                            "trace_path": self.trace_path})
        except Exception as e:   # pragma: no cover - defensive
            log.warning("torch profiler stop failed: %s", e)
        self._prof = None
        self.active = False
        self.done = True

    def close(self) -> None:
        if self.active:
            self._stop()
