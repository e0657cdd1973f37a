"""Binding of the CUDA C++ confidence kernel (``csrc/confidence.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/confidence.py``
(``_kernel`` / ``confidence_argmax``): per row of logits, the first index
of the row's maximum and ``conf = 1 / max(sum exp(x - max), 1e-30)``, the
largest softmax probability. The kernel takes bf16 or float32 logits and
bans one column (``mask_id``); its source says what bounds it on the H100
and how its design answers that. ``launch_plan`` is its host-side
geometry, pure Python so the CPU tests reach it. Its split count
depends on (V, dtype) and the card only, never on the row count, so a
row's partial sums merge the same way whatever batch it sits in: the
continuous scheduler's gangs change size, and a row's ``conf`` must not
change its last bits with them.

This module only launches the kernels: ``kernels.ops.confidence_argmax``
is the checked, counted entry.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# must match csrc/confidence.cu
THREADS = 256
MAX_SPLITS = 64
CTAS_PER_SM = 4           # __launch_bounds__(THREADS, 4)
VEC_BYTES = 16
MIN_SPLIT_VECTORS = 1024  # 4 vectors (64 bytes) per thread of a split's CTA
H100_SMS = 132
# rows the split count is sized for: the main path's largest gang
# (4 requests x 32-token block), whose grid is then one full wave
REF_ROWS = 128


@dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one launch: grid (N, splits), ``THREADS`` threads.
    A row's vector body (16-byte vectors of ``vec`` values from its first
    16-byte boundary, column ``a0``) is cut into ``splits`` runs of
    ``chunk`` vectors; split 0 also takes the columns before ``a0`` and
    the last split the columns after the body."""
    vec: int              # values per 16-byte vector
    splits: int
    chunk: int            # vectors per split
    grid: tuple

    def columns(self, V: int, a0: int):
        """Per split, the column ranges ``[lo, hi)`` it reads, for a row
        whose first 16-byte boundary is at column ``a0`` (< ``vec``):
        what the kernel's index arithmetic gives."""
        a0 = min(a0, V)
        nvec = (V - a0) // self.vec
        tail = a0 + nvec * self.vec
        out = []
        for y in range(self.splits):
            lo = min(y * self.chunk, nvec)
            hi = min(lo + self.chunk, nvec)
            ranges = [(0, a0)] if y == 0 and a0 else []
            if hi > lo:
                ranges.append((a0 + lo * self.vec, a0 + hi * self.vec))
            if y == self.splits - 1 and tail < V:
                ranges.append((tail, V))
            out.append(ranges)
        return out


@functools.lru_cache(maxsize=256)
def launch_plan(N: int, V: int, dtype: torch.dtype,
                n_sm: int = H100_SMS) -> LaunchPlan:
    """Split each row over as many CTAs as keep a grid of ``REF_ROWS``
    rows resident at once (``CTAS_PER_SM`` per SM: one wave), but no
    more than leaves each split ``MIN_SPLIT_VECTORS`` 16-byte vectors,
    or ``MAX_SPLITS``: 4 splits at V = 126464 on the H100, for every N
    (512 CTAs at N = 128, 128 at N = 32). The count never depends on N,
    so a row's ``conf`` is bit-identical at every batch size."""
    vec = VEC_BYTES // dtype.itemsize
    nvec = V // vec                     # the most vectors a row's body has
    splits = max(1, min(MAX_SPLITS, n_sm * CTAS_PER_SM // REF_ROWS,
                        nvec // MIN_SPLIT_VECTORS))
    chunk = max(1, -(-nvec // splits))
    return LaunchPlan(vec=vec, splits=splits, chunk=chunk, grid=(N, splits))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS = {}


def _counters(device: torch.device, N: int) -> torch.Tensor:
    """The per-row arrival counters of (device, N): zeros once, and the
    kernel leaves them zero. Kept for the life of the process, so a
    captured CUDA graph keeps a valid pointer; launches that share them
    run on one stream."""
    key = (device.index, N)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(N, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.confidence_argmax_launch.argtypes = (
        [p] * 5 + [i, i, ctypes.c_longlong, i, i, i, i, p])
    lib.confidence_argmax_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(build.load("confidence"))


@functools.lru_cache(maxsize=None)
def load_probe(mode: int) -> ctypes.CDLL:
    """A probe build of the kernel (``CONF_PROBE`` in the source: 1 = the
    loads alone, 2 = the arithmetic alone), for ``launch(lib=...)``. Its
    results are garbage; chip_smoke.py only times it."""
    return _bind(ctypes.CDLL(str(build.compile_library(
        "confidence", (f"CONF_PROBE={mode}",)))))


def launch(logits: torch.Tensor, conf: torch.Tensor, idx: torch.Tensor, *,
           mask_id: int, lib=None) -> None:
    """The CUDA kernel on the current stream. logits: (N, V) float32 or
    bfloat16 with unit column stride; writes conf (N,) float32 and idx
    (N,) int32; column ``mask_id`` (-1: none) counts as -1e30. Checked by
    ``ops.confidence_argmax``. ``lib`` is a ``load_probe`` build, else
    the port's library."""
    N, V = logits.shape
    dev = logits.device
    plan = launch_plan(N, V, logits.dtype, _sm_count(dev.index or 0))
    partials = counters = None
    if plan.splits > 1:
        partials = torch.empty((N * plan.splits, 4), dtype=torch.float32,
                               device=dev)
        counters = _counters(dev, N)
    err = (lib or _lib()).confidence_argmax_launch(
        logits.data_ptr(), conf.data_ptr(), idx.data_ptr(),
        partials.data_ptr() if partials is not None else None,
        counters.data_ptr() if counters is not None else None,
        N, V, logits.stride(0), _DTYPES[logits.dtype], mask_id, plan.splits,
        plan.chunk, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"confidence_argmax launch failed: cudaError {err}")
