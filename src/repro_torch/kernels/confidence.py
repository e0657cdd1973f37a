"""Binding of the CUDA C++ confidence kernel (``csrc/confidence.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/confidence.py``
(``_kernel`` / ``confidence_argmax``): per row of logits, the first index
of the row's maximum and ``conf = 1 / max(sum exp(x - max), 1e-30)``, the
largest softmax probability. The kernel takes bf16 or float32 logits and
bans one column (``mask_id``); its source says what bounds it on the H100
and how its design answers that. ``launch_plan`` is its host-side
geometry, pure Python so the CPU tests reach it.

The first port's Triton kernel (one program per row, float32 or bf16, no
ban) stays here as ``launch_triton``, reached only by ``chip_smoke.py``,
which times it beside the CUDA kernel on the same inputs. Triton is
imported at that launch, never when this module is imported: the
kernel's body names ``tl``, which that launch binds.

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
    """Split each row over as many CTAs as keep the whole grid resident
    at once (``CTAS_PER_SM`` per SM: one wave), but no more than leaves
    each split ``MIN_SPLIT_VECTORS`` 16-byte vectors, or ``MAX_SPLITS``.
    At N = 128 rows that is 4 splits (512 CTAs); N = 32 gets 15 at
    V = 126464 in bf16."""
    vec = VEC_BYTES // dtype.itemsize
    nvec = V // vec                     # the most vectors a row's body has
    splits = max(1, min(MAX_SPLITS, n_sm * CTAS_PER_SM // N,
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


# ------------------------------------------- the first port's Triton kernel

BLOCK_V = 4096
NUM_WARPS = 8

tl = None          # triton.language, bound at the first Triton launch
_TRITON_KERNEL = None


def _triton_conf_kernel(x_ptr, conf_ptr, idx_ptr, V, stride,
                        BLOCK_N: tl.constexpr, BLOCK_V: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    base = x_ptr + rows.to(tl.int64)[:, None] * stride
    m = tl.full([BLOCK_N], -1e30, tl.float32)
    s = tl.zeros([BLOCK_N], tl.float32)
    a = tl.zeros([BLOCK_N], tl.int32)
    for v0 in range(0, V, BLOCK_V):
        cols = v0 + tl.arange(0, BLOCK_V)
        x = tl.load(base + cols[None, :], mask=cols[None, :] < V,
                    other=-1e30).to(tl.float32)
        t_max = tl.max(x, axis=1)
        t_arg = tl.argmax(x, axis=1, tie_break_left=True).to(tl.int32) + v0
        better = t_max > m
        m_new = tl.maximum(m, t_max)
        s = s * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new[:, None]), axis=1)
        a = tl.where(better, t_arg, a)
        m = m_new
    tl.store(conf_ptr + rows, 1.0 / tl.maximum(s, 1e-30))
    tl.store(idx_ptr + rows, a)


def triton_kernel():
    """The Triton kernel, compiled on first use."""
    global tl, _TRITON_KERNEL
    if _TRITON_KERNEL is None:
        import triton
        import triton.language as language
        tl = language
        _TRITON_KERNEL = triton.jit(_triton_conf_kernel)
    return _TRITON_KERNEL


def launch_triton(logits: torch.Tensor, conf: torch.Tensor,
                  idx: torch.Tensor) -> None:
    """The first port's kernel: one program of 8 warps per row, 4096-wide
    chunks, no ban. Same outputs as ``launch`` with ``mask_id=-1``."""
    N, V = logits.shape
    block_v = min(BLOCK_V, 1 << max(V - 1, 1).bit_length())
    triton_kernel()[(N,)](logits, conf, idx, V, logits.stride(0),
                          BLOCK_N=1, BLOCK_V=block_v, num_warps=NUM_WARPS)
