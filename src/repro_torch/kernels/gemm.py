"""Binding of the CUDA C++ GEMM (``csrc/gemm.cu``): ``y = x @ W`` for the
model's projections on the card, with a reduction order that depends on
(N, K, dtype) only, never on the row count M.

No TPU kernel stands behind it: the JAX package leaves its projections to
XLA. On the card the library GEMM picks its tiling and split-K by M, so a
row's bits changed with the batch it sat in; this kernel is what makes
the decoder batch-invariant there (``DiffusionDecoder.batch_invariant``).
``launch_plan`` is the tile configuration, pure Python and free of M so
that a CPU test can hold it to that; the source says what bounds the
kernel on the H100.

This module only launches the kernel: ``kernels.ops.linear`` is the
entry the model calls, and ``kernels.ops.gemm`` the checked, counted
wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The constants of csrc/gemm.cu, by name (a CPU test holds them equal).
# bf16: 128 x 256 tiles of two consumer warpgroups and a producer
# warpgroup, a ring of 4 stages; TMA boxes of 64 k x 128 rows (x) and
# 64 n x 64 k (W), 128-byte swizzle. float32: the FFMA tile loop.
_TILES = {"kBM": 128, "kBN": 256, "kBK": 64, "kStages": 4, "kThreads": 384,
          "kFBM": 64, "kFBN": 64, "kFBK": 16, "kFThreads": 256}
BOX = 64                 # bf16 in a box's 128-byte inner row (the swizzle)


@dataclass(frozen=True)
class GemmPlan:
    """Tile configuration of one (N, K, dtype): each output is summed in
    one accumulator over ``k_tiles`` tiles of ``block_k`` in ascending
    order, one CTA per (row tile, column tile). bf16 (``tma``): a ring of
    ``stages`` TMA stages in dynamic shared memory, rows past M TMA's
    zero fill; float32: static shared tiles, rows past M zeros."""
    block_m: int
    block_n: int
    block_k: int
    stages: int
    threads: int
    tma: bool
    n_tiles: int
    k_tiles: int

    @property
    def stage_bytes(self) -> int:
        """One stage of the bf16 ring: the x box (block_m rows), then
        block_n / BOX W boxes of block_k rows."""
        return (self.block_m + self.block_n) * self.block_k * 2 \
            if self.tma else 0

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: 1024 bytes to align the ring (128-byte
        swizzle atoms are 1024 bytes), the stages, 2 mbarriers a stage."""
        return 1024 + self.stages * (self.stage_bytes + 16) \
            if self.tma else 0

    def row_tiles(self, M: int) -> int:
        return -(-M // self.block_m)

    def grid(self, M: int) -> tuple:
        """Launch grid for M rows: bf16, one CTA per tile on a 1-D grid
        (the row tiles of one column tile are neighbours, so a W tile is
        read from device memory once and then from L2); float32, (row
        tiles, column tiles)."""
        if self.tma:
            return (self.row_tiles(M) * self.n_tiles,)
        return (self.row_tiles(M), self.n_tiles)


@functools.lru_cache(maxsize=256)
def launch_plan(N: int, K: int, dtype: torch.dtype) -> GemmPlan:
    """The kernel's tile configuration for an (M, K) x (K, N) product in
    ``dtype``. It takes no M: a row's sum runs in the same order in a
    batch of any size. Every bf16 product takes the one 128 x 256 tile."""
    t = _TILES
    if dtype == torch.bfloat16:
        return GemmPlan(block_m=t["kBM"], block_n=t["kBN"], block_k=t["kBK"],
                        stages=t["kStages"], threads=t["kThreads"], tma=True,
                        n_tiles=-(-N // t["kBN"]), k_tiles=-(-K // t["kBK"]))
    if dtype == torch.float32:
        return GemmPlan(block_m=t["kFBM"], block_n=t["kFBN"],
                        block_k=t["kFBK"], stages=1, threads=t["kFThreads"],
                        tma=False, n_tiles=-(-N // t["kFBN"]),
                        k_tiles=-(-K // t["kFBK"]))
    raise ValueError(f"gemm: no kernel for {dtype}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gemm_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.gemm_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(build.load("gemm"))


def load_probe() -> ctypes.CDLL:
    """The probe build (``GEMM_PROBE=1`` in the source: the load path
    alone, whose output is garbage), for ``launch(lib=...)``.
    chip_smoke.py times it against the kernel."""
    return _bind(ctypes.CDLL(str(build.compile_library(
        "gemm", ("GEMM_PROBE=1",)))))


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor, *,
           lib=None) -> None:
    """The kernel on the current stream: x (M, K), w (K, N), y (M, N),
    contiguous, one dtype (checked by ``ops.gemm``). ``lib`` is a probe
    build, else the port's library."""
    M, K = x.shape
    N = w.shape[1]
    err = (lib or _lib()).gemm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {err}")
