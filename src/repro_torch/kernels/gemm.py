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
# 64 n x 64 k (W), 128-byte swizzle. float32 (3xTF32 on mma.sync): 64
# rows x BN columns x 32 k, 4 warps, a cp.async ring of 4 stages, BN the
# widest of 64 .. 8 (halving) that gives N at least 32 column tiles.
_TILES = {"kBM": 128, "kBN": 256, "kBK": 64, "kStages": 4, "kThreads": 384,
          "kFBM": 64, "kFBK": 32, "kFStages": 4, "kFThreads": 128,
          "kFBNMax": 64, "kFBNMin": 8, "kFColTiles": 32}
BOX = 64                 # bf16 in a box's 128-byte inner row (the swizzle)
F32_A_STRIDE = _TILES["kFBK"] + 4    # floats a row of x's tile (kFAStride)


def f32_block_n(N: int) -> int:
    """The float32 kernel's column tile for N (``f32_block_n`` in the
    source): the widest of kFBNMax, kFBNMax / 2, .., kFBNMin that gives N
    at least kFColTiles column tiles, so a narrow product (a router)
    spreads over more CTAs without splitting K."""
    bn = _TILES["kFBNMax"]
    while bn > _TILES["kFBNMin"] and -(-N // bn) < _TILES["kFColTiles"]:
        bn //= 2
    return bn


def f32_b_stride(block_n: int) -> int:
    """Floats a row of W's float32 tile: 8 mod 32, so the mma.sync B
    fragment loads (k = lane % 4, n = lane / 4) hit 32 distinct banks."""
    return -(-block_n // 32) * 32 + 8


@dataclass(frozen=True)
class GemmPlan:
    """Tile configuration of one (N, K, dtype): each output is summed in
    one accumulator over ``k_tiles`` tiles of ``block_k`` in ascending
    order, one CTA per (row tile, column tile). bf16 (``tma``): a ring of
    ``stages`` TMA stages in dynamic shared memory, rows past M TMA's
    zero fill; float32: a cp.async ring of ``stages`` stages in dynamic
    shared memory, rows past M zeros."""
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
        """One stage of the ring. bf16: the x box (block_m rows), then
        block_n / BOX W boxes of block_k rows. float32: x's tile in rows
        of ``F32_A_STRIDE`` floats, then W's in rows of
        ``f32_b_stride``."""
        if self.tma:
            return (self.block_m + self.block_n) * self.block_k * 2
        return 4 * (self.block_m * F32_A_STRIDE
                    + self.block_k * f32_b_stride(self.block_n))

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory. bf16: 1024 bytes to align the ring
        (128-byte swizzle atoms are 1024 bytes), the stages, 2 mbarriers a
        stage; float32: the stages."""
        if self.tma:
            return 1024 + self.stages * (self.stage_bytes + 16)
        return self.stages * self.stage_bytes

    @property
    def warps(self) -> tuple:
        """float32: (warps along M, warps along N); each warp owns
        block_m / warps_m rows x block_n / warps_n columns of m16n8
        fragments."""
        return (2, 2) if self.block_n == 64 else (4, 1)

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
    batch of any size. Every bf16 product takes the one 128 x 256 tile;
    a float32 product a column tile chosen by N (``f32_block_n``)."""
    t = _TILES
    if dtype == torch.bfloat16:
        return GemmPlan(block_m=t["kBM"], block_n=t["kBN"], block_k=t["kBK"],
                        stages=t["kStages"], threads=t["kThreads"], tma=True,
                        n_tiles=-(-N // t["kBN"]), k_tiles=-(-K // t["kBK"]))
    if dtype == torch.float32:
        bn = f32_block_n(N)
        return GemmPlan(block_m=t["kFBM"], block_n=bn, block_k=t["kFBK"],
                        stages=t["kFStages"], threads=t["kFThreads"],
                        tma=False, n_tiles=-(-N // bn),
                        k_tiles=-(-K // t["kFBK"]))
    raise ValueError(f"gemm: no kernel for {dtype}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gemm_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
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
           acc_in: bool = False, lib=None) -> None:
    """The kernel on the current stream: x (M, K), w (K, N), y (M, N),
    contiguous, x and w of one dtype, y of theirs or float32 (the bf16
    kernel then stores its float32 sums unrounded; checked by
    ``ops.gemm``). ``acc_in``: a float32 y's values are where the sums
    start (y is read and written in place). ``lib`` is a probe build,
    else the port's library."""
    M, K = x.shape
    N = w.shape[1]
    err = (lib or _lib()).gemm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
        _DTYPES[x.dtype], int(y.dtype == torch.float32), int(acc_in),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {err}")
