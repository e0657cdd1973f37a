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

# must match csrc/gemm.cu
_TILES = {
    # dtype: (block_m, block_n, block_k, stages, threads, dynamic smem bytes)
    torch.bfloat16: (128, 128, 32, 4, 256, 4 * (128 * 40 + 32 * 136) * 2),
    torch.float32: (64, 64, 16, 1, 256, 0),
}


@dataclass(frozen=True)
class GemmPlan:
    """Tile configuration of one (N, K, dtype): each output is summed by
    one thread over ``k_tiles`` tiles of ``block_k`` in ascending order.
    The grid is (ceil(M / block_m), ``n_tiles``); rows past M are zeros
    in shared memory."""
    block_m: int
    block_n: int
    block_k: int
    stages: int
    threads: int
    smem_bytes: int
    n_tiles: int
    k_tiles: int

    def grid(self, M: int) -> tuple:
        return (-(-M // self.block_m), self.n_tiles)


@functools.lru_cache(maxsize=256)
def launch_plan(N: int, K: int, dtype: torch.dtype) -> GemmPlan:
    """The kernel's tile configuration for an (M, K) x (K, N) product in
    ``dtype``. It takes no M: a row's sum runs in the same order in a
    batch of any size."""
    if dtype not in _TILES:
        raise ValueError(f"gemm: no kernel for {dtype}")
    bm, bn, bk, stages, threads, smem = _TILES[dtype]
    return GemmPlan(block_m=bm, block_n=bn, block_k=bk, stages=stages,
                    threads=threads, smem_bytes=smem,
                    n_tiles=-(-N // bn), k_tiles=-(-K // bk))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("gemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gemm_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.gemm_launch.restype = ctypes.c_int
    return lib


def launch(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> None:
    """The kernel on the current stream: x (M, K), w (K, N), y (M, N),
    contiguous, one dtype (checked by ``ops.gemm``)."""
    M, K = x.shape
    N = w.shape[1]
    err = _lib().gemm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {err}")
