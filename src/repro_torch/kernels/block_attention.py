"""Binding of the CUDA C++ block-attention kernels (``csrc/block_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/block_attention.py``
(``_kernel`` / ``block_attention``). The kernel source says what bounds it
on the H100 and how its layout answers that. Two kernels:

- the bf16 tensor-core kernel (bf16 q/k/v, D in ``BF16_D``): the main
  path. ``launch_plan`` is its host-side geometry, pure Python so the CPU
  tests reach it;
- the simple kernel (float32 q/k/v, D in ``SIMPLE_D``): the f32 path.
  ``launch_simple`` also takes bf16, so that ``chip_smoke.py`` can time
  the first port beside the new kernel on the same inputs.

This module only launches them: ``kernels.ops.block_attention`` is the
checked, counted entry.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

BF16_D = (64, 128, 256)
SIMPLE_D = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # also: out is bf16

# must match csrc/block_attention.cu
ROWS_PER_WARP = 16        # mma.sync m16: query rows per consumer warp
MAX_WARPS = 11            # consumer warps per CTA (384 threads with the producer)
MAX_WARPS_256 = 7         # at D = 256 (256 threads: 255 registers a thread)
STAGES = 4                # K/V ring depth
TILE_K = 32               # keys per ring stage
META_BYTES = 144          # sizeof(StageMeta)
SMEM_LIMIT = 232_448      # 227 KB a block may use on the H100
H100_SMS = 132


@dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one bf16 launch: grid (ctas_per_head, Hkv, B), block
    (warps + 1) * 32 threads. CTA x of a (b, kv head) owns the 16-row
    tiles [x*tiles // c, (x+1)*tiles // c) of its g*Sq packed rows."""
    rows: int             # g * Sq query rows per (b, kv head)
    tiles: int            # 16-row tiles of those rows
    ctas_per_head: int
    warps: int            # consumer warps per CTA (the most any CTA needs)
    threads: int
    stages: int
    smem_bytes: int       # dynamic shared memory per CTA
    grid: tuple

    def tile_ranges(self):
        c = self.ctas_per_head
        return [(x * self.tiles // c, (x + 1) * self.tiles // c)
                for x in range(c)]


def max_warps(D: int) -> int:
    """The instantiation's warp cap: 11 consumer warps, 7 at D = 256,
    whose 128-register accumulator needs the 255 registers that a
    256-thread block may have."""
    return MAX_WARPS_256 if D == 256 else MAX_WARPS


def smem_bytes(D: int, warps: int) -> int:
    pitch = 2 * D + 16                      # a bf16 row padded by 16 bytes
    return (STAGES * 2 * TILE_K * pitch + warps * ROWS_PER_WARP * pitch
            + STAGES * META_BYTES + 2 * STAGES * 8)


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, Sq: int, H: int, Hkv: int, D: int,
                n_sm: int = H100_SMS) -> LaunchPlan:
    """One CTA per (b, kv head) holding all its rows, so K/V is read from
    device memory once; rows are split over more CTAs where they exceed
    ``max_warps(D)`` warps, or where B*Hkv CTAs would leave SMs idle (up
    to one wave: ``n_sm // (B*Hkv)`` CTAs per head). The re-reads of a
    split come from L2."""
    g = H // Hkv
    rows = g * Sq
    tiles = -(-rows // ROWS_PER_WARP)
    fill = max(1, n_sm // (B * Hkv))
    ctas = max(-(-tiles // max_warps(D)), min(tiles, fill))
    warps = -(-tiles // ctas)
    return LaunchPlan(rows=rows, tiles=tiles, ctas_per_head=ctas,
                      warps=warps, threads=(warps + 1) * 32, stages=STAGES,
                      smem_bytes=smem_bytes(D, warps), grid=(ctas, Hkv, B))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    return _bind(build.load("block_attention"))


def load_probe(mode: int) -> ctypes.CDLL:
    """A probe build of the kernels (``ATTN_PROBE`` in the source: 1 =
    the load path alone, 2 = the math alone), for ``launch(lib=...)``.
    Its results are garbage; chip_smoke.py only times it."""
    return _bind(ctypes.CDLL(str(build.compile_library(
        "block_attention", (f"ATTN_PROBE={mode}",)))))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, argtypes in (
            (lib.block_attention_bf16_launch,
             [p] * 7 + [i] * 10 + [f, f, i, p]),
            (lib.block_attention_simple_launch,
             [p] * 7 + [i] * 8 + [f, f, i, p])):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, which: str) -> None:
    if err != 0:
        raise RuntimeError(f"block_attention ({which}) launch failed: "
                           f"cudaError {err}")


def launch(q, k, v, q_pos, kv_pos, kv_mask, out, *, scale: float,
           softcap: float, window: int, lib=None) -> None:
    """The bf16 kernel on the current stream. Arguments are already
    checked by ``ops.block_attention``; ``out`` is a (B, Sq, H, D)
    float32 or bfloat16 buffer. ``lib`` is a probe build, else the
    port's library."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    plan = launch_plan(B, Sq, H, Hkv, D, _sm_count(q.device.index or 0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = (lib or _lib()).block_attention_bf16_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), kv_mask.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Hkv, D, _DTYPES[out.dtype], plan.ctas_per_head, plan.warps,
        plan.smem_bytes, float(scale), float(softcap), int(window), stream)
    _check(err, "bf16")


def launch_simple(q, k, v, q_pos, kv_pos, kv_mask, out, *, scale: float,
                  softcap: float, window: int) -> None:
    """The simple kernel on the current stream (float32 or bfloat16
    q/k/v, D in ``SIMPLE_D``), same contract as ``launch``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().block_attention_simple_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), kv_mask.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Hkv, D, _DTYPES[q.dtype], _DTYPES[out.dtype], float(scale),
        float(softcap), int(window), stream)
    _check(err, "simple")
