"""Binding of the CUDA C++ block-attention kernel (``csrc/block_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/block_attention.py``
(``_kernel`` / ``block_attention``). The kernel source says what bounds it
on the H100 and how its layout answers that. This module only launches
it: ``kernels.ops.block_attention`` is the checked, counted entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SUPPORTED_D = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = build.load("block_attention")
    fn = lib.block_attention_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, q_pos, kv_pos, kv_mask, out, *, scale: float,
           softcap: float, window: int) -> None:
    """Launch on the current stream. Arguments are already checked by
    ``ops.block_attention``; ``out`` is a (B, Sq, H, D) float32 buffer."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
                B, Sq, Skv, H, Hkv, D, _DTYPES[q.dtype], float(scale),
                float(softcap), int(window), stream)
    if err != 0:
        raise RuntimeError(f"block_attention launch failed: cudaError {err}")
