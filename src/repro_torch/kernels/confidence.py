"""Triton kernel: fused confidence + argmax over the vocabulary (Eq. 4).

Replaces the Pallas TPU kernel ``repro/kernels/confidence.py``
(``_kernel`` / ``confidence_argmax``). Per row of logits it keeps a
running max, the sum of exp rescaled to that max, and the argmax, in one
pass over the vocabulary, and returns ``conf = 1 / max(sum, 1e-30)``
(the max softmax probability) and the argmax index as int32.

What bounds it on the H100: one read of the (N, V) float32 logits — at
the main path's N = 128 rows and V = 126464 that is 65 MB, about 19 us
at 3.35 TB/s — with a few operations per element and no tensor-core
work. Design: one program per row, looping over V in power-of-two chunks
with masked loads (``other=-1e30``); 128 rows give about one program per
SM, each streaming its row with wide loads. The running state stays in
float32 / int32 registers.

Tie-break, as the TPU kernel: within a chunk the first index wins
(``tl.argmax(..., tie_break_left=True)``); across chunks the earlier
chunk wins (strict ``>``). So the result is the first index of the max.

Triton is imported at the first launch, never when this module is
imported: the kernel's body names ``tl``, which that launch binds.
"""
from __future__ import annotations

import torch

BLOCK_V = 4096
NUM_WARPS = 8

tl = None          # triton.language, bound at the first launch
_KERNEL = None


def _conf_kernel(x_ptr, conf_ptr, idx_ptr, V, stride,
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


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as language
        tl = language
        _KERNEL = triton.jit(_conf_kernel)
    return _KERNEL


def launch(logits: torch.Tensor, conf: torch.Tensor,
           idx: torch.Tensor) -> None:
    """logits: (N, V) float32 or bfloat16, rows contiguous; writes
    conf (N,) float32 and idx (N,) int32. Checked by
    ``ops.confidence_argmax``."""
    N, V = logits.shape
    block_v = min(BLOCK_V, 1 << max(V - 1, 1).bit_length())
    _kernel()[(N,)](logits, conf, idx, V, logits.stride(0),
                    BLOCK_N=1, BLOCK_V=block_v, num_warps=NUM_WARPS)
