"""Device-dispatching wrappers around the kernels.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``). A CUDA
tensor goes to the kernel — after its device, dtype, shape and
contiguity are checked — or the wrapper raises; nothing falls back.
``LAUNCHES`` counts each wrapper's kernel launches (and nothing else),
so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

LAUNCHES = {"block_attention": 0, "confidence_argmax": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def block_attention(q, k, v, q_pos, kv_pos, kv_mask, *, scale=None,
                    softcap: float = 0.0, window: int = 0,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); q_pos (B, Sq) / kv_pos
    (B, Skv) int32; kv_mask (B, Skv) bool. Returns (B, Sq, H, D) in
    ``out_dtype`` (float32, as the TPU kernel returns, or on the card
    bfloat16: the float32 result rounded to nearest even, in the
    kernel's epilogue; the CPU route casts to any dtype);
    rows with no valid key are zeros. ``scale`` defaults to 1/sqrt(D).

    On the card, bf16 q/k/v go to the tensor-core kernel (D in
    ``BF16_D``) and float32 q/k/v to the simple kernel (D in
    ``SIMPLE_D``); any other (dtype, D) raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.block_attention_ref(q, k, v, q_pos, kv_pos, kv_mask,
                                       scale=scale, softcap=softcap,
                                       window=window).to(out_dtype)
    from repro_torch.kernels import block_attention as kernel
    _require(q.is_cuda, f"block_attention: unsupported device {q.device}")
    _require(out_dtype in (torch.float32, torch.bfloat16),
             f"block_attention: out_dtype {out_dtype} is not float32 or "
             "bfloat16")
    B, Sq, H, D = q.shape
    _require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == D
             and v.shape == k.shape, "block_attention: k/v shape")
    Skv, Hkv = k.shape[1], k.shape[2]
    _require(H % Hkv == 0, "block_attention: H % Hkv != 0")
    _require(q.dtype in (torch.float32, torch.bfloat16)
             and k.dtype == q.dtype and v.dtype == q.dtype,
             "block_attention: q/k/v must share float32 or bfloat16")
    dims = kernel.BF16_D if q.dtype == torch.bfloat16 else kernel.SIMPLE_D
    _require(D in dims, f"block_attention: head dim {D} with {q.dtype} "
             f"q/k/v: no kernel takes it (head dims {dims})")
    _require(q_pos.shape == (B, Sq) and kv_pos.shape == (B, Skv)
             and q_pos.dtype == torch.int32 and kv_pos.dtype == torch.int32,
             "block_attention: positions must be int32 (B, Sq)/(B, Skv)")
    _require(kv_mask.shape == (B, Skv) and kv_mask.dtype == torch.bool,
             "block_attention: kv_mask must be bool (B, Skv)")
    tensors = (q, k, v, q_pos, kv_pos, kv_mask)
    _require(all(t.device == q.device for t in tensors),
             "block_attention: tensors on different devices")
    _require(all(t.is_contiguous() for t in tensors),
             "block_attention: inputs must be contiguous")
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             "block_attention: q/k/v must be 16-byte aligned")
    out = torch.empty((B, Sq, H, D), dtype=out_dtype, device=q.device)
    launch = kernel.launch if q.dtype == torch.bfloat16 \
        else kernel.launch_simple
    launch(q, k, v, q_pos, kv_pos, kv_mask, out, scale=scale,
           softcap=softcap, window=window)
    LAUNCHES["block_attention"] += 1
    return out


def sliding_window_attention(q, k, v, q_pos, kv_pos, *, window: int,
                             scale=None, softcap: float = 0.0):
    """Local-attention specialization: full KV validity, distance-window
    mask only."""
    kv_mask = torch.ones(kv_pos.shape, dtype=torch.bool, device=kv_pos.device)
    return block_attention(q, k, v, q_pos, kv_pos, kv_mask, scale=scale,
                           softcap=softcap, window=window)


def _confidence_2d(logits: torch.Tensor):
    if logits.device.type == "cpu":
        return ref.confidence_argmax_ref(logits)
    from repro_torch.kernels import confidence as kernel
    _require(logits.is_cuda,
             f"confidence_argmax: unsupported device {logits.device}")
    _require(logits.dtype in (torch.float32, torch.bfloat16),
             "confidence_argmax: logits must be float32 or bfloat16")
    _require(logits.stride(1) == 1, "confidence_argmax: rows not contiguous")
    N = logits.shape[0]
    conf = torch.empty((N,), dtype=torch.float32, device=logits.device)
    idx = torch.empty((N,), dtype=torch.int32, device=logits.device)
    kernel.launch(logits, conf, idx)
    LAUNCHES["confidence_argmax"] += 1
    return conf, idx


def confidence_argmax(logits: torch.Tensor):
    """logits: (..., V) -> (conf (...,) float32, idx (...,) int32)."""
    if logits.dim() == 2:
        return _confidence_2d(logits)
    shape = logits.shape[:-1]
    conf, idx = _confidence_2d(logits.reshape(-1, logits.shape[-1]))
    return conf.reshape(shape), idx.reshape(shape)


def head_confidence_argmax(hidden, head, *, mask_id: int = -1,
                           logit_softcap: float = 0.0,
                           row_chunk: int = 1024):
    """LM-head projection + confidence/argmax (Eq. 4) over row chunks, so
    the full ``(..., V)`` logits never exist as one array. hidden:
    (..., d); head: (d, V). ``mask_id >= 0`` bans that token before the
    reduction. The projection is a plain ``torch.matmul``; the reduction
    is the kernel."""
    from repro_torch.core.schedule import chunked_head_reduce
    return chunked_head_reduce(hidden, head, confidence_argmax,
                               mask_id=mask_id, logit_softcap=logit_softcap,
                               row_chunk=row_chunk)
