"""Device-dispatching wrappers around the kernels.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``). A CUDA
tensor goes to the kernel — after its device, dtype, shape and
contiguity are checked — or the wrapper raises; nothing falls back.
``LAUNCHES`` counts each wrapper's kernel launches (and nothing else),
so a run can show that its path went through the kernels. Several engine
threads count into it at once: ``count`` adds under a lock, and a thread
inside ``capturing()`` (a CUDA graph capture, which launches nothing)
counts into its own tally instead, so a capture never rewinds the
shared counts.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.kernels import ref

LAUNCHES = {"block_attention": 0, "confidence_argmax": 0, "gemm": 0}
_LOCK = threading.Lock()
_TALLY = threading.local()


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count(counts: dict) -> None:
    """Add ``{name: n}`` launches: to this thread's capture tally inside
    ``capturing()``, else to ``LAUNCHES`` under the lock."""
    tally = getattr(_TALLY, "tally", None)
    if tally is not None:
        for name, n in counts.items():
            tally[name] += n
        return
    with _LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def capturing():
    """While open, this thread's launches go to the yielded tally (one
    count per wrapper, like ``LAUNCHES``) and not to ``LAUNCHES``; other
    threads count as before."""
    prev = getattr(_TALLY, "tally", None)
    _TALLY.tally = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _TALLY.tally
    finally:
        _TALLY.tally = prev


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, summed in float32 in
    an order that depends on (N, K, dtype) only (``kernels/gemm.py``).
    CPU tensors take the plain version (``ref.gemm_ref``); CUDA tensors
    the kernel: float32 or bfloat16, both contiguous, one dtype, one
    device, and in bfloat16 (TMA tensor maps) K and N multiples of 8 and
    16-byte aligned bases, so every row is 16-byte aligned. Anything else
    raises."""
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device.type == "cpu":
        return ref.gemm_ref(x, w)
    from repro_torch.kernels import gemm as kernel
    _require(x.is_cuda and w.device == x.device,
             f"gemm: devices {x.device} and {w.device}")
    _require(x.dtype in (torch.float32, torch.bfloat16) and w.dtype == x.dtype,
             f"gemm: dtypes {x.dtype} and {w.dtype} (float32 or bfloat16, "
             "one dtype)")
    _require(x.is_contiguous() and w.is_contiguous(),
             "gemm: x and w must be contiguous (row-major (M, K), (K, N))")
    M, K = x.shape
    N = w.shape[1]
    _require(M >= 1 and N >= 1 and K >= 1, "gemm: empty operand")
    if x.dtype == torch.bfloat16:
        _require(K % 8 == 0 and N % 8 == 0,
                 f"gemm: bfloat16 needs K and N multiples of 8 (K={K}, N={N})")
        _require(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                 "gemm: x and w must be 16-byte aligned")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    kernel.launch(x, w, y)
    count({"gemm": 1})
    return y


def linear(x: torch.Tensor, w: torch.Tensor, *, train: bool = False
           ) -> torch.Tensor:
    """``x @ w`` for every product of the model: x (..., K), w (K, N).
    On the CPU it is ``torch.matmul``, exactly as the plain path has it;
    on the card the GEMM kernel (``gemm``), whose sum order does not
    depend on how many rows x has. No fallback: a product the kernel
    does not take raises.

    ``train=True`` is the training route on every device: ``x @ w``,
    differentiable under autograd (the kernel has no backward). The JAX
    package trains on XLA's dot, never on a kernel; serving never takes
    this route."""
    if train or x.device.type == "cpu":
        return x @ w
    lead = x.shape[:-1]
    y = gemm(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, w.shape[1])


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
    count({"block_attention": 1})
    return out


def sliding_window_attention(q, k, v, q_pos, kv_pos, *, window: int,
                             scale=None, softcap: float = 0.0):
    """Local-attention specialization: full KV validity, distance-window
    mask only."""
    kv_mask = torch.ones(kv_pos.shape, dtype=torch.bool, device=kv_pos.device)
    return block_attention(q, k, v, q_pos, kv_pos, kv_mask, scale=scale,
                           softcap=softcap, window=window)


def _confidence_2d(logits: torch.Tensor, mask_id: int):
    N, V = logits.shape
    mask_id = max(int(mask_id), -1)          # any negative id bans nothing
    _require(mask_id < V, f"confidence_argmax: mask_id {mask_id} is not a "
             f"column of V={V}")
    if logits.device.type == "cpu":
        return ref.confidence_argmax_ref(logits, mask_id=mask_id)
    from repro_torch.kernels import confidence as kernel
    _require(logits.is_cuda,
             f"confidence_argmax: unsupported device {logits.device}")
    _require(logits.dtype in (torch.float32, torch.bfloat16),
             "confidence_argmax: logits must be float32 or bfloat16")
    _require(logits.stride(1) == 1, "confidence_argmax: rows not contiguous")
    _require(N >= 1 and V >= 1, "confidence_argmax: empty logits")
    conf = torch.empty((N,), dtype=torch.float32, device=logits.device)
    idx = torch.empty((N,), dtype=torch.int32, device=logits.device)
    kernel.launch(logits, conf, idx, mask_id=mask_id)
    count({"confidence_argmax": 1})
    return conf, idx


def confidence_argmax(logits: torch.Tensor, *, mask_id: int = -1):
    """logits: (..., V) float32 or bfloat16 -> (conf (...,) float32,
    idx (...,) int32), reduced in float32. ``mask_id >= 0`` bans that
    column (it counts as -1e30); a negative ``mask_id`` bans none."""
    if logits.dim() == 2:
        return _confidence_2d(logits, mask_id)
    shape = logits.shape[:-1]
    conf, idx = _confidence_2d(logits.reshape(-1, logits.shape[-1]), mask_id)
    return conf.reshape(shape), idx.reshape(shape)


def head_confidence_argmax(hidden, head, *, mask_id: int = -1,
                           logit_softcap: float = 0.0,
                           row_chunk: int = 1024):
    """LM-head projection + confidence/argmax (Eq. 4) over row chunks, so
    the full ``(..., V)`` logits never exist as one array. hidden:
    (..., d); head: (d, V). ``mask_id >= 0`` bans that token. The
    projection is ``linear`` in the hidden dtype (``chunked_head_reduce``:
    ``torch.matmul`` on the CPU, the GEMM kernel on the card); its output
    goes to the kernel as it is (bf16 on the main path), and the kernel
    widens it and bans ``mask_id`` as it reads it. A softcap, which the
    kernel does not take, is applied in float32 first."""
    from repro_torch.core.schedule import chunked_head_reduce

    def reduce(logits):
        if logit_softcap:
            logits = ref.softcap_ref(logits.float(), logit_softcap)
        return _confidence_2d(logits, mask_id)

    return chunked_head_reduce(hidden, head, reduce, row_chunk=row_chunk)
