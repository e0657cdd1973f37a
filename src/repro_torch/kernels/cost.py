"""The H100's rates and each kernel's count of operations and bytes.

One count serves two readers: ``chip_smoke.py``'s bound column (a
kernel's least time on the card: the larger of its bytes over the HBM
rate and its operations over the peak of their type) and the dry run
(``launch.dryrun``), which counts a call of a kernel wrapper of
``kernels.ops`` as one op of these operations and bytes: the kernel's
own operands read once and its result written once, none of the plain
body's intermediates (``attend_ref``'s score matrix is no HBM traffic
of ``block_attention.cu``).

The wrappers make their calls through ``call``: while a dry run's meter
is on the calling thread (``metering``), a wrapper's call is one op of
the meter, and nothing inside it is counted again; with no meter on
(every serving and training call) ``call`` just calls.

Rates (``hopper-kernels``, NVIDIA's data sheet of the SXM part at its
700 W limit; dense, no sparsity): 989e12 operations/s in bfloat16 on the
tensor cores, 67e12 in float32 outside them (TF32 is off), 3.35e12 B/s
of HBM, NVLink 450e9 B/s each way between the 8 cards of a host.
``gemm.cu``'s float32 products run on the tensor cores as three TF32
products each (3xTF32): their 2 M K N counted operations run at a third
of the 495e12 TF32 rate (``"tf32x3"``), so a bound set at the FFMA rate
does not read below the kernel's time; every other float32 operation
keeps 67e12. A mesh
line of more than 8 ranks leaves the host: ``NETWORK_BYTES_S`` is an
assumption (one 400 Gb/s link a card), and a record that uses it says so.
"""
from __future__ import annotations

import contextlib
import threading

import torch

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
NVLINK_BYTES_S = 450e9
HOST_CARDS = 8
NETWORK_BYTES_S = 50e9


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def peak_ops_s(dtype) -> float:
    """The dense peak of ``dtype``'s operations: the tensor cores' for
    bfloat16 and float16, float32's for every other type; a name of
    ``PEAK_OPS_S`` (``"tf32x3"``) its rate."""
    if isinstance(dtype, str):
        return PEAK_OPS_S[dtype]
    half = dtype in (torch.bfloat16, torch.float16)
    return PEAK_OPS_S["bfloat16" if half else "float32"]


def link_bytes_s(line_size: int):
    """(B/s one rank sends at, "nvlink" or "network (assumed)") on a
    mesh line of ``line_size`` ranks."""
    if line_size <= HOST_CARDS:
        return NVLINK_BYTES_S, "nvlink"
    return NETWORK_BYTES_S, "network (assumed)"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(ops: float, n_bytes: float, dtype):
    """(ms, "bytes" or "operations"): the larger of ``n_bytes`` over the
    HBM rate and ``ops`` over ``dtype``'s peak."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = ops / peak_ops_s(dtype)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


# ------------------------------------------------------------- counts
# Each returns (operations, bytes, the dtype whose peak the operations
# run at).

def gemm_cost(M: int, K: int, N: int, dtype, out_dtype=None,
              acc: bool = False):
    """(M, K) @ (K, N): x and W read once, y written once (and, with a
    float32 ``acc`` to start from, read once), 2 M K N operations, at
    the 3xTF32 rate in float32."""
    out = (out_dtype or dtype).itemsize
    n_bytes = (M * K + K * N) * dtype.itemsize + M * N * out \
        + (M * N * 4 if acc else 0)
    return 2 * M * K * N, n_bytes, \
        "tf32x3" if dtype == torch.float32 else dtype


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` has a shape and no values (a dry run's tensor)."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t) or t.device.type == "meta"


def attention_pairs(q_pos, kv_pos, kv_mask, window: int):
    """(valid (batch, query, key) pairs, (batch, key) rows any query
    reads). From the data: keys masked, or outside every query's window,
    are never read, and only valid pairs are multiplied. Shape-only
    (the dry run): every pair, or with a window the most it admits on
    contiguous positions (2 window + 1 keys a query)."""
    B, Sq = q_pos.shape
    Skv = kv_pos.shape[1]
    if shape_only(q_pos) or shape_only(kv_mask):
        per_q = min(Skv, 2 * window + 1) if window else Skv
        rows = min(Skv, Sq + 2 * window) if window else Skv
        return B * Sq * per_q, B * rows
    valid = kv_mask[:, None, :].expand(B, Sq, Skv)
    if window:
        valid = valid & ((q_pos[:, :, None] - kv_pos[:, None, :]).abs()
                         <= window)
    return int(valid.sum()), int(valid.any(dim=1).sum())


def attention_cost(q, k, q_pos, kv_pos, kv_mask, out, window: int):
    """``block_attention``: QK^T and PV over the valid pairs (4 D
    operations a pair and head), q, the positions, the mask and the
    output once, and the K/V rows some query reads once."""
    pairs, kv_rows = attention_pairs(q_pos, kv_pos, kv_mask, window)
    ops = 4 * pairs * q.shape[2] * q.shape[3]
    kv_bytes = 2 * kv_rows * k.shape[2] * k.shape[3] * k.element_size()
    return ops, nbytes(q, q_pos, kv_pos, kv_mask, out) + kv_bytes, q.dtype


def confidence_cost(N: int, V: int, itemsize: int):
    """``confidence_argmax`` over (N, V) logits: each read once, 8 bytes
    a row written (conf, idx); 5 float32 operations an element (max,
    sub, exp, add, compare)."""
    return 5 * N * V, N * V * itemsize + N * 8, torch.float32


def scan_cost(kind: str, shape, args, outs):
    """A recurrent scan: each input read once, each output written once,
    against its float32 operations: RG-LRU ~15 a (row, step, channel),
    shape (B, S, w); mLSTM 5 dk dv + 5 dk a (row, step, head), shape
    (B, S, H, dk, dv); sLSTM the four block-diagonal products, 8 hd d a
    (row, step), and ~20 d, shape (B, S, H, hd)."""
    B, S = shape[:2]
    if kind == "rglru":
        ops = 15 * B * S * shape[2]
    elif kind == "mlstm":
        _, _, H, dk, dv = shape
        ops = B * S * H * (5 * dk * dv + 5 * dk)
    else:
        _, _, H, hd = shape
        ops = B * S * (8 * hd * H * hd + 20 * H * hd)
    return ops, nbytes(*args, *outs), torch.float32


# ------------------------------------------------------------- bounds
# ``chip_smoke.py``'s bound column: (ms, "bytes" or "operations").

def gemm_bound(M, K, N, dtype):
    return bound(*gemm_cost(M, K, N, dtype))


def attention_bound(q, k, v, qp, kp, km, out, window):
    return bound(*attention_cost(q, k, qp, kp, km, out, window))


def confidence_bound(N, V, itemsize):
    return bound(*confidence_cost(N, V, itemsize))


def scan_bound(kind, shape, args, outs):
    return bound(*scan_cost(kind, shape, args, outs))


# ------------------------------------------------------------- metering

_HOOK = threading.local()


def meter():
    """The dry run's meter on this thread, or None."""
    return getattr(_HOOK, "meter", None)


@contextlib.contextmanager
def metering(m):
    """While open, the kernel wrappers called on this thread report to
    ``m`` (``launch.dryrun.Meter``)."""
    prev = meter()
    _HOOK.meter = m
    try:
        yield m
    finally:
        _HOOK.meter = prev


def call(name: str, cost_fn, fn, *args, like=None):
    """``fn(*args)``, a kernel wrapper's call: with a meter on this
    thread, one op named ``name`` of ``cost_fn(result)`` = (operations,
    bytes, dtype); else just the call. Under the meter ``like(*args)``,
    where given, makes the result (empty tensors of the kernel's output
    shapes and dtypes: a count reads no value) in place of ``fn``; an
    operand that holds values raises (a meter left on a thread that
    serves or trains would otherwise return empty results)."""
    m = meter()
    if m is None:
        return fn(*args)
    from torch.utils._pytree import tree_leaves
    if not all(shape_only(a) for a in tree_leaves(args)
               if isinstance(a, torch.Tensor)):
        raise RuntimeError(f"{name}: a dry run's meter is on this thread "
                           "and an operand holds values")
    return m.kernel(name, cost_fn, like or fn, args)


def chain():
    """The context of a tensor-parallel chain's product
    (``models.layers.row_parallel``): the ranks of a model line run it
    one after another, which the dry run's roofline adds as a term."""
    m = meter()
    if m is None:
        return contextlib.nullcontext()
    return m.chain()

