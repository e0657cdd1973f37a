"""Device-dispatching wrappers around the kernels.

A CPU tensor goes to the plain PyTorch version (``kernels.ref``). A CUDA
tensor goes to the kernel — after its device, dtype, shape and
contiguity are checked — or the wrapper raises; nothing falls back.
``LAUNCHES`` counts each wrapper's kernel launches (and nothing else),
so a run can show that its path went through the kernels; ``gemm_f32``
counts the GEMM wrapper's launches that ran its float32 kernel (each is
also one of ``gemm``'s). Several engine
threads count into it at once: ``count`` adds under a lock, and a thread
inside ``capturing()`` (a CUDA graph capture, which launches nothing)
counts into its own tally instead, so a capture never rewinds the
shared counts.

Each wrapper's call is one op of a dry run's meter when one is on its
thread (``kernels.cost.call``; ``launch.dryrun``): the kernel's own
operations and bytes, whichever route runs it.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.kernels import cost, ref

LAUNCHES = {"block_attention": 0, "confidence_argmax": 0, "gemm": 0,
            "rglru_scan": 0, "mlstm_scan": 0, "slstm_scan": 0,
            "gemm_f32": 0}
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


def gemm(x: torch.Tensor, w: torch.Tensor, out_dtype=None, acc=None
         ) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype (or ``out_dtype``
    float32: the sums unrounded), summed in float32 in
    an order that depends on (N, K, dtype) only (``kernels/gemm.py``).
    ``acc`` (float32 (M, N), with ``out_dtype`` float32): the sums start
    from its values, and the kernel writes them in its place (the
    tensor-parallel chain of ``models.layers.row_parallel``).
    CPU tensors take the plain version (``ref.gemm_ref``); CUDA tensors
    the kernel: float32 or bfloat16, both contiguous, one dtype, one
    device, and in bfloat16 (TMA tensor maps) K and N multiples of 8 and
    16-byte aligned bases, so every row is 16-byte aligned. Anything else
    raises."""
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _require(out_dtype in (None, x.dtype, torch.float32),
             f"gemm: out_dtype {out_dtype} (x's dtype or float32)")
    _require(acc is None or (out_dtype == torch.float32
                             and acc.dtype == torch.float32
                             and acc.shape == (x.shape[0], w.shape[1])
                             and acc.device == x.device
                             and acc.is_contiguous()),
             "gemm: acc must be a contiguous float32 (M, N) on x's device, "
             "with out_dtype float32")
    return cost.call("gemm", lambda y: cost.gemm_cost(
        x.shape[0], x.shape[1], w.shape[1], x.dtype, out_dtype,
        acc is not None), _gemm, x, w, out_dtype, acc, like=_product_like)


def _product_like(x, w, out_dtype, acc):
    """An empty result of ``x @ w`` (a dry run's count)."""
    return x.new_empty((*x.shape[:-1], w.shape[1]),
                       dtype=out_dtype or x.dtype)


def _gemm(x, w, out_dtype, acc):
    if x.device.type == "cpu":
        return ref.gemm_ref(x, w, out_dtype, acc)
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
    y = acc if acc is not None else torch.empty(
        (M, N), dtype=out_dtype or x.dtype, device=x.device)
    kernel.launch(x, w, y, acc_in=acc is not None)
    count({"gemm": 1, "gemm_f32": int(x.dtype == torch.float32)})
    return y


def linear(x: torch.Tensor, w: torch.Tensor, *, train: bool = False,
           out_dtype=None, acc=None) -> torch.Tensor:
    """``x @ w`` for every product of the model: x (..., K), w (K, N).
    On the CPU it is ``torch.matmul``, exactly as the plain path has it;
    on the card the GEMM kernel (``gemm``), whose sum order does not
    depend on how many rows x has. No fallback: a product the kernel
    does not take raises.

    ``train=True`` is the training route on every device: ``x @ w``,
    differentiable under autograd (the kernel has no backward). The JAX
    package trains on XLA's dot, never on a kernel; serving never takes
    this route.

    ``out_dtype=torch.float32``: the float32 sums unrounded; ``acc`` (of
    the output's shape, float32): the sums start from its values (a
    tensor-parallel rank continuing the previous rank's partial sum,
    ``models.layers.row_parallel``)."""
    if train:
        return _linear_plain(x, w, out_dtype, acc)
    route = _linear_plain if x.device.type == "cpu" else _linear_kernel
    return cost.call("gemm", lambda y: cost.gemm_cost(
        x.numel() // x.shape[-1], x.shape[-1], w.shape[1], x.dtype,
        out_dtype, acc is not None), route, x, w, out_dtype, acc,
        like=_product_like)


def _linear_plain(x, w, out_dtype, acc):
    if acc is not None:
        return acc + x.float() @ w.float()
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    return x.float() @ w.float()


def _linear_kernel(x, w, out_dtype, acc):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if out_dtype is None:
        y = gemm(x2, w)
    else:
        y = gemm(x2, w, out_dtype, None if acc is None
                 else acc.reshape(-1, w.shape[1]))
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
    return cost.call("block_attention", lambda out: cost.attention_cost(
        q, k, q_pos, kv_pos, kv_mask, out, window), _block_attention, q, k,
        v, q_pos, kv_pos, kv_mask, scale, softcap, window, out_dtype,
        like=lambda q, *a: q.new_empty(q.shape, dtype=out_dtype))


def _block_attention(q, k, v, q_pos, kv_pos, kv_mask, scale, softcap,
                     window, out_dtype):
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
    return cost.call("confidence_argmax", lambda out: cost.confidence_cost(
        N, V, logits.element_size()), _confidence_kernel, logits, mask_id,
        like=lambda x, _: (x.new_empty((N,), dtype=torch.float32),
                           x.new_empty((N,), dtype=torch.int32)))


def _confidence_kernel(logits, mask_id):
    N, V = logits.shape
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
                           row_chunk: int = 1024, gather=None):
    """LM-head projection + confidence/argmax (Eq. 4) over row chunks, so
    the full ``(..., V)`` logits never exist as one array. hidden:
    (..., d); head: (d, V). ``mask_id >= 0`` bans that token. The
    projection is ``linear`` in the hidden dtype (``chunked_head_reduce``:
    ``torch.matmul`` on the CPU, the GEMM kernel on the card); its output
    goes to the kernel as it is (bf16 on the main path), and the kernel
    widens it and bans ``mask_id`` as it reads it. A softcap, which the
    kernel does not take, is applied in float32 first. ``gather``: the
    head is this rank's vocabulary columns, and the logits are gathered
    into whole rows (``chunked_head_reduce``) before the kernel."""
    from repro_torch.core.schedule import chunked_head_reduce

    def reduce(logits):
        if logit_softcap:
            logits = ref.softcap_ref(logits.float(), logit_softcap)
        return _confidence_2d(logits, mask_id)

    return chunked_head_reduce(hidden, head, reduce, row_chunk=row_chunk,
                               gather=gather)


# ------------------------------------------------------------------ scans
# The recurrent mixers' time scans (``csrc/recurrent.cu``; plain versions
# ``ref.*_scan_ref``). Activations come in float32 or bfloat16, state and
# gates are float32, the per-step output is ``out_dtype`` (float32, or the
# activations' dtype: the float32 value rounded to nearest even). On the
# card each is one launch; ``train=True`` is the training route (the plain
# version under autograd, on any device), as for ``linear``. A dry run's
# count takes a scan on either route as one op of its own count.

def _scan_inputs(name, acts, f32s, *, out_dtype):
    """Check a scan's operands for the card (raises on any it refuses)."""
    x = acts[0]
    _require(x.is_cuda, f"{name}: unsupported device {x.device}")
    _require(x.dtype in (torch.float32, torch.bfloat16)
             and all(t.dtype == x.dtype for t in acts),
             f"{name}: activations must share float32 or bfloat16 "
             f"({[t.dtype for t in acts]})")
    _require(all(t.dtype == torch.float32 for t in f32s),
             f"{name}: state and gates must be float32")
    _require(out_dtype in (torch.float32, x.dtype),
             f"{name}: out_dtype {out_dtype} is neither float32 nor "
             f"{x.dtype}")
    ts = (*acts, *f32s)
    _require(all(t.device == x.device for t in ts),
             f"{name}: tensors on different devices")
    _require(all(t.is_contiguous() for t in ts),
             f"{name}: inputs must be contiguous")
    _require(x.shape[1] >= 1, f"{name}: empty time axis")


def rglru_scan(gx, u, lam, h0, *, assoc: bool = True, out_dtype=None,
               train: bool = False):
    """RG-LRU scan. gx (B, S, 2w) float32 (u @ [w_a | w_x]), u (B, S, w),
    lam (w,) float32, h0 (B, w) float32 -> (hs (B, S, w) in
    ``out_dtype`` (u's by default), h_S (B, w) float32). ``assoc`` picks
    the reference's form on the plain route (associative unless
    ``cfg.remat``); the kernel is sequential."""
    out_dtype = out_dtype or u.dtype
    return cost.call("rglru_scan", lambda out: cost.scan_cost(
        "rglru", u.shape, (gx, u, lam, h0), out), _rglru_scan, gx, u, lam,
        h0, assoc, out_dtype, train, like=lambda gx, u, lam, h0, *_: (
            u.new_empty(u.shape, dtype=out_dtype),
            h0.new_empty(h0.shape)))


def _rglru_scan(gx, u, lam, h0, assoc, out_dtype, train):
    if train or u.device.type == "cpu":
        hs, hT = ref.rglru_scan_ref(gx, u, lam, h0, assoc=assoc)
        return hs.to(out_dtype), hT
    from repro_torch.kernels import recurrent as kernel
    B, S, w = u.shape
    _require(gx.shape == (B, S, 2 * w) and lam.shape == (w,)
             and h0.shape == (B, w), "rglru_scan: shapes gx "
             f"{tuple(gx.shape)}, u {tuple(u.shape)}, lam "
             f"{tuple(lam.shape)}, h0 {tuple(h0.shape)}")
    _scan_inputs("rglru_scan", (u,), (gx, lam, h0), out_dtype=out_dtype)
    hs = torch.empty((B, S, w), dtype=out_dtype, device=u.device)
    hT = torch.empty((B, w), dtype=torch.float32, device=u.device)
    kernel.launch_rglru(gx, u, lam, h0, hs, hT)
    count({"rglru_scan": 1})
    return hs, hT


def mlstm_scan(proj, C, n, m, *, H: int, dk: int, dv: int, out_dtype=None,
               train: bool = False):
    """mLSTM scan over the fused projection proj (B, S, N): rows [q (H
    dk) | k (H dk) | v (H dv) | i (H) | f (H) | zero pad] (``ref.
    mlstm_split``), from state C (B, H, dk, dv), n (B, H, dk), m (B, H),
    all float32 -> (hs (B, S, H dv) in ``out_dtype`` (proj's by default),
    C, n, m). The kernel takes dk in ``recurrent.MLSTM_DK`` and dv a
    multiple of 32."""
    out_dtype = out_dtype or proj.dtype
    return cost.call("mlstm_scan", lambda out: cost.scan_cost(
        "mlstm", (*proj.shape[:2], H, dk, dv), (proj, C, n, m), out),
        _mlstm_scan, proj, C, n, m, H, dk, dv, out_dtype, train,
        like=lambda proj, *st_and_rest: (
            proj.new_empty((*proj.shape[:2], H * dv), dtype=out_dtype),
            *(t.new_empty(t.shape) for t in st_and_rest[:3])))


def _mlstm_scan(proj, C, n, m, H, dk, dv, out_dtype, train):
    if train or proj.device.type == "cpu":
        hs, *st = ref.mlstm_scan_ref(proj, C, n, m, H=H, dk=dk, dv=dv)
        return (hs.to(out_dtype), *st)
    from repro_torch.kernels import recurrent as kernel
    B, S, N = proj.shape
    _require(C.shape == (B, H, dk, dv) and n.shape == (B, H, dk)
             and m.shape == (B, H) and N >= 2 * H * dk + H * dv + 2 * H,
             f"mlstm_scan: shapes proj {tuple(proj.shape)}, C "
             f"{tuple(C.shape)}, n {tuple(n.shape)}, m {tuple(m.shape)}")
    _require(kernel.mlstm_plan(B, H, dk, dv, proj.element_size())
             is not None,
             f"mlstm_scan: no kernel takes dk={dk}, dv={dv} (dk in "
             f"{kernel.MLSTM_DK}, dv a multiple of {kernel.MLSTM_COLS})")
    _scan_inputs("mlstm_scan", (proj,), (C, n, m), out_dtype=out_dtype)
    hs = torch.empty((B, S, H * dv), dtype=out_dtype, device=proj.device)
    C1, n1, m1 = (torch.empty_like(t) for t in (C, n, m))
    kernel.launch_mlstm(proj, C, n, m, hs, C1, n1, m1, H=H, dk=dk, dv=dv,
                        k_div=math.sqrt(dk))
    count({"mlstm_scan": 1})
    return hs, C1, n1, m1


def slstm_scan(pre, r, h, c, n, m, *, out_dtype=None, train: bool = False):
    """sLSTM scan. pre (B, S, 4 d) = x @ [w_z | w_i | w_f | w_o], r (4, H,
    hd, hd) float32, state h, c, n, m (B, d) float32 -> (hs (B, S,
    d) in ``out_dtype`` (pre's by default), h, c, n, m). The kernel takes
    the head dims ``recurrent.slstm_plan`` plans (a cluster of CTAs that
    holds the head's R in shared memory: hd a multiple of 32, at most
    256)."""
    out_dtype = out_dtype or pre.dtype
    return cost.call("slstm_scan", lambda out: cost.scan_cost(
        "slstm", (*pre.shape[:2], *r.shape[1:3]), (pre, r, h, c, n, m), out),
        _slstm_scan, pre, r, h, c, n, m, out_dtype, train,
        like=lambda pre, r, *st_and_rest: (
            pre.new_empty((*pre.shape[:2], h.shape[1]), dtype=out_dtype),
            *(t.new_empty(t.shape) for t in st_and_rest[:4])))


def _slstm_scan(pre, r, h, c, n, m, out_dtype, train):
    if train or pre.device.type == "cpu":
        hs, *st = ref.slstm_scan_ref(pre, r, h, c, n, m)
        return (hs.to(out_dtype), *st)
    from repro_torch.kernels import recurrent as kernel
    B, S = pre.shape[:2]
    _require(r.dim() == 4 and r.shape[0] == 4 and r.shape[2] == r.shape[3],
             f"slstm_scan: r {tuple(r.shape)} is not (4, H, hd, hd)")
    _, H, hd, _ = r.shape
    d = H * hd
    _require(pre.shape == (B, S, 4 * d)
             and all(t.shape == (B, d) for t in (h, c, n, m)),
             f"slstm_scan: shapes pre {tuple(pre.shape)}, state "
             f"{[tuple(t.shape) for t in (h, c, n, m)]} for r "
             f"{tuple(r.shape)}")
    _require(kernel.slstm_plan(hd) is not None,
             f"slstm_scan: no kernel takes head dim {hd} (a multiple of 32 "
             "whose cluster holds the head's R in shared memory)")
    _scan_inputs("slstm_scan", (pre,), (r, h, c, n, m), out_dtype=out_dtype)
    hs = torch.empty((B, S, d), dtype=out_dtype, device=pre.device)
    out_state = tuple(torch.empty_like(t) for t in (h, c, n, m))
    kernel.launch_slstm(pre, r, (h, c, n, m), hs, out_state)
    count({"slstm_scan": 1})
    return (hs, *out_state)
