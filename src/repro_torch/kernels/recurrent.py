"""Binding of the CUDA C++ scan kernels of the recurrent mixers
(``csrc/recurrent.cu``): RG-LRU, mLSTM and sLSTM.

No TPU kernel stands behind them: the JAX package scans with
``lax.scan`` (``src/repro/models/recurrent.py``). They exist because a
scan in PyTorch is S steps of ~15 launches each, which a captured block
graph copies into every IF node. The source says how each walks the time
axis and keeps its state on chip.

This module only launches them: ``kernels.ops.rglru_scan`` /
``mlstm_scan`` / ``slstm_scan`` are the checked, counted entries.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' constants (csrc/recurrent.cu, by name; a CPU test holds
# them equal)
RGLRU = {"kRglruThreads": 512, "kRglruChannels": 32, "kRglruChunk": 32,
         "kRglruStages": 3}
MLSTM = {"kMlstmThreads": 256, "kMlstmCols": 32, "kMlstmChunk": 16,
         "kMlstmSmemLimit": 232448}
SLSTM = {"kSlstmMaxCluster": 8, "kSlstmChannels": 32, "kSlstmMaxRows": 8,
         "kSlstmSmemLimit": 232448}
MLSTM_COLS = MLSTM["kMlstmCols"]       # value columns per mLSTM CTA
MLSTM_DK = (64, 128, 256)


@dataclass(frozen=True)
class RglruPlan:
    """The RG-LRU scan: ``ctas`` CTAs of ``threads`` threads, each a
    row's slice of ``channels`` channels, walking time in chunks of
    ``chunk`` steps through a ring of ``stages`` chunks, in
    ``smem_bytes`` of dynamic shared memory."""
    chunk: int
    stages: int
    channels: int
    threads: int
    ctas: int
    smem_bytes: int


def rglru_plan(B: int, w: int, elem_bytes: int) -> RglruPlan:
    """The RG-LRU kernel's plan for B rows of w channels with u in
    ``elem_bytes`` (4 or 2) bytes (``rglru_smem_bytes`` in the source):
    ceil(w / 32) CTAs a row; shared memory the ring (two float32 gate
    halves and u a step and channel), a and b double-buffered, and each
    channel's -8 softplus(lam)."""
    c = RGLRU
    P, L, NS = c["kRglruChannels"], c["kRglruChunk"], c["kRglruStages"]
    smem = NS * L * P * (8 + elem_bytes) + 2 * 2 * L * P * 4 + 4 * P
    return RglruPlan(chunk=L, stages=NS, channels=P,
                     threads=c["kRglruThreads"],
                     ctas=-(-w // P) * B, smem_bytes=smem)


@dataclass(frozen=True)
class MlstmPlan:
    """The mLSTM scan: ``ctas`` CTAs of ``threads`` threads, each one
    (row, head, ``cols`` value columns), walking time in chunks of
    ``chunk`` steps, in ``smem_bytes`` of dynamic shared memory."""
    chunk: int
    threads: int
    cols: int
    ctas: int
    smem_bytes: int


def mlstm_plan(B: int, H: int, dk: int, dv: int,
               elem_bytes: int) -> Optional[MlstmPlan]:
    """The mLSTM kernel's plan (``mlstm_smem_bytes`` in the source), or
    None where no kernel takes the shape: dk in ``MLSTM_DK``, dv a
    multiple of 32. Shared memory: a chunk's raw q | k | v rows, q and k
    widened and permuted (dk + 32 floats a step each), v, the gates,
    each warp's num partials of each step (two chunks' worth), each
    row's n[k] q[k] (padded to 33 a warp) and n . q of each step."""
    c = MLSTM
    P, L = c["kMlstmCols"], c["kMlstmChunk"]
    W = c["kMlstmThreads"] // 32
    if dk not in MLSTM_DK or dv <= 0 or dv % P:
        return None
    smem = L * (2 * dk + P) * elem_bytes \
        + 4 * L * (2 * (dk + 4 * W) + P + 2 + 2 * W * P + dk // 32 * 33 + 1)
    if smem > c["kMlstmSmemLimit"]:
        return None
    return MlstmPlan(chunk=L, threads=c["kMlstmThreads"], cols=P,
                     ctas=dv // P * H * B, smem_bytes=smem)


@dataclass(frozen=True)
class SlstmPlan:
    """One head of the sLSTM scan: a cluster of ``cluster`` CTAs of
    ``threads`` threads, each holding the R columns of its ``channels``
    channels (all four gates) and the h of up to ``rows`` batch rows,
    double-buffered with an mbarrier a buffer, in ``smem_bytes`` of
    shared memory."""
    cluster: int
    channels: int
    threads: int
    rows: int
    smem_bytes: int


def slstm_plan(hd: int) -> Optional[SlstmPlan]:
    """The sLSTM kernel's plan for head dim ``hd`` (``slstm_cluster`` in
    the source), or None where no kernel takes it: hd a multiple of 32
    and at most 8 x 32 = 256, a cluster of hd / 32 CTAs (8 is the
    portable cluster size) whose R columns and h buffers fit a CTA's
    shared memory."""
    c = SLSTM
    P = c["kSlstmChannels"]
    if hd <= 0 or hd % P or hd // P > c["kSlstmMaxCluster"]:
        return None
    smem = (4 * hd * P + 2 * c["kSlstmMaxRows"] * hd) * 4 + 16
    if smem > c["kSlstmSmemLimit"]:
        return None
    return SlstmPlan(cluster=hd // P, channels=P, threads=4 * P,
                     rows=c["kSlstmMaxRows"], smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("recurrent")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, argtypes in (
            (lib.rglru_scan_launch, [p] * 6 + [i] * 5 + [p]),
            (lib.mlstm_scan_launch, [p] * 8 + [i] * 6 + [f, i, i, p]),
            (lib.slstm_scan_launch, [p] * 11 + [i] * 6 + [p])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, which: str) -> None:
    if err != 0:
        raise RuntimeError(f"{which} launch failed: cudaError {err}")


def launch_rglru(gx, u, lam, h0, hs, hT) -> None:
    B, S, w = u.shape
    _check(_lib().rglru_scan_launch(
        gx.data_ptr(), u.data_ptr(), lam.data_ptr(), h0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), B, S, w, _DTYPES[u.dtype],
        _DTYPES[hs.dtype], _stream(u)), "rglru_scan")


def launch_mlstm(proj, C, n, m, hs, C1, n1, m1, *, H, dk, dv,
                 k_div) -> None:
    B, S, N = proj.shape
    _check(_lib().mlstm_scan_launch(
        proj.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
        hs.data_ptr(), C1.data_ptr(), n1.data_ptr(), m1.data_ptr(), B, S, N,
        H, dk, dv, float(k_div), _DTYPES[proj.dtype], _DTYPES[hs.dtype],
        _stream(proj)), "mlstm_scan")


def launch_slstm(pre, r, state, hs, out_state) -> None:
    B, S = pre.shape[:2]
    _, H, hd, _ = r.shape
    _check(_lib().slstm_scan_launch(
        pre.data_ptr(), r.data_ptr(), *(t.data_ptr() for t in state),
        hs.data_ptr(), *(t.data_ptr() for t in out_state), B, S, H, hd,
        _DTYPES[pre.dtype], _DTYPES[hs.dtype], _stream(pre)), "slstm_scan")
