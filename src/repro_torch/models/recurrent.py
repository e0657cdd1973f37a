"""Recurrent mixers: xLSTM (mLSTM / sLSTM) and RecurrentGemma's RG-LRU —
the PyTorch counterpart of ``repro.models.recurrent``.

Each mixer exposes
    init_<name>(generator, cfg, dtype) -> params
    apply_<name>(cfg, p, x, state=None, return_state=False, train=False)
with x: (B, S, d), params in the JAX package's layout and state a
NamedTuple of tensors (float32 state, the conv state in x's dtype). The
arithmetic is the reference's: float32 states and gates, RG-LRU's
float32 ``u @ w_a`` / ``u @ w_x``, every other product in x's dtype.

Every product goes through ``ops.linear`` and every time scan through
``ops.rglru_scan`` / ``mlstm_scan`` / ``slstm_scan`` (one kernel launch
on the card, the plain scan of ``kernels.ref`` on the CPU and on the
training route). Products that share an input are one product over
concatenated weights (RG-LRU ``w_in | w_gate`` and ``w_a | w_x``; mLSTM
``w_up | w_z`` and ``wq | wk | wv | w_i | w_f``; sLSTM ``w_z | w_i | w_f
| w_o``), and in bfloat16 a weight whose width is not a multiple of 8
(the GEMM's TMA rows) is padded with zeros: the sLSTM FFN's 4/3 width
(gelu(0) = 0, so the padded activations are zeros that meet zero rows)
and the mLSTM gate columns. A column's sum depends only on K, on the
card (``kernels/gemm.py``) and on the CPU, so each output equals its
own product's bit for bit. The serving route builds this layout once
per weight tensor (``mixer_weights``; the decoder builds it when it
takes its params); the training route builds it per call under
autograd.

Tensor parallelism (``tp``, the model line of a ``launch.mesh.Mesh``):
the weights are this rank's shards as ``launch.sharding.SpecBuilder``
cuts them, and each mixer finds from their widths which are sharded
(a width that does not divide the line stays whole). Column-parallel
input projections give this rank's channels; where the next step needs
every channel (RG-LRU's ``u @ [w_a | w_x]``, the mLSTM and sLSTM scans,
whose heads mix channels) they are gathered over the line, and the
scan's state is kept in the cache as this rank's slice of it; the
row-parallel output products' partial sums are completed by an
``all_reduce``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ops import linear
from repro_torch.models.layers import (dense_init, derived, rms_norm,
                                       row_parallel)

NEG_INF = -1e30
ALIGN = 8            # bfloat16 GEMM operands: K and N multiples of 8


# ------------------------------------------------------------- helpers

def conv1d_init(generator: torch.Generator, width: int, channels: int,
                dtype) -> torch.Tensor:
    return dense_init(generator, (width, channels), width, dtype)


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C), state: (B, W-1, C)
    in x's dtype. Returns (out, new_state)."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out, (xp[:, -(W - 1):] if W > 1 else state)


def _aligned(w: torch.Tensor, dim: int) -> torch.Tensor:
    """w zero-padded along ``dim`` to a multiple of ``ALIGN`` where the
    GEMM needs it (bfloat16); float32 weights are left as they are."""
    n = w.shape[dim]
    if w.element_size() != 2 or n % ALIGN == 0:
        return w
    pad = [0, 0] * (w.dim() - 1 - dim) + [0, -n % ALIGN]
    return F.pad(w, pad)


def mixer_weights(kind: str, p: dict, train: bool = False) -> dict:
    """The weights a mixer multiplies with (module docstring): built per
    call under autograd on the training route, else once per weight
    tensor (``layers.derived``)."""
    names, build = _LAYOUTS[kind]
    if train:
        return build(p)
    srcs = [p[k] for k in names]
    return derived(kind, srcs, lambda: build({k: t.detach() for k, t
                                              in zip(names, srcs)}))


def _rglru_layout(p):
    return {"w_in_gate": torch.cat([p["w_in"], p["w_gate"]], dim=1),
            "w_ax": torch.cat([p["w_a"], p["w_x"]], dim=1).float(),
            "lam": p["lam"].float()}


def _mlstm_layout(p):
    di, H, dk = p["wq"].shape
    dv = p["wv"].shape[2]
    return {"w_up_z": torch.cat([p["w_up"], p["w_z"]], dim=1),
            "w_proj": _aligned(torch.cat(
                [p["wq"].reshape(di, H * dk), p["wk"].reshape(di, H * dk),
                 p["wv"].reshape(di, H * dv), p["w_i"], p["w_f"]], dim=1), 1)}


def _slstm_layout(p):
    return {"w_gates": torch.cat([p[f"w_{g}"] for g in "zifo"], dim=1),
            "r": torch.stack([p[f"r_{g}"] for g in "zifo"]).float(),
            "w_ffn_up": _aligned(p["w_ffn_up"], 1),
            "w_ffn_down": _aligned(p["w_ffn_down"], 0)}


_LAYOUTS = {
    "rglru": (("w_in", "w_gate", "w_a", "w_x", "lam"), _rglru_layout),
    "mlstm": (("w_up", "w_z", "wq", "wk", "wv", "w_i", "w_f"),
              _mlstm_layout),
    "slstm": (("w_z", "w_i", "w_f", "w_o", "r_z", "r_i", "r_f", "r_o",
               "w_ffn_up", "w_ffn_down"), _slstm_layout),
}


# ------------------------------------------------------------- RG-LRU

class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, w) float32
    conv: torch.Tensor       # (B, W-1, w)


def init_rglru(generator: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = generator.device
    # Lambda init so a ~ U(0.9, 0.999)^c-ish (Griffin appendix)
    lam = torch.rand((w,), generator=generator, device=dev) * 0.5 + 0.4
    return {
        "w_in": dense_init(generator, (d, w), d, dtype),
        "w_gate": dense_init(generator, (d, w), d, dtype),
        "w_out": dense_init(generator, (w, d), w, dtype),
        "conv": conv1d_init(generator, cfg.rglru_conv_width, w, dtype),
        "w_a": dense_init(generator, (w, w), w, dtype),
        "w_x": dense_init(generator, (w, w), w, dtype),
        "lam": lam.to(dtype),
    }


def rglru_state(cfg, batch: int, dtype, device, width=None) -> RGLRUState:
    """The zero state; ``width``: a rank's channels under tensor
    parallelism (all of them by default)."""
    w = width or cfg.lru_width or cfg.d_model
    return RGLRUState(
        torch.zeros((batch, w), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.rglru_conv_width - 1, w), dtype=dtype,
                    device=device))


def _slice(t, tp, width):
    """This rank's ``width`` channels of the last axis of ``t``."""
    return t[..., tp.index * width:(tp.index + 1) * width]


def apply_rglru(cfg, p, x, state: Optional[RGLRUState] = None,
                return_state: bool = False, train: bool = False, tp=None):
    B, S, _ = x.shape
    w = p["w_in"].shape[1]
    if tp is not None and w == (cfg.lru_width or cfg.d_model):
        tp = None
    lw = mixer_weights("rglru", p, train)
    if state is None:
        state = rglru_state(cfg, B, x.dtype, x.device, width=w)
    y = linear(x, lw["w_in_gate"], train=train)
    gate = F.gelu(y[..., w:], approximate="tanh")
    u, conv_state = causal_conv1d(y[..., :w], p["conv"], state.conv)
    u_all = tp.all_gather(u, -1) if tp is not None else u
    gx = linear(u_all.float(), lw["w_ax"], train=train)   # float32
    hs, hT = ops.rglru_scan(gx, u, lw["lam"], state.h, assoc=not cfg.remat,
                            out_dtype=x.dtype, train=train)
    out = row_parallel(hs * gate, p["w_out"], tp, train=train)
    if return_state:
        return out, RGLRUState(hT, conv_state)
    return out


# ------------------------------------------------------------- mLSTM

class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B, H, dk, dv) float32
    n: torch.Tensor      # (B, H, dk) float32
    m: torch.Tensor      # (B, H) float32
    conv: torch.Tensor   # (B, W-1, 2d)


def init_mlstm(generator: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    di = 2 * d                      # up-projection factor 2 (xLSTM block)
    dk = di // H // 2               # qk dim per head
    dv = di // H                    # value dim per head
    dev = generator.device
    return {
        "w_up": dense_init(generator, (d, di), d, dtype),
        "w_z": dense_init(generator, (d, di), d, dtype),
        "conv": conv1d_init(generator, 4, di, dtype),
        "wq": dense_init(generator, (di, H, dk), di, dtype),
        "wk": dense_init(generator, (di, H, dk), di, dtype),
        "wv": dense_init(generator, (di, H, dv), di, dtype),
        "w_i": dense_init(generator, (di, H), di, dtype),
        "w_f": dense_init(generator, (di, H), di, dtype),
        "gn": torch.zeros((di,), dtype=dtype, device=dev),
        "w_down": dense_init(generator, (di, d), di, dtype),
    }


def mlstm_state(cfg, batch: int, dtype, device, conv_width=None,
                v_width=None) -> MLSTMState:
    """The zero state; ``conv_width`` and ``v_width``: a rank's channels
    of the conv state and of C's value axis under tensor parallelism
    (all of them by default)."""
    di = 2 * cfg.d_model
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        torch.zeros((batch, H, di // H // 2, v_width or di // H), **f32),
        torch.zeros((batch, H, di // H // 2), **f32),
        torch.full((batch, H), NEG_INF, **f32),
        torch.zeros((batch, 3, conv_width or di), dtype=dtype,
                    device=device))


def apply_mlstm(cfg, p, x, state: Optional[MLSTMState] = None,
                return_state: bool = False, train: bool = False, tp=None):
    B, S, _ = x.shape
    H = cfg.n_heads
    di = p["w_up"].shape[1]
    if tp is not None and di == 2 * cfg.d_model:
        tp = None
    dk, dv = p["wq"].shape[2], p["wv"].shape[2]
    lw = mixer_weights("mlstm", p, train)
    if state is None:
        v_width = dv // tp.size if tp is not None and dv % tp.size == 0 \
            else dv
        state = mlstm_state(cfg, B, x.dtype, x.device, conv_width=di,
                            v_width=v_width)
    uz = linear(x, lw["w_up_z"], train=train)
    c, conv_state = causal_conv1d(uz[..., :di], p["conv"], state.conv)
    c = F.silu(c)
    # rows of the q/k/v/gate products are this rank's channels: the
    # partial sums complete over the line; the scan runs whole
    proj = row_parallel(c, lw["w_proj"], tp, train=train)
    C, gn = state.C, p["gn"]
    c_shard = C.shape[-1]
    if tp is not None:
        if c_shard < dv:
            C = tp.all_gather(C, -1)
        gn = tp.all_gather(gn, 0)
    hs, C, n, m = ops.mlstm_scan(proj, C, state.n, state.m, H=H,
                                 dk=dk, dv=dv, out_dtype=x.dtype,
                                 train=train)
    hs = rms_norm(hs, gn, cfg.norm_eps)                      # group-norm-ish
    if tp is not None:
        hs = _slice(hs, tp, di)
        if c_shard < dv:
            C = _slice(C, tp, c_shard)
    y = (hs + c) * F.silu(uz[..., di:])
    y = row_parallel(y, p["w_down"], tp, train=train)
    if return_state:
        return y, MLSTMState(C, n, m, conv_state)
    return y


# ------------------------------------------------------------- sLSTM

class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, d) float32
    c: torch.Tensor   # (B, d)
    n: torch.Tensor   # (B, d)
    m: torch.Tensor   # (B, d)


def init_slstm(generator: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    f = int(d * 4 / 3)
    p = {"gn": torch.zeros((d,), dtype=dtype, device=generator.device)}
    for g in "zifo":
        p[f"w_{g}"] = dense_init(generator, (d, d), d, dtype)
    for g in "zifo":
        # block-diagonal recurrent matrix, stored per head (H, hd, hd)
        p[f"r_{g}"] = dense_init(generator, (H, hd, hd), hd, dtype)
    p["w_ffn_up"] = dense_init(generator, (d, f), d, dtype)
    p["w_ffn_down"] = dense_init(generator, (f, d), f, dtype)
    return p


def slstm_state(cfg, batch: int, device, width=None) -> SLSTMState:
    """The zero state; ``width``: a rank's channels under tensor
    parallelism (all of them by default)."""
    w = width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    z = [torch.zeros((batch, w), **f32) for _ in range(3)]
    return SLSTMState(*z, torch.full((batch, w), NEG_INF, **f32))


def apply_slstm(cfg, p, x, state: Optional[SLSTMState] = None,
                return_state: bool = False, train: bool = False, tp=None):
    B, S, _ = x.shape
    d = cfg.d_model
    dl = p["w_z"].shape[1]
    gates_tp = tp if (tp is not None and dl < d) else None
    ffn_tp = tp if (tp is not None
                    and p["w_ffn_up"].shape[1] < int(d * 4 / 3)) else None
    lw = mixer_weights("slstm", p, train)
    if state is None:
        state = slstm_state(cfg, B, x.device, width=dl)
    pre = linear(x, lw["w_gates"], train=train)
    st_shard = state.h.shape[-1]
    if gates_tp is not None:
        # this rank's channels of each gate; a head's recurrence mixes
        # its channels, so the scan runs whole
        pre = gates_tp.all_gather(pre.reshape(B, S, 4, dl), -1).reshape(
            B, S, 4 * d)
        if st_shard < d:
            state = SLSTMState(*(gates_tp.all_gather(t, -1) for t in state))
    hs, *st = ops.slstm_scan(pre, lw["r"], *state, out_dtype=x.dtype,
                             train=train)
    if gates_tp is not None and st_shard < d:
        st = [_slice(t, gates_tp, st_shard) for t in st]
    hs = rms_norm(hs, p["gn"], cfg.norm_eps)
    y = F.gelu(linear(hs, lw["w_ffn_up"], train=train), approximate="tanh")
    y = row_parallel(y, lw["w_ffn_down"], ffn_tp, train=train)
    if return_state:
        return y, SLSTMState(*st)
    return y


def init_state(cfg, kind: str, batch: int, dtype, device):
    """A zero state of a ``kind`` mixer (the reference's ``init_cache``
    leaves: zeros, m at -1e30), every leaf its own buffer."""
    if kind == "rglru":
        return rglru_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return mlstm_state(cfg, batch, dtype, device)
    return slstm_state(cfg, batch, device)


APPLY = {"rglru": apply_rglru, "mlstm": apply_mlstm, "slstm": apply_slstm}
INIT = {"rglru": init_rglru, "mlstm": init_mlstm, "slstm": init_slstm}
