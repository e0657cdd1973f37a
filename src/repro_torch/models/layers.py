"""Core neural layers: RMSNorm, RoPE, GQA attention (reference path),
SwiGLU/GELU FFNs — the PyTorch counterpart of ``repro.models.layers``.

Plain functions over dict params, in the JAX package's layouts
(``wq (d, H, hd)``, ``wk/wv (d, Hkv, hd)``, ``wo (H, hd, d)``).
Attention supports the diffusion access pattern: a (possibly short)
query region attending over ``[cached prefix KV || self KV]``
bidirectionally, with optional sliding window and logit softcap.
Position ids are explicit everywhere because suffix pruning produces
non-contiguous positions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import linear
from repro_torch.models.heads import HeadPlan

NEG_INF = -1e30


# PyTorch's CUDA reduction sizes its thread block by the number of rows
# below this count (ATen Reduce.cuh, set_block_dimension), which changes
# the order of a row's sum with the batch; from it on, one configuration
# serves every row count.
MIN_REDUCE_ROWS = 16


def _mean_sq(x: torch.Tensor) -> torch.Tensor:
    """mean(x * x) over the last axis (keepdim), in an order that does not
    depend on the number of rows: on the card, fewer than
    ``MIN_REDUCE_ROWS`` rows are reduced beside zero rows."""
    sq = x * x
    rows = sq.numel() // sq.shape[-1]
    if not sq.is_cuda or rows >= MIN_REDUCE_ROWS:
        return torch.mean(sq, dim=-1, keepdim=True)
    padded = torch.cat([sq.reshape(rows, -1), sq.new_zeros(
        (MIN_REDUCE_ROWS - rows, sq.shape[-1]))])
    return torch.mean(padded, dim=-1, keepdim=True)[:rows].reshape(
        *sq.shape[:-1], 1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in float32 with a zero-init ``(1 + w)`` gain."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(_mean_sq(x) + eps)
    return (x * (1.0 + w.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """Split-half rotary angles for ``positions`` (B, S): ``(cos, sin)``,
    each (B, S, 1, head_dim / 2) float32. One table serves every layer
    of a pass (``apply_model`` builds it once)."""
    freqs = rope_freqs(head_dim, theta, positions.device)       # (D/2,)
    ang = positions.float()[..., None] * freqs                  # (B, S, D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rope_rotate(x: torch.Tensor, table) -> torch.Tensor:
    """Apply a ``rope_table`` to x: (B, S, H, D)."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half rotary embedding. x: (B, S, H, D); positions: (B, S)."""
    return rope_rotate(x, rope_table(positions, x.shape[-1], theta))


def attention_kv_mask(kv_valid, P: int, Sq: int):
    """Validity of [cache (P) || self (Sq)] keys, (B, P + Sq) bool, from
    ``kv_valid``: a (B,) used length of the cache or a (B, P) bool mask;
    the self region is always valid."""
    if kv_valid.dim() == 2:
        pad = torch.ones((kv_valid.shape[0], Sq), dtype=torch.bool,
                         device=kv_valid.device)
        return torch.cat([kv_valid, pad], dim=1)
    idx = torch.arange(P + Sq, device=kv_valid.device)[None, :]
    return (idx < kv_valid.reshape(-1, 1)) | (idx >= P)


# ---------------------------------------------------------------- init

def dense_init(generator: torch.Generator, shape, in_axis_size: int, dtype
               ) -> torch.Tensor:
    """Normal(0, 1/in_axis_size) weights, drawn in float32 on the
    generator's device and cast to ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(in_axis_size))).to(dtype)


def init_attention(generator: torch.Generator, cfg, plan: HeadPlan, dtype
                   ) -> dict:
    """Weights at *padded* head counts; padded q heads are zero (with
    ``tp=1`` nothing is padded)."""
    d, hd = cfg.d_model, cfg.head_dim
    dev = generator.device
    p_real = plan.n_q // plan.n_kv
    real_q = dense_init(generator, (d, plan.n_kv, p_real, hd), d, dtype)
    real_o = dense_init(generator, (plan.n_kv, p_real, hd, d),
                        plan.n_q * hd, dtype)
    n_groups = plan.n_kv + plan.kv_zero_groups
    pp = plan.pad_q // n_groups
    wq = torch.zeros((d, n_groups, pp, hd), dtype=dtype, device=dev)
    wq[:, :plan.n_kv, :p_real] = real_q
    wo = torch.zeros((n_groups, pp, hd, d), dtype=dtype, device=dev)
    wo[:plan.n_kv, :p_real] = real_o
    wk = dense_init(generator, (d, plan.n_kv, hd), d, dtype)
    wv = dense_init(generator, (d, plan.n_kv, hd), d, dtype)
    if plan.kv_zero_groups:
        z = torch.zeros((d, plan.kv_zero_groups, hd), dtype=dtype, device=dev)
        wk = torch.cat([wk, z], dim=1)
        wv = torch.cat([wv, z], dim=1)
    p = {"wq": wq.reshape(d, plan.pad_q, hd),
         "wk": wk.repeat_interleave(plan.kv_dup, dim=1),
         "wv": wv.repeat_interleave(plan.kv_dup, dim=1),
         "wo": wo.reshape(plan.pad_q, hd, d)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=dev)
    return p


def init_ffn(generator: torch.Generator, cfg, kind: str, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        return {"w_gate": dense_init(generator, (d, f), d, dtype),
                "w_up": dense_init(generator, (d, f), d, dtype),
                "w_down": dense_init(generator, (f, d), f, dtype)}
    return {"w_up": dense_init(generator, (d, f), d, dtype),
            "w_down": dense_init(generator, (f, d), f, dtype)}


# ---------------------------------------------------------------- attention

# Above this many score elements per (B*H) the reference path chunks the
# query axis so peak memory is O(chunk x Skv), matching the flash-style
# kernel it stands in for.
SCORE_BUDGET = 32 * 1024 * 1024


def _attend_chunk(q, k, v, q_pos, kv_pos, kv_mask, *, scale, attn_softcap,
                  window):
    """One query chunk. q: (B,Sq,H,D); kv_mask: (B,Skv) bool or None."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    # products of the storage dtype accumulate in float32 (the JAX path's
    # preferred_element_type=f32)
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    if attn_softcap:
        scores = softcap(scores, attn_softcap)
    mask = None
    if window:
        dist = (q_pos[:, :, None].long() - kv_pos[:, None, :].long()).abs()
        mask = dist <= window
    if kv_mask is not None:
        vmask = kv_mask[:, None, :].expand(B, Sq, k.shape[1])
        mask = vmask if mask is None else (mask & vmask)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    # a row with no valid key gets the uniform average here (softmax over
    # -1e30), unlike the kernel's zeros — as in the JAX reference path
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attend_ref(q, k, v, *, scale, attn_softcap=0.0, window=0,
               q_pos=None, kv_pos=None, kv_valid=None, kv_mask=None):
    """Reference bidirectional attention (the plain path).

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D). H % Hkv == 0 (GQA).
    window > 0 masks |q_pos - kv_pos| > window (bidirectional local).
    kv_valid: (B,) used length; kv_mask: (B, Skv) explicit validity.
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    if kv_valid is not None and kv_mask is None:
        idx = torch.arange(Skv, device=dev)[None, :]
        kv_mask = idx < torch.as_tensor(kv_valid, device=dev).reshape(-1, 1)
    if q_pos is None:
        q_pos = torch.arange(Sq, device=dev)[None].expand(B, Sq)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=dev)[None].expand(B, Skv)
    kw = dict(scale=scale, attn_softcap=attn_softcap, window=window)
    chunk = max(128, SCORE_BUDGET // max(Skv, 1))
    if Sq <= chunk:
        return _attend_chunk(q, k, v, q_pos, kv_pos, kv_mask, **kw)
    return torch.cat([
        _attend_chunk(q[:, s:s + chunk], k, v, q_pos[:, s:s + chunk],
                      kv_pos, kv_mask, **kw)
        for s in range(0, Sq, chunk)], dim=1)


def apply_attention(cfg, p, x, *, q_pos, kv_pos=None, kv_cache=None,
                    kv_valid=None, window=0, return_kv=False,
                    self_kv_override=None, rope=None, kv_mask=None,
                    use_kernels=False):
    """GQA attention over [kv_cache || self].

    x: (B, Sq, d). kv_cache: optional (k, v) each (B, P, Hkv, D) with
    positions implicit in kv_pos (length P + Sq when cache present, else
    Sq). kv_valid applies to the cache region only, either a (B,) used
    length or a (B, P) bool mask; the self region is always valid.
    ``self_kv_override = (mix (B, Sq) bool, gk, gv)``: frozen K/V (dKV
    cache) replace the fresh ones where ``mix`` holds, after RoPE and
    before the cache concatenation.
    Per-pass inputs a caller may build once for every layer: ``rope``, the
    ``rope_table`` of ``q_pos`` (which is also the self keys' position),
    and ``kv_mask``, the ``attention_kv_mask`` of ``kv_valid`` (or, on the
    kernel route with no cache validity, all ones).
    ``use_kernels`` routes the attend to ``kernels.ops.block_attention``
    (the CUDA kernel on the card, its plain version on the CPU) instead
    of ``attend_ref``.
    """
    B, Sq_self, d = x.shape
    H, hd = p["wq"].shape[1], p["wq"].shape[2]
    Hkv = p["wk"].shape[1]
    q = linear(x, p["wq"].reshape(d, H * hd)).reshape(B, Sq_self, H, hd)
    k = linear(x, p["wk"].reshape(d, Hkv * hd)).reshape(B, Sq_self, Hkv, hd)
    v = linear(x, p["wv"].reshape(d, Hkv * hd)).reshape(B, Sq_self, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kv_pos is None:
        kv_pos = q_pos
    if rope is None:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos[:, -Sq_self:], cfg.rope_theta)
    else:
        q = rope_rotate(q, rope)
        k = rope_rotate(k, rope)
    if self_kv_override is not None:
        mix, gk, gv = self_kv_override
        m = mix[:, :, None, None]
        k = torch.where(m, gk.to(k.dtype), k)
        v = torch.where(m, gv.to(v.dtype), v)
    new_kv = (k, v)
    if kv_cache is not None:
        ck, cv = kv_cache
        k = torch.cat([ck.to(k.dtype), k], dim=1)
        v = torch.cat([cv.to(v.dtype), v], dim=1)
        if kv_mask is None and kv_valid is not None:
            kv_mask = attention_kv_mask(kv_valid, ck.shape[1], Sq_self)
    scale = cfg.attn_scale or (1.0 / math.sqrt(cfg.head_dim))
    if use_kernels:
        from repro_torch.kernels import ops as kops
        km = kv_mask if kv_mask is not None else torch.ones(
            (B, k.shape[1]), dtype=torch.bool, device=x.device)
        out = kops.block_attention(
            q, k, v, q_pos, kv_pos, km, scale=scale,
            softcap=cfg.attn_softcap, window=window, out_dtype=q.dtype)
    else:
        out = attend_ref(q, k, v, scale=scale, attn_softcap=cfg.attn_softcap,
                         window=window, q_pos=q_pos, kv_pos=kv_pos,
                         kv_mask=kv_mask)
    out = linear(out.reshape(B, Sq_self, H * hd), p["wo"].reshape(H * hd, d))
    return (out, new_kv) if return_kv else out


# ---------------------------------------------------------------- ffn

def apply_ffn(p, x, kind: str):
    if kind == "swiglu":
        h = F.silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, p["w_up"]), approximate="tanh")
    return linear(h, p["w_down"])
